"""Weights drawn from the run's seed, on the device, by the benchmark.

Each leaf is drawn in chunks of :data:`CHUNK_ROWS` leading rows, every
chunk from a generator of its own seeded by ``(seed, leaf name, chunk)``.
So a leaf is a few large calls, and any chunk can be drawn again on its own:
the correctness check redraws the starting weights after the window, chunk
by chunk, without holding a second copy of a recommender's tables.

A leaf's recipe is ``(name, shape, kind, scale)``: ``kind`` is ``normal``
(standard deviation ``scale``), ``uniform`` (on ``[-scale, scale)``) or
``constant`` (every element ``scale``).
"""

from __future__ import annotations

import hashlib

import torch

CHUNK_ROWS = 1 << 20


def chunk_seed(seed: int, name: str, chunk: int) -> int:
    digest = hashlib.blake2b(f'{seed}/{name}/{chunk}'.encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, 'little') & ((1 << 63) - 1)


def chunks(tensor: torch.Tensor):
    """``(index, view)`` over the leading-row chunks of ``tensor``."""
    rows = tensor.view(tensor.shape[0] if tensor.dim() else 1, -1)
    for index, start in enumerate(range(0, rows.shape[0], CHUNK_ROWS)):
        yield index, rows[start:start + CHUNK_ROWS]


def draw_chunk(out: torch.Tensor, seed: int, name: str, index: int,
               kind: str, scale: float) -> torch.Tensor:
    if kind == 'constant':
        return out.fill_(scale)
    generator = torch.Generator(out.device).manual_seed(
        chunk_seed(seed, name, index))
    if kind == 'normal':
        return out.normal_(0.0, scale, generator=generator)
    if kind == 'uniform':
        return out.uniform_(-scale, scale, generator=generator)
    raise ValueError(f'unknown weight kind {kind!r}')


@torch.no_grad()
def draw_into(out: torch.Tensor, seed: int, recipe: tuple) -> None:
    """Fill ``out`` (float32, of the recipe's shape) from the seed."""
    name, shape, kind, scale = recipe
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f'{name}: tensor {tuple(out.shape)}, recipe {shape}')
    for index, view in chunks(out):
        draw_chunk(view, seed, name, index, kind, scale)


def draw(seed: int, recipe: tuple, device) -> torch.Tensor:
    out = torch.empty(recipe[1], dtype=torch.float32, device=device)
    draw_into(out, seed, recipe)
    return out


@torch.no_grad()
def distance_norm(tensor: torch.Tensor, seed: int, recipe: tuple) -> float:
    """``|tensor - drawn|``: the norm of the leaf's distance from its
    starting weights, the start redrawn one chunk at a time."""
    name, _, kind, scale = recipe
    total = torch.zeros((), dtype=torch.float64, device=tensor.device)
    for index, view in chunks(tensor):
        start = draw_chunk(torch.empty_like(view, dtype=torch.float32), seed,
                           name, index, kind, scale)
        total += (view.float() - start).double().square().sum()
    return float(total.sqrt())
