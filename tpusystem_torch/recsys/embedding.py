"""Embedding tables: the port of :mod:`tpusystem.recsys.embedding`, one device.

A recommender's parameters are dominated by embedding tables, its compute
per example is tiny, and its hot path is row movement: gathers forward,
scatter-adds backward. This module supplies that tier:

* :func:`dedup_ids` — the unique-id pass before the gather. A Zipfian id
  distribution makes duplicates the common case, so the table gather reads
  each distinct row once and the batch-side expansion is a dense gather.
  Bitwise the reference's (a stable argsort, a cumsum and two scatters).
* :func:`lookup` — the weighted lookup with the dedup pass in front. The
  table's row movement is :func:`~tpusystem_torch.ops.cuda.embedding_lookup.
  embedding_lookup` (K8 forward, K9 backward on the card). The batch-side
  expansion is a plain index (the reference's ``jnp.take``, XLA's, not a
  kernel) whose backward folds the duplicate cotangents through K9 as well
  (``inverse`` as the ids into an ``[n, dim]`` buffer): autograd's own
  ``index_add_`` adds with float atomics on the card and would not repeat
  bitwise.
* :class:`ShardedEmbedding` — the table module on one device.
  :func:`route_plan` is copied as it is (pure). A ``mesh`` whose
  ``expert``/``model`` axes hold more than one table shard raises
  ``NotImplementedError`` (ROADMAP queue 1, 9f. Expert and table
  parallelism: the device-side id → shard routing and the ``psum``).
"""

from __future__ import annotations

import torch
from torch import nn

from tpusystem_torch.device import resolve_device
from tpusystem_torch.ops.cuda.embedding_lookup import (embedding_lookup,
                                                       scatter_add_rows)
from tpusystem_torch.registry import register

DATA, FSDP, MODEL, EXPERT = 'data', 'fsdp', 'model', 'expert'
TABLE_AXES = (EXPERT, MODEL)


def dedup_ids(ids, sentinel: int):
    """Static-shape unique-id pass: ``(reps, inverse)`` with
    ``reps[inverse[j]] == ids[j]``, both int32.

    ``reps`` is ``[n]``: the distinct ids packed at the front in ascending
    order, the rest padded with ``sentinel`` (an out-of-range id the lookup
    masks to a zero row, which ``inverse`` never points at). Callers map
    invalid ids to ``sentinel`` *before* deduping, so all padding collapses
    into one rep. The values after expansion are the same with or without
    the pass."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first, 0) - 1               # slot per sorted element
    # slots repeat within a run of equal ids, which all write the same value
    reps = torch.full((n,), sentinel, dtype=torch.int32,
                      device=ids.device).scatter_(0, slot,
                                                  sorted_ids.to(torch.int32))
    inverse = torch.zeros(n, dtype=torch.int32, device=ids.device).scatter_(
        0, order, slot.to(torch.int32))
    return reps, inverse


class _ExpandRows(torch.autograd.Function):
    """``unique_rows[inverse]``; the backward sums each slot's cotangents in
    ascending batch position through K9 (float32, rounded once to the rows'
    dtype)."""

    @staticmethod
    def forward(ctx, unique_rows, inverse):
        ctx.save_for_backward(inverse)
        ctx.slots = unique_rows.shape[0]
        return unique_rows.index_select(0, inverse)

    @staticmethod
    def backward(ctx, d_rows):
        (inverse,) = ctx.saved_tensors
        ones = torch.ones(inverse.shape[0], dtype=torch.float32,
                          device=inverse.device)
        folded = scatter_add_rows(d_rows, inverse, ones, ctx.slots)
        return folded.to(d_rows.dtype), None


def lookup(table, ids, weights=None, *, impl: str = 'auto',
           dedup: bool = True):
    """Weighted lookup ``out[j] = w[j] * table[ids[j]]`` with the unique-id
    pass in front of the gather.

    Ids outside ``[0, rows)`` (``-1`` multi-hot padding) give zero rows and
    no gradient. With ``dedup=True`` the gather touches each distinct id
    once and the table's gradient scatter is collision-free; the output is
    bitwise the same either way."""
    rows = table.shape[0]
    ids = ids.to(torch.int32)
    valid = (ids >= 0) & (ids < rows)
    sent = torch.where(valid, ids, torch.full_like(ids, rows))
    if not dedup:
        return embedding_lookup(table, sent, weights, impl=impl)
    reps, inverse = dedup_ids(sent, rows)
    unique_rows = embedding_lookup(table, reps, None, impl=impl)
    gathered = _ExpandRows.apply(unique_rows, inverse)
    if weights is None:
        return gathered
    scaled = gathered.float() * weights.float()[:, None]
    return scaled.to(table.dtype)


def route_plan(vocab: int, count: int, mesh,
               axes=TABLE_AXES) -> str | None:
    """Pure shardability decision for one lookup: ``None`` when the
    device-side routed path applies, else the blocking reason. ``mesh`` is
    anything with ``axis_names`` and a ``shape`` mapping of axis sizes."""
    if mesh is None:
        return 'no mesh'
    present = tuple(axis for axis in axes if axis in mesh.axis_names)
    shards = 1
    for axis in present:
        shards *= mesh.shape[axis]
    if shards == 1:
        return f'table axes {axes} all have size 1'
    if vocab % shards:
        return f'vocab {vocab} not divisible by {shards} table shards'
    row_shards = 1
    for axis in (DATA, FSDP):
        if axis in mesh.axis_names:
            row_shards *= mesh.shape[axis]
    if count % row_shards:
        return (f'{count} ids not divisible by the {row_shards}-way '
                f'batch sharding')
    return None


def table_shards(mesh) -> int:
    """How many ways ``mesh``'s ``expert``/``model`` axes split a table."""
    if mesh is None:
        return 1
    shards = 1
    for axis in TABLE_AXES:
        if axis in mesh.axis_names:
            shards *= mesh.shape[axis]
    return shards


@register('ShardedEmbedding',
          excluded_kwargs={'mesh', 'parent', 'name', 'device'})
class ShardedEmbedding(nn.Module):
    """Embedding table (the parameter ``embedding``, ``[vocab, features]``
    float32).

    ``forward(ids, weights=None)`` takes any id shape (``[B]`` one-hot,
    ``[B, K]`` multi-hot with ``-1`` padding, ...) and returns ``ids.shape
    + (features,)`` rows; padded ids give zero rows, so a multi-hot pool is
    a plain sum over the hot axis.

    Attributes:
        vocab: table rows.
        features: embedding dimension.
        mesh: must not split the table (more than one shard raises).
        impl: row-movement impl, ``'auto'`` | ``'fused'`` | ``'take'``
            (:func:`~tpusystem_torch.ops.cuda.embedding_lookup.
            embedding_lookup`).
        dedup: unique-id pass before the gather (:func:`dedup_ids`).
        init_scale: standard deviation of the normal table init.
        device: the table's device, the card unless ``'cpu'`` is asked for.
    """

    def __init__(self, vocab: int, features: int, mesh: object = None,
                 impl: str = 'auto', dedup: bool = True,
                 init_scale: float = 0.02, device=None) -> None:
        super().__init__()
        if table_shards(mesh) > 1:
            raise NotImplementedError(
                'a table split over a mesh is not ported to tpusystem_torch '
                'yet (ROADMAP queue 1: 9. Multi-GPU parallelism, 9f. Expert '
                'and table parallelism)')
        self.vocab, self.features, self.mesh = vocab, features, mesh
        self.impl, self.dedup, self.init_scale = impl, dedup, init_scale
        self.embedding = nn.Parameter(torch.empty(
            vocab, features, device=resolve_device(device)))
        self.init_weights(torch.Generator(self.embedding.device).manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw the table from ``generator`` (normal, ``init_scale``)."""
        self.embedding.normal_(0.0, self.init_scale, generator=generator)

    def forward(self, ids, weights=None):
        shape = tuple(ids.shape)
        flat = ids.reshape(-1)
        flat_w = None if weights is None else weights.reshape(-1).float()
        out = lookup(self.embedding, flat, flat_w, impl=self.impl,
                     dedup=self.dedup)
        return out.reshape(shape + (self.features,))
