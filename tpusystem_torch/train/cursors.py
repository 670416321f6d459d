"""Per-row KV-cache cursor authority: the port of
:mod:`tpusystem.train.cursors`.

A decode cache is a dict keyed by the reference's cache paths
(``h_{i}/attn/index`` or Llama's ``layer_{i}/attn/index`` per layer, a
scanned stack's ``hs/attn/index`` or ``blocks/attn/index`` with a leading
layer dimension, and GPT-2's model-level ``position``). Cursor
leaves are never written in place: an edit installs a new tensor, shared by
every cursor leaf, so the per-layer cursors cannot drift apart.
"""

from __future__ import annotations

import torch

CURSOR_KEYS = ('index', 'position')


def _leaf(path: str) -> str:
    return path.rsplit('/', 1)[-1]


def is_cursor(path: str) -> bool:
    """True when a cache path addresses a cursor leaf."""
    return _leaf(path) in CURSOR_KEYS


def rewind(cache: dict, cursor) -> dict:
    """A cache whose every cursor leaf is ``cursor`` (``[batch]`` ints, or a
    scalar broadcast over rows); other leaves are shared with ``cache``."""
    out, shared = dict(cache), {}
    for path, leaf in cache.items():
        if not is_cursor(path):
            continue
        key = (leaf.device, leaf.dtype, tuple(leaf.shape))
        if key not in shared:
            value = torch.as_tensor(cursor, device=leaf.device).to(leaf.dtype)
            if tuple(value.shape) != tuple(leaf.shape):
                value = value.expand(leaf.shape).contiguous()
            shared[key] = value
        out[path] = shared[key]
    return out


def read_cursor(cache: dict) -> torch.Tensor:
    """The per-row ``[batch]`` cursor of a decode cache (the first ``index``
    leaf; every layer's agrees under :func:`rewind`; a scanned stack's
    ``[layers, batch]`` leaf gives layer 0's slice)."""
    for path, leaf in cache.items():
        if _leaf(path) == 'index':
            return leaf.reshape(-1, leaf.shape[-1])[0] if leaf.dim() > 1 \
                else leaf
    raise ValueError('no index cursor leaf in this cache — was it created by '
                     "a decode-mode forward or the model's init_cache?")


def gather_rows(cache: dict, rows) -> dict:
    """Every row's cache replaced by row ``rows[i]``'s: KV leaves gather on
    their batch axis (``ndim - 4`` of the contiguous ``[batch, max_seq,
    heads, head_dim]`` layout), cursor leaves on their last axis. Contiguous
    caches only: a paged pool has no batch axis."""
    out = {}
    for path, leaf in cache.items():
        index = torch.as_tensor(rows, device=leaf.device).long()
        axis = leaf.dim() - 1 if is_cursor(path) else leaf.dim() - 4
        out[path] = torch.index_select(leaf, axis, index)
    return out
