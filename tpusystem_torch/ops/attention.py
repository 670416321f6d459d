"""Attention ops: einsum attention, the decode caches, the flash route.

Port of :mod:`tpusystem.ops.attention`. Softmax runs in float32 whatever the
activation dtype; products of bf16 operands are taken in float32 and the
result rounded once. Decode caches are explicit dicts of tensors keyed by
the reference's cache paths (``h_{i}/attn/key``, ``.../value``,
``.../index``, ``.../table`` and the model-level ``position``). The functions
here write a call's keys and values into the cache tensors **in place** (the
pool is the largest tensor of a serving process; a functional copy per token
would double it) and replace the ``index`` cursor with a new tensor.

The read window of a decode step (the bucket) is a host decision: the caller
passes ``depth``, the deepest row's cursor before the call, which it already
knows, so no step waits on the device to pick its window.
"""

from __future__ import annotations

import torch

from tpusystem_torch.ops.cuda.threefry import bernoulli_mask
from tpusystem_torch.ops.threefry import flash_seed

NEG_INF = -1e30
FLASH_MIN_LENGTH = 512      # prefill lengths routed to the flash kernel


def causal_mask(query_length: int, key_length: int, *, device=None):
    """Boolean ``[q, k]`` mask, True = attend."""
    queries = torch.arange(query_length, device=device)[:, None]
    keys = torch.arange(key_length, device=device)[None, :]
    return queries >= keys


def repeat_kv_heads(query, key, value):
    """Broadcast grouped KV heads up to the query head count (GQA)."""
    query_heads, kv_heads = query.shape[2], key.shape[2]
    if kv_heads == query_heads:
        return key, value
    if query_heads % kv_heads:
        raise ValueError(f'query heads ({query_heads}) must be a multiple of '
                         f'KV heads ({kv_heads}) for grouped-query attention')
    group = query_heads // kv_heads
    return (key.repeat_interleave(group, dim=2),
            value.repeat_interleave(group, dim=2))


def dropout_mask(shape, rate: float, key, device):
    """``jax.random.bernoulli(key, 1 - rate, shape)``, bit for bit: the keep
    mask flax's ``nn.Dropout`` draws from the threefry ``key``. A function of
    the key alone, so a recomputed forward (``GPT2(remat=True)``) draws the
    same mask again. On the card it is one kernel
    (:func:`tpusystem_torch.ops.cuda.threefry.bernoulli_mask`)."""
    return bernoulli_mask(key, 1.0 - rate, shape, device)


def apply_dropout(x, rate: float, key):
    """``flax.linen.Dropout`` in training: elements kept where
    :func:`dropout_mask` of ``key`` is True and divided by ``1 - rate`` in
    ``x``'s dtype, the rest zeroed; ``rate == 1`` zeroes everything.
    ``rate == 0`` returns ``x``."""
    if not rate:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = dropout_mask(x.shape, rate, key, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dot_product_attention(query, key, value, *, causal: bool = True,
                          mask=None, dropout: float = 0.0, rng=None):
    """Multi-head attention over ``[batch, length, heads, head_dim]``.

    Scores and softmax in float32 (float64 for float64 inputs); the weights
    are rounded to the input dtype before the product with ``value``; the
    output returns in the input dtype. ``mask`` broadcasts against
    ``[batch, heads, q, k]``. ``dropout > 0`` drops normalised weights and
    scales the survivors by ``1 / (1 - dropout)`` (the reference's
    ``attention.py:373-375``), the mask ``bernoulli(rng, 1 - dropout)``
    over ``[batch, heads, q, k]``, ``rng`` a threefry key. Differentiable
    through autograd."""
    dtype = query.dtype
    work = torch.promote_types(dtype, torch.float32)
    scale = query.shape[-1] ** -0.5
    key, value = repeat_kv_heads(query, key, value)
    scores = torch.einsum('bqhd,bkhd->bhqk', query.to(work), key.to(work))
    scores = scores * scale
    if causal:
        scores = scores.masked_fill(
            ~causal_mask(query.shape[1], key.shape[1], device=query.device),
            NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    weights = apply_dropout(weights, dropout, rng)
    out = torch.einsum('bhqk,bkhd->bqhd', weights.to(dtype).to(work),
                       value.to(work))
    return out.to(dtype)


def attend(query, key, value, *, kernel: str = 'xla', dropout: float = 0.0,
           rng=None):
    """Causal attention of the forward and training passes: ``'xla'`` is
    :func:`dot_product_attention` (autograd), ``'flash'`` the flash kernels
    (K1 forward, the fused backward K2a or K2b). ``dropout > 0`` drops
    attention probabilities with masks from the threefry key ``rng`` (the
    reference's ``dropout_rng``): ``bernoulli`` on it over the weights on
    ``'xla'``; on ``'flash'`` the kernels' positional hash of the seed
    ``randint(rng, (1,), 0, 2**31 - 1)`` (``flash.py:773``)."""
    if kernel == 'xla':
        return dot_product_attention(query, key, value, causal=True,
                                     dropout=dropout, rng=rng)
    if kernel == 'flash':
        from tpusystem_torch.ops.cuda.flash import flash_attention
        seed = flash_seed(rng) if dropout else None
        return flash_attention(query, key, value, causal=True,
                               dropout=dropout, seed=seed)
    raise ValueError(f"unknown attention kernel {kernel!r}; expected 'xla' "
                     "or 'flash'")


def _buckets(first: int, last: int) -> list[int]:
    buckets = [first]
    while buckets[-1] < last:
        buckets.append(min(2 * buckets[-1], last))
    return buckets


def _bucket(buckets: list[int], filled: int) -> int:
    """The smallest bucket covering ``filled`` (the last one at most)."""
    for width in buckets[:-1]:
        if filled <= width:
            return width
    return buckets[-1]


def contiguous_window(max_seq: int, filled: int) -> int:
    """Read width of a contiguous decode cache: the smallest power-of-2
    window from 256 tokens that covers ``filled`` positions, capped at
    ``max_seq`` (the whole cache when ``max_seq <= 256``)."""
    buckets = _buckets(256, max_seq)
    if len(buckets) == 1:
        return max_seq
    return _bucket(buckets, filled)


def paged_window(max_seq: int, block: int, filled_blocks: int) -> int:
    """Read width, in blocks, of a paged decode cache: power-of-2 block
    windows from ``64 // block`` blocks, capped at the table width."""
    max_blocks = max_seq // block
    buckets = _buckets(min(max_blocks, max(1, 64 // block)), max_blocks)
    if len(buckets) == 1:
        return max_blocks
    return _bucket(buckets, filled_blocks)


def paged_attention(query, key, value, cache, prefix: str, max_seq: int,
                    pages: tuple[int, int], depth: int):
    """Incremental attention over the serving engine's **paged** KV pool.

    ``cache[prefix + '/key'|'/value']`` are pools ``[num_blocks * block,
    kv_heads, head_dim]``, ``cache[prefix + '/table']`` maps each row's
    logical blocks to physical ones (``[batch, max_seq // block]``, block 0
    is the trash block) and ``cache[prefix + '/index']`` is the per-row
    cursor. The call's keys and values are written through the table (past
    capacity they clamp onto the last, unmapped column: trash), the cursor
    advances, and the queries attend over the smallest power-of-2 block
    window covering the deepest row, masked at each row's own depth."""
    num_blocks, block = pages
    if max_seq % block:
        raise ValueError(f'max_seq ({max_seq}) must be a multiple of the '
                         f'page block_size ({block})')
    if prefix + '/table' not in cache:
        raise ValueError("a paged cache is created by the model's init_cache "
                         "(the serving engine's pool), not by a forward call")
    batch, length, kv_heads, head_dim = key.shape
    max_blocks = max_seq // block
    pool_key, pool_value = cache[prefix + '/key'], cache[prefix + '/value']
    table = cache[prefix + '/table']
    cursor = cache[prefix + '/index']
    steps = torch.arange(length, device=query.device)
    positions = cursor[:, None] + steps[None, :]                  # [B, L]
    logical = torch.clamp(positions // block, max=max_blocks - 1)
    physical = torch.gather(table, 1, logical.to(table.dtype).long())
    slots = (physical * block + positions % block).reshape(-1).long()
    pool_key[slots] = key.reshape(-1, kv_heads, head_dim).to(pool_key.dtype)
    pool_value[slots] = value.reshape(-1, kv_heads, head_dim).to(
        pool_value.dtype)
    cache[prefix + '/index'] = cursor + length

    deepest = depth + length - 1
    width = paged_window(max_seq, block, (deepest + block) // block)
    tokens = (table[:, :width, None].long() * block
              + torch.arange(block, device=query.device)[None, None, :]
              ).reshape(batch, width * block)
    keys, values = pool_key[tokens], pool_value[tokens]
    mask = (torch.arange(width * block, device=query.device)[None, None, :]
            <= positions[:, :, None])                             # [B, L, W]
    return dot_product_attention(query, keys, values, causal=False,
                                 mask=mask[:, None])


def cached_attention(query, key, value, cache, prefix: str, max_seq: int, *,
                     per_row: bool = False, pages: tuple | None = None,
                     depth: int = 0):
    """Incremental (KV-cache) attention for autoregressive decoding.

    The first call for a layer (no ``prefix + '/index'`` leaf in ``cache``
    yet) is the prefill: it creates the layer's contiguous ``[batch,
    max_seq, kv_heads, head_dim]`` caches, writes the prompt's keys and
    values, and attends causally over the prompt alone; prompts of
    :data:`FLASH_MIN_LENGTH` tokens or more go through the flash kernel.
    Later calls write at each row's cursor (one slice at ``depth`` when
    ``per_row`` is False and the cursors are uniform, a per-row scatter
    otherwise) and read the smallest power-of-2 window from 256 tokens that
    covers the deepest row, masked at each row's own depth.

    ``pages=(num_blocks, block_size)`` switches to :func:`paged_attention`.
    ``depth`` is the deepest row's cursor before the call."""
    if pages is not None:
        return paged_attention(query, key, value, cache, prefix, max_seq,
                               pages, depth)
    batch, length, kv_heads, head_dim = key.shape
    if length > max_seq:
        raise ValueError(
            f'prompt length {length} exceeds the KV cache capacity '
            f'max_seq={max_seq}; raise max_seq or truncate the prompt')
    prefill = prefix + '/index' not in cache
    if prefill:
        shape = (batch, max_seq, kv_heads, head_dim)
        cache[prefix + '/key'] = key.new_zeros(shape)
        cache[prefix + '/value'] = value.new_zeros(shape)
        cache[prefix + '/index'] = torch.zeros(batch, dtype=torch.int32,
                                               device=key.device)
    cache_key, cache_value = cache[prefix + '/key'], cache[prefix + '/value']
    cursor = cache[prefix + '/index']
    steps = torch.arange(length, device=query.device)
    positions = cursor[:, None] + steps[None, :]                  # [B, L]
    if per_row:
        rows = torch.arange(batch, device=query.device)[:, None]
        cache_key[rows, positions.long()] = key.to(cache_key.dtype)
        cache_value[rows, positions.long()] = value.to(cache_value.dtype)
    else:
        # uniform cursors (the caller's contract): one slice write at depth
        cache_key[:, depth:depth + length] = key.to(cache_key.dtype)
        cache_value[:, depth:depth + length] = value.to(cache_value.dtype)
    cache[prefix + '/index'] = cursor + length
    if prefill:
        if length >= FLASH_MIN_LENGTH:
            from tpusystem_torch.ops.cuda.flash import flash_attention
            return flash_attention(query, key, value, causal=True)
        return dot_product_attention(query, key, value, causal=True)
    width = contiguous_window(max_seq, depth + length)
    mask = (torch.arange(width, device=query.device)[None, None, :]
            <= positions[:, :, None])                             # [B, L, W]
    return dot_product_attention(query, cache_key[:, :width],
                                 cache_value[:, :width], causal=False,
                                 mask=mask[:, None])
