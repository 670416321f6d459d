"""Ring attention: sequence (context) parallelism over the ``seq`` mesh
axis, the port of :mod:`tpusystem.ops.ring`.

Each rank of a ``seq`` group holds its chunk of every row's positions,
``[batch, length / seq, heads, head_dim]``; queries stay put while the
key/value chunks travel the ring (ring shifts over the group's process
group, :func:`~tpusystem_torch.parallel.collectives.ring_shift`), and each
arriving chunk is attended with the flash kernels: K1 forward, and the
fused backward (K2a for multi-head attention past 1,024 keys, K2b
otherwise), which takes the lse cotangent the merge produces. The chunks'
partial results merge by their float32 logsumexp, so a rank's memory is
O(length / seq) and the work spreads over the ring.

* :func:`zigzag_ring_attention` is the causal ring: each rank holds the
  stripe pair ``(i, 2n-1-i)`` of ``2n`` stripes, so every rank computes the
  same visible work at every step (2 stripe blocks a step, ``2n + 1`` in
  all, against the contiguous ring's ``4n``).
* :func:`ring_attention` is the contiguous ring, for non-causal attention
  and lengths the zigzag split cannot stripe.
* :func:`ulysses_attention` swaps sequence and heads with an all-to-all,
  attends the whole sequence for ``heads / seq`` heads, and swaps back.

Every function runs on the chunks a rank holds and is differentiable
through autograd: each shift's backward is the reverse shift. Every rank
builds the same graph (masked blocks are selected with ``torch.where``, as
the reference does), so every rank runs every shift's backward, in the
same order. :func:`ring_self_attention` picks the variant; causal
``'ring'`` takes the zigzag form whenever the length stripes.
"""

from __future__ import annotations

import functools

import torch

from tpusystem_torch.ops.attention import (NEG_INF, causal_mask,
                                          repeat_kv_heads)
from tpusystem_torch.parallel.collectives import (all_to_all, ppermute,
                                                  ring_shift)
from tpusystem_torch.parallel.mesh import SEQ

__all__ = ['ring_attention', 'zigzag_ring_attention', 'ulysses_attention',
           'ring_self_attention']


def _einsum_attention_lse(query, key, value, *, causal: bool, scale: float):
    """Plain ``(out, lse)``: float32 scores, lse ``[B, S, H]`` float32, the
    weights rounded to ``value``'s dtype before the product."""
    work = torch.promote_types(query.dtype, torch.float32)
    scores = torch.einsum('bqhd,bkhd->bhqk', query.to(work),
                          key.to(work)) * scale
    if causal:
        scores = scores.masked_fill(
            ~causal_mask(query.shape[1], key.shape[1], device=query.device),
            NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)                     # [B, H, Q]
    weights = torch.exp(scores - lse[..., None])
    out = torch.einsum('bhqk,bkhd->bqhd', weights.to(value.dtype).to(work),
                       value.to(work))
    return out.to(value.dtype), lse.transpose(1, 2)


def _attention_lse(query, key, value, *, causal: bool, scale: float,
                   inner: str):
    """One chunk's ``(out, lse)`` through the chosen inner kernel:
    ``'flash'`` (the flash kernels, which share grouped KV across each
    query-head group themselves and take the default scale) or
    ``'einsum'`` (plain attention over KV broadcast to the query heads).
    lse is ``[B, S, H]`` float32 either way."""
    if inner == 'flash':
        if scale != query.shape[-1] ** -0.5:
            raise ValueError('the flash kernels take the scale '
                             'head_dim ** -0.5 only')
        from tpusystem_torch.ops.cuda.flash import flash_attention_lse
        return flash_attention_lse(query, key, value, causal=causal)
    if inner == 'einsum':
        key, value = repeat_kv_heads(query, key, value)
        return _einsum_attention_lse(query, key, value, causal=causal,
                                     scale=scale)
    raise ValueError(f"unknown inner kernel {inner!r}; "
                     "expected 'flash' or 'einsum'")


def _merge_lse(out, lse, new_out, new_lse):
    """Fold a new ``(out, lse)`` partial into the float32 accumulator pair:
    both weighted by ``exp(lse - logaddexp(lse, new_lse))``. A partial
    masked with the finite ``NEG_INF`` contributes exactly zero (with
    ``-inf`` two masked partials would give ``exp(-inf + inf)``, NaN)."""
    merged = torch.logaddexp(lse, new_lse)
    weight_old = torch.exp(lse - merged)[..., None]
    weight_new = torch.exp(new_lse - merged)[..., None]
    return out * weight_old + new_out.float() * weight_new, merged


def _ring_permute(mesh, axis: str):
    """The ring shift over ``axis``: rank ``i`` sends to ``i + 1``."""
    def permute(tensor):
        return ring_shift(tensor, mesh, axis)
    return permute


def ring_attention(query, key, value, mesh, *, axis: str = SEQ,
                   causal: bool = True, scale: float | None = None,
                   inner: str = 'flash'):
    """Blockwise ring attention, contiguous layout, on this rank's chunks.

    Key/value chunks rotate round the ring; each arriving chunk is attended
    and the ``(out, lse)`` partials merge by logsumexp. Step 0 attends the
    rank's own chunk causally; every later chunk is strictly past (all
    visible) or strictly future (its merge weight masked to zero with
    ``torch.where``, computed all the same). The chunk of step ``s + 1`` is
    shifted before step ``s``'s attention.

    Args:
        query/key/value: this rank's chunks ``[batch, chunk, heads,
            head_dim]`` of a sequence split over ``axis``.
        inner: ``'flash'`` (the flash kernels) or ``'einsum'``.
    Returns:
        this rank's output chunk ``[batch, chunk, heads, head_dim]``.
    """
    ring = mesh.axis_size(axis)
    rank = mesh.axis_index(axis) if ring > 1 else 0
    scale = scale if scale is not None else query.shape[-1] ** -0.5
    permute = _ring_permute(mesh, axis)
    out, lse = _attention_lse(query, key, value, causal=causal, scale=scale,
                              inner=inner)
    out = out.float()
    if ring > 1:
        key_next, value_next = permute(key), permute(value)
    for step in range(1, ring):
        key, value = key_next, value_next
        if step + 1 < ring:
            key_next, value_next = permute(key), permute(value)
        # the chunk of rank (rank - step) % ring: strictly past iff
        # rank >= step, strictly future otherwise (causal only)
        chunk_out, chunk_lse = _attention_lse(query, key, value, causal=False,
                                              scale=scale, inner=inner)
        if causal:
            visible = torch.tensor(rank >= step, device=query.device)
            chunk_lse = torch.where(visible, chunk_lse,
                                    torch.full_like(chunk_lse, NEG_INF))
            chunk_out = torch.where(visible, chunk_out,
                                    torch.zeros_like(chunk_out))
        out, lse = _merge_lse(out, lse, chunk_out, chunk_lse)
    return out.to(query.dtype)


def _even_home(stripe: int, ring: int) -> int:
    """Zigzag owner of global stripe ``stripe`` (of ``2 * ring``)."""
    return stripe if stripe < ring else 2 * ring - 1 - stripe


def _to_zigzag(tensor, mesh, axis: str, ring: int):
    """Contiguous local chunk -> the ``(low, high)`` zigzag stripe pair.

    Rank ``i`` holds global stripes ``(2i, 2i+1)`` as the halves of its
    chunk and wants ``(i, 2n-1-i)``: two half-chunk permutations, one
    routing every even stripe home, one the odd ones (each rank holds one
    even and one odd stripe in both layouts); the receiver sorts its two
    arrivals by its rank's parity."""
    rank = mesh.axis_index(axis)
    half = tensor.shape[1] // 2
    first, second = tensor[:, :half], tensor[:, half:]   # stripes 2i, 2i+1
    recv_even = ppermute(first, mesh, axis,
                          [_even_home(2 * i, ring) for i in range(ring)])
    recv_odd = ppermute(second, mesh, axis,
                         [_even_home(2 * i + 1, ring) for i in range(ring)])
    if rank % 2 == 0:
        return recv_even, recv_odd     # (stripe rank, stripe 2n-1-rank)
    return recv_odd, recv_even


def _from_zigzag(low, high, mesh, axis: str, ring: int):
    """Inverse of :func:`_to_zigzag`: the stripe pair back to the
    contiguous chunk."""
    rank = mesh.axis_index(axis)
    even_rank = rank % 2 == 0
    # rank a holds stripes (a, 2n-1-a); its even stripe is a when a is
    # even (the low slot), else 2n-1-a (the high slot)
    payload_even, payload_odd = (low, high) if even_rank else (high, low)
    even_stripe = lambda a: a if a % 2 == 0 else 2 * ring - 1 - a
    odd_stripe = lambda a: a if a % 2 == 1 else 2 * ring - 1 - a
    first = ppermute(payload_even, mesh, axis,
                      [even_stripe(a) // 2 for a in range(ring)])
    second = ppermute(payload_odd, mesh, axis,
                       [odd_stripe(a) // 2 for a in range(ring)])
    return torch.cat([first, second], dim=1)


def zigzag_ring_attention(query, key, value, mesh, *, axis: str = SEQ,
                          scale: float | None = None, inner: str = 'flash'):
    """Causal ring attention with balanced zigzag stripes, on this rank's
    chunks.

    The global sequence is ``2n`` stripes and rank ``i`` holds the pair
    ``(i, 2n-1-i)``, so every rank's visible work is the same at every
    step:

    * step 0 (own pair): ``q_low @ kv_low`` causal, ``q_high @ kv_low``
      full, ``q_high @ kv_high`` causal;
    * step ``s``, the pair of rank ``j = (rank - s) mod n``: ``q_high @
      kv_low`` is always visible, and the second visible block is ``q_low @
      kv_low`` when ``j < rank``, ``q_high @ kv_high`` when ``j > rank``:
      the same shapes, computed once on ``torch.where``-selected inputs.

    Every step runs 2 stripe-sized flash blocks (``2n + 1`` in all, against
    the contiguous ring's ``4n``). The pair of step ``s + 1`` is shifted
    before step ``s``'s blocks. Inputs and output are in the contiguous
    layout (chunk ``i`` is stripes ``2i, 2i+1``); the exchange in and out
    of stripes is two half-chunk permutations each way. Needs an even
    local chunk. A ring of one rank is the flash call itself.
    """
    ring = mesh.axis_size(axis)
    scale = scale if scale is not None else query.shape[-1] ** -0.5
    if ring == 1:
        out, _ = _attention_lse(query, key, value, causal=True, scale=scale,
                                inner=inner)
        return out
    if query.shape[1] % 2:
        raise ValueError(f'zigzag ring needs an even local chunk, got '
                         f'{query.shape[1]}')
    rank = mesh.axis_index(axis)
    permute = _ring_permute(mesh, axis)
    attend = functools.partial(_attention_lse, scale=scale, inner=inner)

    q_low, q_high = _to_zigzag(query, mesh, axis, ring)
    k_low, k_high = _to_zigzag(key, mesh, axis, ring)
    v_low, v_high = _to_zigzag(value, mesh, axis, ring)
    kv = (k_low, k_high, v_low, v_high)
    # step 1's pair is shifted before the three step-0 blocks
    kv_next = tuple(map(permute, kv))

    # step 0: the diagonal of the rank's own stripe pair
    out_low, lse_low = attend(q_low, k_low, v_low, causal=True)
    out_low = out_low.float()
    out_high, lse_high = attend(q_high, k_low, v_low, causal=False)
    out_high = out_high.float()
    part_out, part_lse = attend(q_high, k_high, v_high, causal=True)
    out_high, lse_high = _merge_lse(out_high, lse_high, part_out, part_lse)

    for step in range(1, ring):
        kv = kv_next
        if step + 1 < ring:
            kv_next = tuple(map(permute, kv))
        arriving_k_low, arriving_k_high, arriving_v_low, arriving_v_high = kv
        source = (rank - step) % ring   # the rank whose pair just arrived
        # block 1: q_high x kv_low, visible from every source
        part_out, part_lse = attend(q_high, arriving_k_low, arriving_v_low,
                                    causal=False)
        out_high, lse_high = _merge_lse(out_high, lse_high, part_out,
                                        part_lse)
        # block 2: q_low x kv_low from the past, q_high x kv_high from the
        # future, computed once on selected inputs
        past = torch.tensor(source < rank, device=query.device)
        part_out, part_lse = attend(
            torch.where(past, q_low, q_high),
            torch.where(past, arriving_k_low, arriving_k_high),
            torch.where(past, arriving_v_low, arriving_v_high), causal=False)
        masked = torch.full_like(part_lse, NEG_INF)
        nothing = torch.zeros_like(part_out)
        out_low, lse_low = _merge_lse(
            out_low, lse_low, torch.where(past, part_out, nothing),
            torch.where(past, part_lse, masked))
        out_high, lse_high = _merge_lse(
            out_high, lse_high, torch.where(past, nothing, part_out),
            torch.where(past, masked, part_lse))

    return _from_zigzag(out_low.to(query.dtype), out_high.to(query.dtype),
                        mesh, axis, ring)


def ulysses_attention(query, key, value, mesh, *, axis: str = SEQ,
                      causal: bool = True, scale: float | None = None):
    """All-to-all sequence parallelism on this rank's chunks: ``[B, S/n, H,
    D]`` shard-transposed to ``[B, S, H/n, D]`` (the whole sequence, a
    subset of the heads), attended with the flash kernels, and transposed
    back. Needs ``heads % n == 0`` and KV at the query head count."""
    ring = mesh.axis_size(axis)
    heads = query.shape[2]
    if heads % ring:
        raise ValueError(f'ulysses needs heads ({heads}) divisible by the '
                         f'seq axis ({ring})')
    if scale is not None and scale != query.shape[-1] ** -0.5:
        raise ValueError('the flash kernels take the scale head_dim ** -0.5 '
                         'only')

    def swap_in(tensor):    # [B, S/n, H, D] -> [B, S, H/n, D]
        return all_to_all(tensor, mesh, axis, split_dimension=2,
                          concat_dimension=1)

    def swap_out(tensor):   # [B, S, H/n, D] -> [B, S/n, H, D]
        return all_to_all(tensor, mesh, axis, split_dimension=1,
                          concat_dimension=2)

    from tpusystem_torch.ops.cuda.flash import flash_attention
    out = flash_attention(swap_in(query), swap_in(key), swap_in(value),
                          causal=causal)
    return swap_out(out)


def ring_self_attention(query, key, value, mesh, *, causal: bool = True,
                        variant: str = 'ring', inner: str = 'flash'):
    """The chosen variant on this rank's chunks ``[rows, length / seq,
    heads, head_dim]`` (its rows of the batch split over ``(data, fsdp)``,
    its positions split over ``seq``). ``inner`` picks the ring's per-chunk
    kernel (``'flash'`` | ``'einsum'``).

    ``variant='ring'`` takes the balanced zigzag form for causal attention
    whenever the sequence splits into ``2 * seq`` stripes, the contiguous
    ring otherwise; ``'zigzag'`` forces it (raising where the shape cannot
    stripe); ``'ulysses'`` is the all-to-all variant, for which grouped KV
    is broadcast to the query head count first (the ring variants keep it
    grouped: fewer bytes a shift).
    """
    seq_size = mesh.shape[SEQ]
    length = query.shape[1] * seq_size
    stripeable = causal and seq_size > 0 and length % (2 * seq_size) == 0
    if variant == 'zigzag':
        if not causal:
            raise ValueError('zigzag ring attention is causal-only; use '
                             "variant='ring' for non-causal")
        if not stripeable:
            raise ValueError(
                f'zigzag needs seq length {length} divisible by 2 * seq '
                f'axis ({2 * seq_size})')
    if variant == 'ring' and stripeable:
        variant = 'zigzag'
    if variant == 'zigzag':
        return zigzag_ring_attention(query, key, value, mesh, inner=inner)
    if variant == 'ring':
        return ring_attention(query, key, value, mesh, causal=causal,
                              inner=inner)
    if variant == 'ulysses':
        key, value = repeat_kv_heads(query, key, value)
        return ulysses_attention(query, key, value, mesh, causal=causal)
    raise ValueError(f'unknown variant {variant!r}; '
                     "expected 'ring', 'zigzag' or 'ulysses'")
