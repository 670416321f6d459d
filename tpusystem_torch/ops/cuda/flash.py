"""Flash attention, forward and backward: hand-written CUDA kernels for Hopper.

The counterpart of :mod:`tpusystem.ops.pallas.flash`: causal online-softmax
attention over ``[batch, length, heads, head_dim]`` tensors that returns the
output and the float32 logsumexp ``[batch, length, heads]``, with
grouped-query attention mapping query head ``h`` to kv head ``h // group``.
``csrc/flash_fwd.cu`` (K1) and ``csrc/flash_bwd.cu`` (K2a, K2b, K3a, K3b)
hold the design notes. :func:`flash_attention_lse` is differentiable in both
outputs through a ``torch.autograd.Function``: its forward runs K1 and saves
the logsumexp, its backward runs ``backward='fused'`` (one recomputation of
each tile for dq, dk and dv) or ``'split'`` (a dq sweep and a dk/dv sweep).
The fused backward of multi-head attention over more than
``FUSED_MHA_KEYS`` keys is K2a, as the reference routes its resident-dq
kernel (``flash.py:508``); GQA and shorter MHA take K2b. On the card K2a
and K2b are one TMA-fed ``wgmma`` kernel that sums dq in kv order behind a
ticket per (head row, q tile), so they agree bit for bit. The reference
also reroutes K2a to the split sweeps past a 96 MB working set
(``flash.py:508-528``): that is the TPU's scoped-VMEM limit, and the kernel
here keeps its dq sum in device memory, so there is no such reroute.
The split pair is on the same machinery: K3b is the fused kernel's body
without dq (its dk and dv are K2b's bit for bit), K3a a dq sweep shaped as
K1 (a block per 128-row q tile, k and v through a TMA ring, dq in
registers).

Attention-probability dropout (``dropout > 0`` with an int ``seed``) runs
in every kernel through the reference's positional hash (:func:`keep_mask`,
``csrc/flash_dropout.cuh``): the backward kernels regenerate the forward's
masks from the same seed, nothing of size seq**2 is stored.

Every wrapper follows its tensors' device: a CPU tensor takes the plain
PyTorch version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`, the plain version of every backward
kernel), a CUDA tensor launches the kernel or raises.
``flash_attention_lse.launches``, ``flash_bwd_fused_g1.launches``,
``flash_bwd_fused.launches``, ``flash_bwd_dq.launches`` and
``flash_bwd_dkv.launches`` count launches; :func:`fused_clocks` and
:func:`fused_ticket_waits` are uncounted diagnostic launches of the fused
kernel (its cycles, and the share of them spent waiting for dq tickets).
"""

from __future__ import annotations

import ctypes

import torch

from tpusystem_torch.ops.cuda._build import LIBRARIES
from tpusystem_torch.observe.profile import ATTENTION, annotate

NEG_INF = -1e30
TILE = 64          # kv rows per online-softmax step of the plain versions
                   # (the kernels step over 128-row kv tiles)
HEAD_DIMS = (16, 32, 64, 128)     # K1's, K2a's, K2b's, K3a's and K3b's
FUSED_MHA_KEYS = 1024   # past this, the fused MHA backward is K2a
BACKWARDS = ('fused', 'split')
LOG2E = 1.4426950408889634      # the fused backward's exp2 takes lse * log2(e)
_U32 = 0xFFFFFFFF


def _mul32(x, constant: int):
    """``x * constant`` modulo 2**32 for int64 ``x`` in [0, 2**32), in
    16-bit halves of the constant so no int64 product overflows."""
    low, high = constant & 0xFFFF, constant >> 16
    return (x * low + (((x * high) & 0xFFFF) << 16)) & _U32


def keep_threshold(dropout: float) -> int:
    """The hash's keep threshold: ``round((1 - p) * 2**24)``, as the
    reference computes it."""
    return int(round((1.0 - dropout) * (1 << 24)))


def keep_mask(seed: int, head_rows, rows, cols, dropout: float):
    """The reference's ``_keep_mask`` (``flash.py:80-103``) on global
    positions: bool, broadcast over ``head_rows`` (the query head's row
    ``b * Hq + h``), ``rows`` (query positions) and ``cols`` (key
    positions), int tensors in [0, 2**32). The uint32 arithmetic runs on
    int64 masked to 32 bits; the mask does not depend on the tiling."""
    head_rows, rows, cols = (torch.as_tensor(t).long()
                             for t in (head_rows, rows, cols))
    x = _mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77)
    x = (x + (int(seed) & _U32) + _mul32(head_rows, 0xC2B2AE35)) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8) < keep_threshold(dropout)


def _tile_keep(seed, dropout, batch, q_heads, seq, cols, device):
    """``[B, Hq, S, len(cols)]`` float32 keep mask of one kv tile."""
    head_rows = torch.arange(batch * q_heads, device=device).reshape(
        batch, q_heads, 1, 1)
    rows = torch.arange(seq, device=device)[:, None]
    return keep_mask(seed, head_rows, rows, cols[None, :], dropout).float()


def _check_dropout(dropout: float, seed) -> None:
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f'dropout must be in [0, 1), got {dropout}')
    if dropout and seed is None:
        raise ValueError('dropout > 0 needs an int seed')


def flash_attention_plain(query, key, value, *, causal: bool = True,
                          dropout: float = 0.0, seed: int | None = None):
    """Plain PyTorch ``(out, lse)``: the kernel's online softmax over
    64-wide kv tiles in float32, probabilities rounded to ``value``'s dtype
    before the product with ``value``, ``lse = m + log(safe_l)``. Under
    dropout ``l`` sums the unmasked probabilities, the kept ones meet
    ``value`` and ``out`` is divided by ``1 - dropout`` (``flash.py:127-157``);
    lse stays the full denominator."""
    _check_dropout(dropout, seed)
    batch, seq, q_heads, head_dim = query.shape
    group = q_heads // key.shape[2]
    scale = head_dim ** -0.5
    q = query.float().transpose(1, 2)                           # [B,H,S,D]
    k = key.float().repeat_interleave(group, dim=2).transpose(1, 2)
    v = value.float().repeat_interleave(group, dim=2).transpose(1, 2)
    m = torch.full((batch, q_heads, seq), NEG_INF, device=query.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    rows = torch.arange(seq, device=query.device)
    for start in range(0, k.shape[2], TILE):
        cols = torch.arange(start, min(start + TILE, k.shape[2]),
                            device=query.device)
        scores = torch.matmul(q, k[:, :, start:start + TILE].transpose(-1, -2))
        scores = scores * scale
        if causal:
            scores = torch.where(cols[None, :] <= rows[:, None], scores,
                                 torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - m_new)
        probs = torch.exp(scores - m_new[..., None])
        l = correction * l + probs.sum(-1)
        if dropout:
            probs = probs * _tile_keep(seed, dropout, batch, q_heads, seq,
                                       cols, query.device)
        acc = acc * correction[..., None] + torch.matmul(
            probs.to(value.dtype).float(), v[:, :, start:start + TILE])
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / safe[..., None]
    if dropout:
        out = out / _keep_scale(dropout, out)
    out = out.to(query.dtype).transpose(1, 2)
    lse = (m + torch.log(safe)).transpose(1, 2)
    return out.contiguous(), lse.contiguous()


def _keep_scale(dropout: float, like):
    """``1 - dropout`` as a scalar tensor of ``like``'s dtype (float32 in
    the kernels), so the division rounds as the kernels' does."""
    return torch.tensor(1.0 - dropout, dtype=like.dtype, device=like.device)


def attention_delta(out, d_out, d_lse=None):
    """``rowsum(dO * O) - dlse`` ``[B, S, Hq]``, in float32 (float64 for
    float64 inputs): the backward's per-row term. A non-zero lse cotangent
    folds in here, as in the reference (``flash.py:502-506``)."""
    work = torch.promote_types(out.dtype, torch.float32)
    delta = (d_out.to(work) * out.to(work)).sum(-1)
    return delta if d_lse is None else delta - d_lse.to(work)


def flash_attention_bwd_plain(query, key, value, out, lse, d_out, d_lse=None,
                              *, causal: bool = True,
                              backward: str = 'fused', dropout: float = 0.0,
                              seed: int | None = None):
    """Plain PyTorch ``(dq, dk, dv)`` of :func:`flash_attention_lse`: the
    kernels' tile math written out over 64-wide kv tiles (not autograd of
    the forward). ``P = exp(scores - lse)``, ``dP = dO V^T``,
    ``dS = P (dP - delta) scale``; ``P`` is rounded to ``d_out``'s dtype
    before ``dV += P^T dO``, ``dS`` to ``query``'s before ``dK += dS^T Q``
    and ``dQ += dS K``; sums in float32 (float64 for float64 inputs). Under
    dropout ``dV`` takes ``P * keep / (1 - p)`` and ``dS`` takes
    ``keep * dP / (1 - p)`` for ``dP`` (``flash.py:270-277``). dk and dv of a
    kv head sum its group's query heads in order; dq sums the kv tiles in
    ascending order, as the fused kernel's tickets do (over 128-row kv
    tiles). The one
    plain version of K2a, K2b and the split pair K3a + K3b: they compute the
    same function, so ``backward`` is only checked."""
    _check_backward(backward)
    _check_dropout(dropout, seed)
    batch, seq, q_heads, head_dim = query.shape
    kv_heads = key.shape[2]
    group = q_heads // kv_heads
    scale = head_dim ** -0.5
    work = torch.promote_types(query.dtype, torch.float32)
    q = query.to(work).transpose(1, 2)                          # [B,H,S,D]
    k = key.to(work).repeat_interleave(group, dim=2).transpose(1, 2)
    v = value.to(work).repeat_interleave(group, dim=2).transpose(1, 2)
    grad = d_out.to(work).transpose(1, 2)
    lse = lse.to(work).transpose(1, 2)[..., None]               # [B,H,S,1]
    delta = attention_delta(out, d_out, d_lse).transpose(1, 2)[..., None]
    rows = torch.arange(seq, device=query.device)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for start in range(0, seq, TILE):
        stop = min(start + TILE, seq)
        cols = torch.arange(start, stop, device=query.device)
        k_tile, v_tile = k[:, :, start:stop], v[:, :, start:stop]
        scores = torch.matmul(q, k_tile.transpose(-1, -2)) * scale
        if causal:
            scores = torch.where(cols[None, :] <= rows[:, None], scores,
                                 torch.full_like(scores, NEG_INF))
        probs = torch.exp(scores - lse)
        d_probs = torch.matmul(grad, v_tile.transpose(-1, -2))
        kept = probs
        if dropout:
            keep = _tile_keep(seed, dropout, batch, q_heads, seq, cols,
                              query.device).to(work)
            kept = probs * keep / _keep_scale(dropout, probs)
            d_probs = keep * d_probs / _keep_scale(dropout, probs)
        d_scores = probs * (d_probs - delta) * scale
        kept = kept.to(d_out.dtype).to(work)
        d_scores = d_scores.to(query.dtype).to(work)
        dv[:, :, start:stop] = torch.matmul(kept.transpose(-1, -2), grad)
        dk[:, :, start:stop] = torch.matmul(d_scores.transpose(-1, -2), q)
        dq = dq + torch.matmul(d_scores, k_tile)

    def grouped(tensor):                       # [B,Hq,S,D] -> [B,S,Hkv,D]
        tensor = tensor.reshape(batch, kv_heads, group, seq, head_dim)
        return tensor.sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(query.dtype).contiguous(),
            grouped(dk).to(key.dtype).contiguous(),
            grouped(dv).to(value.dtype).contiguous())


class _Dropout(ctypes.Structure):
    """``struct Dropout`` of ``csrc/flash_dropout.cuh``."""
    _fields_ = [('on', ctypes.c_int), ('threshold', ctypes.c_uint32),
                ('seed', ctypes.c_uint32), ('keep', ctypes.c_float)]


def _dropout_arg(dropout: float, seed):
    """The kernels' dropout argument: NULL at ``dropout == 0``."""
    if not dropout:
        return None
    return ctypes.byref(_Dropout(1, keep_threshold(dropout), int(seed) & _U32,
                                 1.0 - dropout))


def _library():
    lib = LIBRARIES.library('flash_fwd')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_bf16.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, i32, ctypes.c_float, i32, ptr,
                                       ptr]
        lib.flash_fwd_bf16.restype = i32
        lib._typed = True
    return lib


def _bwd_library():
    lib = LIBRARIES.library('flash_bwd')
    if not getattr(lib, '_typed', False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        size = ctypes.c_size_t
        lib.flash_bwd_tickets.argtypes = [i32, i32, i32]
        lib.flash_bwd_tickets.restype = size
        lib.flash_bwd_padded_rows.argtypes = [i32]
        lib.flash_bwd_padded_rows.restype = i32
        lib.flash_bwd_clocks.argtypes = []
        lib.flash_bwd_clocks.restype = i32
        lib.flash_bwd_fused_bf16.argtypes = [ptr] * 12 + [i32] * 5 + [
            f32, i32, ptr, ptr]
        lib.flash_bwd_fused_bf16.restype = i32
        lib.flash_bwd_dkv_bf16.argtypes = [ptr] * 8 + [i32] * 5 + [
            f32, i32, ptr, ptr]
        lib.flash_bwd_dkv_bf16.restype = i32
        lib.flash_bwd_dq_bf16.argtypes = [ptr] * 7 + [i32] * 5 + [
            f32, i32, ptr, ptr]
        lib.flash_bwd_dq_bf16.restype = i32
        lib._typed = True
    return lib


def _pointer(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_backward(backward: str) -> None:
    if backward not in BACKWARDS:
        raise ValueError(f"backward must be 'fused' or 'split', got "
                         f'{backward!r}')


def _check_shapes(query, key) -> None:
    if query.shape[2] % key.shape[2]:
        raise ValueError(f'query heads ({query.shape[2]}) must be a multiple '
                         f'of KV heads ({key.shape[2]}) for grouped-query '
                         'attention')
    if key.shape[1] != query.shape[1]:
        raise ValueError('flash_attention takes self-attention: query and '
                         f'key lengths differ ({query.shape[1]} vs '
                         f'{key.shape[1]})')


def _check_head_dim(name: str, head_dim: int) -> None:
    """The kernels are instantiated for ``HEAD_DIMS`` only: a call at
    another head dim raises here, before anything runs."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'{name}: head_dim {head_dim} not in {HEAD_DIMS}')


def _check_cuda(name, tensors, device) -> None:
    """What the CUDA kernels take: bfloat16 ``[B, S, H, D]`` tensors on one
    device, each starting on a 16-byte boundary (K1's TMA and the kernels'
    16-byte loads need it; a view that does not is refused, never copied), a
    head dim in ``HEAD_DIMS`` and at most 65535 batch rows x heads."""
    batch, _, heads, head_dim = tensors[0].shape
    _check_head_dim(name, head_dim)
    if device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {device} are not supported')
    for tensor in tensors:
        if tensor.dtype != torch.bfloat16 or tensor.device != device:
            raise ValueError(f'{name}: the CUDA kernel takes bfloat16 '
                             'tensors on one device')
        if tensor.data_ptr() % 16:
            raise ValueError(f'{name}: a tensor starts off a 16-byte '
                             f'boundary (data_ptr {tensor.data_ptr():#x})')
    if batch * heads > 65535:
        raise ValueError(f'{name}: batch * heads over 65535')


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


def _flash_forward(query, key, value, causal: bool, dropout: float, seed):
    """K1 or, for CPU tensors, its plain version: ``(out, lse)`` and the
    contiguous ``(query, key, value)`` the kernel read."""
    if query.device.type == 'cpu':
        return (*flash_attention_plain(query, key, value, causal=causal,
                                       dropout=dropout, seed=seed),
                (query, key, value))
    _check_cuda('flash_attention', (query, key, value), query.device)
    batch, seq, q_heads, head_dim = query.shape
    query, key, value = (t.contiguous() for t in (query, key, value))
    out = torch.empty_like(query)
    lse = torch.empty((batch, seq, q_heads), dtype=torch.float32,
                      device=query.device)
    err = _library().flash_fwd_bf16(
        _pointer(query), _pointer(key), _pointer(value), _pointer(out),
        _pointer(lse), batch, seq, q_heads, key.shape[2], head_dim,
        head_dim ** -0.5, int(causal), _dropout_arg(dropout, seed),
        _stream(query.device))
    _raise_on(err, 'flash_attention')
    flash_attention_lse.launches += 1
    return out, lse, (query, key, value)


def _kernel_args(name, query, key):
    """``(batch, seq, q_heads, kv_heads, head_dim)`` of a backward kernel's
    call, which raises at a head dim the kernels do not take."""
    batch, seq, q_heads, head_dim = query.shape
    _check_head_dim(name, head_dim)
    return batch, seq, q_heads, key.shape[2], head_dim


def _by_head(stats, rows: int):
    """``[B, S, H]`` float32 row statistics laid out ``[B, H, rows]``, zero
    past S, as the fused kernel reads them: a q tile's 64 values are one
    contiguous bulk copy (lse goes in times log2(e), the kernel's exp2
    argument)."""
    batch, seq, heads = stats.shape
    out = stats.new_zeros((batch, heads, rows))
    out[:, :, :seq] = stats.transpose(1, 2)
    return out


def _stats_by_head(lib, lse, delta):
    """``(lse * log2(e), delta)`` laid out ``[B, Hq, S_pad]`` as the fused
    kernel and K3b (its body) read them."""
    rows = lib.flash_bwd_padded_rows(lse.shape[1])
    return _by_head(lse * LOG2E, rows), _by_head(delta, rows)


def _fused_call(query, key, value, d_out, lse, delta, causal, dropout, seed,
                clocks=None):
    """One launch of the fused backward kernel (K2a and K2b are its one
    body): ``(err, (dq, dk, dv))``. ``clocks`` (int64 ``[items,
    flash_bwd_clocks()]``) takes each work item's cycles and its ticket
    waits (and, in a build with ``FLASH_BWD_PHASES``, its cycles by phase
    first)."""
    batch, seq, q_heads, head_dim = query.shape
    lib = _bwd_library()
    rows = lib.flash_bwd_padded_rows(seq)
    dq_acc = torch.empty(batch * q_heads * rows * head_dim,
                         dtype=torch.float32, device=query.device)
    tickets = torch.zeros(lib.flash_bwd_tickets(batch, seq, q_heads),
                          dtype=torch.int32, device=query.device)
    dq, dk, dv = (torch.empty_like(t) for t in (query, key, value))
    err = lib.flash_bwd_fused_bf16(
        *(_pointer(t) for t in (query, key, value, d_out,
                                *_stats_by_head(lib, lse, delta), dq, dk, dv,
                                dq_acc, tickets)),
        None if clocks is None else _pointer(clocks), batch, seq, q_heads,
        key.shape[2], head_dim, head_dim ** -0.5, int(causal),
        _dropout_arg(dropout, seed), _stream(query.device))
    return err, (dq, dk, dv)


def flash_bwd_fused_g1(query, key, value, d_out, lse, delta, *,
                       causal: bool = True, dropout: float = 0.0,
                       seed: int | None = None):
    """K2a on the card: ``(dq, dk, dv)`` of multi-head attention, the
    fused kernel of :func:`flash_bwd_fused` (bitwise its result), launched
    where the reference runs its resident-dq kernel. Contiguous bf16
    ``[B, S, H, D]`` tensors, float32 ``lse``/``delta``."""
    _, _, heads, kv_heads, _ = _kernel_args('flash_bwd_fused_g1', query, key)
    if kv_heads != heads:
        raise ValueError('flash_bwd_fused_g1 takes multi-head attention '
                         f'({heads} query heads, {kv_heads} KV heads)')
    err, grads = _fused_call(query, key, value, d_out, lse, delta, causal,
                             dropout, seed)
    _raise_on(err, 'flash_bwd_fused_g1')
    flash_bwd_fused_g1.launches += 1
    return grads


def flash_bwd_fused(query, key, value, d_out, lse, delta, *,
                    causal: bool = True, dropout: float = 0.0,
                    seed: int | None = None):
    """K2b on the card: ``(dq, dk, dv)`` from one recomputation of each
    visible tile on TMA-fed ``wgmma``, dq summed in kv order behind one
    ticket per (head row, q tile), any GQA group; ``delta`` from
    :func:`attention_delta`. Contiguous bf16 ``[B, S, H, D]`` tensors,
    float32 ``lse``/``delta`` ``[B, S, Hq]``."""
    _kernel_args('flash_bwd_fused', query, key)
    err, grads = _fused_call(query, key, value, d_out, lse, delta, causal,
                             dropout, seed)
    _raise_on(err, 'flash_bwd_fused')
    flash_bwd_fused.launches += 1
    return grads


def fused_clocks(query, key, value, d_out, lse, delta, *,
                 causal: bool = True):
    """A diagnostic launch of the fused kernel (not counted in
    ``launches``): int64 ``[work items, flash_bwd_clocks()]``, thread 0's
    cycles by phase (zero unless the library was built with
    ``FLASH_BWD_PHASES``), each item's cycles and its ticket waits."""
    batch, seq, _, kv_heads, _ = _kernel_args('fused_clocks', query, key)
    items = -(-seq // 128) * batch * kv_heads
    clocks = torch.zeros((items, _bwd_library().flash_bwd_clocks()),
                         dtype=torch.int64, device=query.device)
    err, _ = _fused_call(query, key, value, d_out, lse, delta, causal, 0.0,
                         None, clocks)
    _raise_on(err, 'fused_clocks')
    return clocks


def fused_ticket_waits(query, key, value, d_out, lse, delta, *,
                       causal: bool = True) -> dict:
    """The share of the fused kernel's work items' cycles that thread 0
    spent waiting for dq tickets, summed over the items, and the largest
    share of one item (:func:`fused_clocks`)."""
    clocks = fused_clocks(query, key, value, d_out, lse, delta,
                          causal=causal)[:, -2:].double()
    cycles, waited = clocks.sum(0).tolist()
    share = clocks[:, 1] / clocks[:, 0].clamp(min=1)
    return {'wait_share': waited / cycles, 'max_item_share':
            share.max().item(), 'items': clocks.shape[0]}


def flash_bwd_dq(query, key, value, d_out, lse, delta, *,
                 causal: bool = True, dropout: float = 0.0,
                 seed: int | None = None):
    """K3a on the card: dq, a TMA-fed ``wgmma`` sweep over the visible kv
    tiles of each 128-row q tile, dq in registers. Contiguous bf16
    ``[B, S, H, D]`` tensors, float32 ``lse``/``delta`` ``[B, S, Hq]``."""
    batch, seq, q_heads, kv_heads, head_dim = _kernel_args(
        'flash_bwd_dq', query, key)
    dq = torch.empty_like(query)
    err = _bwd_library().flash_bwd_dq_bf16(
        *(_pointer(t) for t in (query, key, value, d_out, lse, delta, dq)),
        batch, seq, q_heads, kv_heads, head_dim, head_dim ** -0.5,
        int(causal), _dropout_arg(dropout, seed), _stream(query.device))
    _raise_on(err, 'flash_bwd_dq')
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(query, key, value, d_out, lse, delta, *,
                  causal: bool = True, dropout: float = 0.0,
                  seed: int | None = None):
    """K3b on the card: ``(dk, dv)``, the fused kernel's sweep over every
    (q tile, group member) pair that sees each kv tile, without dq: bit for
    bit :func:`flash_bwd_fused`'s dk and dv. Arguments as
    :func:`flash_bwd_fused`'s."""
    batch, seq, q_heads, kv_heads, head_dim = _kernel_args(
        'flash_bwd_dkv', query, key)
    lib = _bwd_library()
    dk, dv = torch.empty_like(key), torch.empty_like(value)
    err = lib.flash_bwd_dkv_bf16(
        *(_pointer(t) for t in (query, key, value, d_out,
                                *_stats_by_head(lib, lse, delta), dk, dv)),
        batch, seq, q_heads, kv_heads, head_dim, head_dim ** -0.5,
        int(causal), _dropout_arg(dropout, seed), _stream(query.device))
    _raise_on(err, 'flash_bwd_dkv')
    flash_bwd_dkv.launches += 1
    return dk, dv


def backward_kernels(query, key, backward: str = 'fused') -> tuple:
    """The backward kernels :func:`flash_attention_bwd` launches for these
    shapes on the card: K2a for fused multi-head attention over more than
    ``FUSED_MHA_KEYS`` keys (the reference's ``resident_dq``,
    ``flash.py:508``), K2b for other fused calls, K3a and K3b for
    ``'split'``."""
    _check_backward(backward)
    if backward == 'split':
        return flash_bwd_dq, flash_bwd_dkv
    if query.shape[2] == key.shape[2] and key.shape[1] > FUSED_MHA_KEYS:
        return (flash_bwd_fused_g1,)
    return (flash_bwd_fused,)


def flash_attention_bwd(query, key, value, out, lse, d_out, d_lse=None, *,
                        causal: bool = True, backward: str = 'fused',
                        dropout: float = 0.0, seed: int | None = None):
    """``(dq, dk, dv)`` of :func:`flash_attention_lse` for the cotangents
    ``d_out`` and ``d_lse`` (``None`` for none). CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the kernels
    :func:`backward_kernels` names on the current stream."""
    _check_backward(backward)
    _check_shapes(query, key)
    _check_dropout(dropout, seed)
    if query.device.type == 'cpu':
        return flash_attention_bwd_plain(query, key, value, out, lse, d_out,
                                         d_lse, causal=causal,
                                         backward=backward, dropout=dropout,
                                         seed=seed)
    _check_cuda('flash_attention_bwd', (query, key, value, out, d_out),
                query.device)
    query, key, value, d_out = (t.contiguous()
                                for t in (query, key, value, d_out))
    lse = lse.float().contiguous()
    delta = attention_delta(out, d_out, d_lse).contiguous()
    args = (query, key, value, d_out, lse, delta)
    options = dict(causal=causal, dropout=dropout, seed=seed)
    grads = ()
    for kernel in backward_kernels(query, key, backward):
        got = kernel(*args, **options)
        grads += got if isinstance(got, tuple) else (got,)
    return grads


class _FlashAttention(torch.autograd.Function):
    """K1 forward saving ``(q, k, v, out, lse)`` and the dropout seed; the
    backward kernels regenerate the forward's masks from that seed. The
    autograd engine runs ``backward`` on the forward's stream, which is the
    current stream the kernels launch on."""

    @staticmethod
    def forward(ctx, query, key, value, causal, backward, dropout, seed):
        out, lse, inputs = _flash_forward(query, key, value, causal, dropout,
                                          seed)
        ctx.save_for_backward(*inputs, out, lse)
        ctx.causal, ctx.backward = causal, backward
        ctx.dropout, ctx.seed = dropout, seed
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        query, key, value, out, lse = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(out)
        grads = flash_attention_bwd(query, key, value, out, lse, d_out, d_lse,
                                    causal=ctx.causal, backward=ctx.backward,
                                    dropout=ctx.dropout, seed=ctx.seed)
        return (*grads, None, None, None, None)


def flash_attention_lse(query, key, value, *, causal: bool = True,
                        backward: str = 'fused', dropout: float = 0.0,
                        seed: int | None = None):
    """Flash attention returning ``(out [B,S,Hq,D], lse [B,S,Hq] float32)``,
    differentiable in both outputs.

    ``key``/``value`` may carry fewer heads than ``query`` (GQA). On CUDA
    the kernels take bfloat16, any length and the head dims in
    ``HEAD_DIMS``.
    ``backward`` picks the gradient kernels: ``'fused'`` (K2a or K2b, see
    :func:`backward_kernels`) or ``'split'`` (K3a + K3b). ``dropout > 0``
    drops attention probabilities with the 'xla' path's semantics
    (normalised weights dropped, survivors scaled by ``1 / (1 - dropout)``,
    lse the full denominator) through masks hashed from ``seed``, an int in
    ``[0, 2**31 - 1)`` the caller draws (the model draws it from its
    dropout key as the reference does, ``flash.py:770-774``:
    :func:`tpusystem_torch.ops.threefry.flash_seed`); it raises without
    one."""
    _check_shapes(query, key)
    _check_backward(backward)
    _check_dropout(dropout, seed)
    with annotate(ATTENTION):
        return _FlashAttention.apply(query, key, value, causal, backward,
                                     float(dropout), seed)


LANES = 128   # the reference's tile granule (``flash.py:47``)


def _fit_block(seq: int, want: int = 1024) -> int | None:
    """The reference's tile for a length (``flash.py:397``): the largest
    multiple of 128 up to ``want`` that divides ``seq``; one block of
    ``seq`` up to 128 rows if it is a multiple of 8; else ``None``."""
    want = min(want, seq)
    if seq <= LANES:
        return seq if seq % 8 == 0 else None
    best = None
    for candidate in range(LANES, want + 1, LANES):
        if seq % candidate == 0:
            best = candidate
    return best


def reference_tiles(seq_q: int, seq_kv: int) -> bool:
    """Whether the reference's flash call runs its kernels at these lengths
    (its default 1,024-row blocks, ``flash.py:417``). Where it does not,
    it attends through XLA (``flash.py:794``), whose probability dropout
    draws ``bernoulli`` over the weights; the port's kernels take any
    length, so only dropout needs the reference's route there."""
    return _fit_block(seq_q) is not None and _fit_block(seq_kv) is not None


def dropped_attention(query, key, value, *, causal: bool, dropout: float,
                      rng):
    """Attention with probability dropout as the reference's flash call
    runs it: the kernels with their positional hash of ``rng``'s seed
    where :func:`reference_tiles` holds, else the ``'xla'`` path's
    ``bernoulli`` masks of ``rng`` over the weights."""
    from tpusystem_torch.ops.attention import dot_product_attention
    from tpusystem_torch.ops.threefry import flash_seed
    if reference_tiles(query.shape[1], key.shape[1]):
        return flash_attention(query, key, value, causal=causal,
                               dropout=dropout, seed=flash_seed(rng))
    return dot_product_attention(query, key, value, causal=causal,
                                 dropout=dropout, rng=rng)


def flash_attention(query, key, value, *, causal: bool = True,
                    backward: str = 'fused', dropout: float = 0.0,
                    seed: int | None = None):
    """:func:`flash_attention_lse` without the logsumexp."""
    return flash_attention_lse(query, key, value, causal=causal,
                               backward=backward, dropout=dropout,
                               seed=seed)[0]


def sharded_flash_attention(query, key, value, mesh, *, causal: bool = True,
                            dropout: float = 0.0, rng=None):
    """Flash attention over a mesh of ranks: the reference's
    ``sharded_flash_attention`` (``flash.py:836``).

    Attention is parallel over batch x heads. A port rank holds its batch
    rows (split over ``(data, fsdp)`` by the step) and here takes its block
    of the heads over ``model`` where the query heads divide, launching K1
    (and the backward kernels, through autograd) on those heads alone; the
    context's heads are gathered whole again (backward, this rank's block
    of the gradient). Where the KV heads do not divide the ``model`` axis,
    KV is broadcast to the query heads first, with the reference's
    warning. Under dropout the threefry key ``rng`` is folded with the
    index of each axis of more than one rank, ``data``, ``fsdp``, then
    ``model`` (the reference's order), so the ranks' masks decorrelate,
    and drops as :func:`dropped_attention` does on this rank's heads."""
    import warnings

    from tpusystem_torch.ops.attention import repeat_kv_heads
    from tpusystem_torch.ops.threefry import fold_in
    from tpusystem_torch.parallel.collectives import gather_from, scatter_to
    from tpusystem_torch.parallel.mesh import DATA, FSDP, MODEL

    model = mesh.shape[MODEL]
    split = model > 1 and query.shape[2] % model == 0
    if split and key.shape[2] % model:
        warnings.warn(
            f"sharded_flash_attention: {key.shape[2]} KV heads do not divide "
            f"the model axis ({model}); broadcasting KV to the "
            f"{query.shape[2]} query heads. This is correct but forfeits the "
            "GQA KV memory saving on this mesh — pick a model axis that "
            "divides the KV head count to keep grouped KV.",
            stacklevel=2)
        key, value = repeat_kv_heads(query, key, value)
    if dropout:
        for axis in (DATA, FSDP, MODEL):
            if mesh.shape[axis] > 1:
                rng = fold_in(rng, mesh.axis_index(axis))
    if split:
        query, key, value = (scatter_to(t, mesh, MODEL, dimension=2)
                             for t in (query, key, value))
    out = (dropped_attention(query, key, value, causal=causal,
                             dropout=dropout, rng=rng) if dropout
           else flash_attention(query, key, value, causal=causal))
    return gather_from(out, mesh, MODEL, dimension=2) if split else out


flash_attention_lse.launches = 0
flash_bwd_fused_g1.launches = 0
flash_bwd_fused.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
