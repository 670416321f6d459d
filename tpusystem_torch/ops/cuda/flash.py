"""Flash attention, forward and backward: hand-written CUDA kernels for Hopper.

The counterpart of :mod:`tpusystem.ops.pallas.flash`: causal online-softmax
attention over ``[batch, length, heads, head_dim]`` tensors that returns the
output and the float32 logsumexp ``[batch, length, heads]``, with
grouped-query attention mapping query head ``h`` to kv head ``h // group``.
``csrc/flash_fwd.cu`` (K1) and ``csrc/flash_bwd.cu`` (K2b, K3a, K3b) hold the
design notes. :func:`flash_attention_lse` is differentiable in both outputs
through a ``torch.autograd.Function``: its forward runs K1 and saves the
logsumexp, its backward runs ``backward='fused'`` (one recomputation of each
tile for dq, dk and dv) or ``'split'`` (a dq sweep and a dk/dv sweep). Not
ported yet: the resident-dq fused backward K2a (MHA past 1024 keys) and the
in-kernel dropout hash.

Every wrapper follows its tensors' device: a CPU tensor takes the plain
PyTorch version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`), a CUDA tensor launches the kernel or
raises. ``flash_attention_lse.launches``, ``flash_bwd_fused.launches``,
``flash_bwd_dq.launches`` and ``flash_bwd_dkv.launches`` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpusystem_torch.ops.cuda._build import LIBRARIES

NEG_INF = -1e30
TILE = 64          # kv rows per online-softmax step, as in the CUDA kernels
HEAD_DIMS = (16, 32, 64)
FUSED_MHA_KEYS = 1024   # past this, the reference's fused MHA backward is K2a
BACKWARDS = ('fused', 'split')


def flash_attention_plain(query, key, value, *, causal: bool = True):
    """Plain PyTorch ``(out, lse)``: the kernel's online softmax over
    64-wide kv tiles in float32, probabilities rounded to ``value``'s dtype
    before the product with ``value``, ``lse = m + log(safe_l)``."""
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
        acc = acc * correction[..., None] + torch.matmul(
            probs.to(value.dtype).float(), v[:, :, start:start + TILE])
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe[..., None]).to(query.dtype).transpose(1, 2)
    lse = (m + torch.log(safe)).transpose(1, 2)
    return out.contiguous(), lse.contiguous()


def attention_delta(out, d_out, d_lse=None):
    """``rowsum(dO * O) - dlse`` ``[B, S, Hq]``, in float32 (float64 for
    float64 inputs): the backward's per-row term. A non-zero lse cotangent
    folds in here, as in the reference (``flash.py:502-506``)."""
    work = torch.promote_types(out.dtype, torch.float32)
    delta = (d_out.to(work) * out.to(work)).sum(-1)
    return delta if d_lse is None else delta - d_lse.to(work)


def flash_attention_bwd_plain(query, key, value, out, lse, d_out, d_lse=None,
                              *, causal: bool = True,
                              backward: str = 'fused'):
    """Plain PyTorch ``(dq, dk, dv)`` of :func:`flash_attention_lse`: the
    kernels' tile math written out over 64-wide kv tiles (not autograd of
    the forward). ``P = exp(scores - lse)``, ``dP = dO V^T``,
    ``dS = P (dP - delta) scale``; ``P`` is rounded to ``d_out``'s dtype
    before ``dV += P^T dO``, ``dS`` to ``query``'s before ``dK += dS^T Q``
    and ``dQ += dS K``; sums in float32 (float64 for float64 inputs). dk and
    dv of a kv head sum its group's query heads in order. ``'fused'`` and
    ``'split'`` compute the same function, so ``backward`` is only checked."""
    _check_backward(backward)
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
        d_scores = probs * (d_probs - delta) * scale
        kept = probs.to(d_out.dtype).to(work)
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


def _library():
    lib = LIBRARIES.library('flash_fwd')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_bf16.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, i32, ctypes.c_float, i32, ptr]
        lib.flash_fwd_bf16.restype = i32
        lib._typed = True
    return lib


def _bwd_library():
    lib = LIBRARIES.library('flash_bwd')
    if not getattr(lib, '_typed', False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_bwd_partial_elements.argtypes = [i32, i32, i32, i32, i32]
        lib.flash_bwd_partial_elements.restype = ctypes.c_size_t
        lib.flash_bwd_fused_bf16.argtypes = [ptr] * 10 + [i32] * 5 + [
            f32, i32, ptr]
        lib.flash_bwd_fused_bf16.restype = i32
        lib.flash_bwd_dkv_bf16.argtypes = [ptr] * 8 + [i32] * 5 + [
            f32, i32, ptr]
        lib.flash_bwd_dkv_bf16.restype = i32
        lib.flash_bwd_dq_bf16.argtypes = [ptr] * 7 + [i32] * 5 + [
            f32, i32, ptr]
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


def _check_cuda(name, tensors, device) -> None:
    """What the CUDA kernels take: bfloat16 ``[B, S, H, D]`` tensors on one
    device, a head dim in ``HEAD_DIMS`` and at most 65535 batch rows x
    heads."""
    if device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {device} are not supported')
    for tensor in tensors:
        if tensor.dtype != torch.bfloat16 or tensor.device != device:
            raise ValueError(f'{name}: the CUDA kernel takes bfloat16 '
                             'tensors on one device')
    batch, _, heads, head_dim = tensors[0].shape
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'{name}: head_dim {head_dim} not in {HEAD_DIMS}')
    if batch * heads > 65535:
        raise ValueError(f'{name}: batch * heads over 65535')


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


def _flash_forward(query, key, value, causal: bool):
    """K1 or, for CPU tensors, its plain version: ``(out, lse)`` and the
    contiguous ``(query, key, value)`` the kernel read."""
    if query.device.type == 'cpu':
        return (*flash_attention_plain(query, key, value, causal=causal),
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
        head_dim ** -0.5, int(causal), _stream(query.device))
    _raise_on(err, 'flash_attention')
    flash_attention_lse.launches += 1
    return out, lse, (query, key, value)


def _kernel_args(query, key):
    batch, seq, q_heads, head_dim = query.shape
    return batch, seq, q_heads, key.shape[2], head_dim


def flash_bwd_fused(query, key, value, d_out, lse, delta, *,
                    causal: bool = True):
    """K2b on the card: ``(dq, dk, dv)`` from one recomputation of each
    visible tile; ``delta`` from :func:`attention_delta`. Contiguous bf16
    ``[B, S, H, D]`` tensors, float32 ``lse``/``delta``."""
    batch, seq, q_heads, kv_heads, head_dim = _kernel_args(query, key)
    lib = _bwd_library()
    partial = torch.empty(
        lib.flash_bwd_partial_elements(batch, seq, q_heads, head_dim,
                                       int(causal)),
        dtype=torch.float32, device=query.device)
    dq, dk, dv = (torch.empty_like(t) for t in (query, key, value))
    err = lib.flash_bwd_fused_bf16(
        *(_pointer(t) for t in (query, key, value, d_out, lse, delta, dq, dk,
                                dv, partial)),
        batch, seq, q_heads, kv_heads, head_dim, head_dim ** -0.5,
        int(causal), _stream(query.device))
    _raise_on(err, 'flash_bwd_fused')
    flash_bwd_fused.launches += 1
    return dq, dk, dv


def flash_bwd_dq(query, key, value, d_out, lse, delta, *,
                 causal: bool = True):
    """K3a on the card: dq, a sweep over the visible kv tiles per q tile."""
    batch, seq, q_heads, kv_heads, head_dim = _kernel_args(query, key)
    dq = torch.empty_like(query)
    err = _bwd_library().flash_bwd_dq_bf16(
        *(_pointer(t) for t in (query, key, value, d_out, lse, delta, dq)),
        batch, seq, q_heads, kv_heads, head_dim, head_dim ** -0.5,
        int(causal), _stream(query.device))
    _raise_on(err, 'flash_bwd_dq')
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(query, key, value, d_out, lse, delta, *,
                  causal: bool = True):
    """K3b on the card: ``(dk, dv)``, a sweep over every (group member, q
    tile) pair that sees each kv tile."""
    batch, seq, q_heads, kv_heads, head_dim = _kernel_args(query, key)
    dk, dv = torch.empty_like(key), torch.empty_like(value)
    err = _bwd_library().flash_bwd_dkv_bf16(
        *(_pointer(t) for t in (query, key, value, d_out, lse, delta, dk,
                                dv)),
        batch, seq, q_heads, kv_heads, head_dim, head_dim ** -0.5,
        int(causal), _stream(query.device))
    _raise_on(err, 'flash_bwd_dkv')
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(query, key, value, out, lse, d_out, d_lse=None, *,
                        causal: bool = True, backward: str = 'fused'):
    """``(dq, dk, dv)`` of :func:`flash_attention_lse` for the cotangents
    ``d_out`` and ``d_lse`` (``None`` for none). CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch
    :func:`flash_bwd_fused` (``'fused'``) or :func:`flash_bwd_dq` and
    :func:`flash_bwd_dkv` (``'split'``) on the current stream."""
    _check_backward(backward)
    _check_shapes(query, key)
    if (backward == 'fused' and query.shape[2] == key.shape[2]
            and key.shape[1] > FUSED_MHA_KEYS):
        raise NotImplementedError(
            f"backward='fused' for multi-head attention over more than "
            f'{FUSED_MHA_KEYS} keys is the reference\'s resident-dq kernel '
            "K2a, not ported yet (ROADMAP queue 2: K2a); pass "
            "backward='split'")
    if query.device.type == 'cpu':
        return flash_attention_bwd_plain(query, key, value, out, lse, d_out,
                                         d_lse, causal=causal,
                                         backward=backward)
    _check_cuda('flash_attention_bwd', (query, key, value, out, d_out),
                query.device)
    query, key, value, d_out = (t.contiguous()
                                for t in (query, key, value, d_out))
    lse = lse.float().contiguous()
    delta = attention_delta(out, d_out, d_lse).contiguous()
    if backward == 'fused':
        return flash_bwd_fused(query, key, value, d_out, lse, delta,
                               causal=causal)
    dq = flash_bwd_dq(query, key, value, d_out, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(query, key, value, d_out, lse, delta,
                           causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward saving ``(q, k, v, out, lse)``; the backward kernels.
    The autograd engine runs ``backward`` on the forward's stream, which is
    the current stream the kernels launch on."""

    @staticmethod
    def forward(ctx, query, key, value, causal, backward):
        out, lse, inputs = _flash_forward(query, key, value, causal)
        ctx.save_for_backward(*inputs, out, lse)
        ctx.causal, ctx.backward = causal, backward
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        query, key, value, out, lse = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(out)
        grads = flash_attention_bwd(query, key, value, out, lse, d_out, d_lse,
                                    causal=ctx.causal, backward=ctx.backward)
        return (*grads, None, None)


def flash_attention_lse(query, key, value, *, causal: bool = True,
                        backward: str = 'fused'):
    """Flash attention returning ``(out [B,S,Hq,D], lse [B,S,Hq] float32)``,
    differentiable in both outputs.

    ``key``/``value`` may carry fewer heads than ``query`` (GQA). On CUDA
    the kernels take bfloat16 and head dims in ``HEAD_DIMS``; any length.
    ``backward`` picks the gradient kernels: ``'fused'`` (K2b) or
    ``'split'`` (K3a + K3b)."""
    _check_shapes(query, key)
    _check_backward(backward)
    return _FlashAttention.apply(query, key, value, causal, backward)


def flash_attention(query, key, value, *, causal: bool = True,
                    backward: str = 'fused'):
    """:func:`flash_attention_lse` without the logsumexp."""
    return flash_attention_lse(query, key, value, causal=causal,
                               backward=backward)[0]


flash_attention_lse.launches = 0
flash_bwd_fused.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
