"""Flash-attention forward: a hand-written CUDA kernel for Hopper.

The counterpart of the forward half of :mod:`tpusystem.ops.pallas.flash`
(``_flash_fwd_kernel``): causal online-softmax attention over
``[batch, length, heads, head_dim]`` tensors that returns the output and the
float32 logsumexp ``[batch, length, heads]``, with grouped-query attention
mapping query head ``h`` to kv head ``h // group``. ``csrc/flash_fwd.cu``
holds the design note. The backward kernels and the in-kernel dropout hash
are not ported yet.

:func:`flash_attention_lse` follows its tensors' device: a CPU tensor takes
:func:`flash_attention_plain`, a CUDA tensor launches the kernel or raises.
``flash_attention_lse.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpusystem_torch.ops.cuda._build import LIBRARIES

NEG_INF = -1e30
TILE = 64          # kv rows per online-softmax step, as in the CUDA kernel
HEAD_DIMS = (16, 32, 64)


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


def _library():
    lib = LIBRARIES.library('flash_fwd')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_bf16.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, i32, ctypes.c_float, i32, ptr]
        lib.flash_fwd_bf16.restype = i32
        lib._typed = True
    return lib


def flash_attention_lse(query, key, value, *, causal: bool = True):
    """Flash attention returning ``(out [B,S,Hq,D], lse [B,S,Hq] float32)``.

    ``key``/``value`` may carry fewer heads than ``query`` (GQA). On CUDA
    the kernel takes bfloat16 and head dims in ``HEAD_DIMS``; any length."""
    batch, seq, q_heads, head_dim = query.shape
    kv_heads = key.shape[2]
    if q_heads % kv_heads:
        raise ValueError(f'query heads ({q_heads}) must be a multiple of KV '
                         f'heads ({kv_heads}) for grouped-query attention')
    if key.shape[1] != seq:
        raise ValueError('flash_attention takes self-attention: query and '
                         f'key lengths differ ({seq} vs {key.shape[1]})')
    if query.device.type == 'cpu':
        return flash_attention_plain(query, key, value, causal=causal)
    if query.device.type != 'cuda':
        raise ValueError(f'flash_attention: tensors on {query.device} are not '
                         'supported')
    for tensor in (query, key, value):
        if tensor.dtype != torch.bfloat16 or tensor.device != query.device:
            raise ValueError('flash_attention: the CUDA kernel takes bfloat16 '
                             'tensors on one device')
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'flash_attention: head_dim {head_dim} not in '
                         f'{HEAD_DIMS}')
    if batch * q_heads > 65535:
        raise ValueError('flash_attention: batch * heads over 65535')
    query, key, value = (t.contiguous() for t in (query, key, value))
    out = torch.empty_like(query)
    lse = torch.empty((batch, seq, q_heads), dtype=torch.float32,
                      device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    pointer = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _library().flash_fwd_bf16(
        pointer(query), pointer(key), pointer(value), pointer(out),
        pointer(lse), batch, seq, q_heads, kv_heads, head_dim,
        head_dim ** -0.5, int(causal), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f'flash_attention: CUDA launch failed with error '
                           f'{err}')
    flash_attention_lse.launches += 1
    return out, lse


def flash_attention(query, key, value, *, causal: bool = True):
    """:func:`flash_attention_lse` without the logsumexp."""
    return flash_attention_lse(query, key, value, causal=causal)[0]


flash_attention_lse.launches = 0
