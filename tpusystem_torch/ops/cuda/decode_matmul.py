"""Decode-step weight-streaming matmuls: hand-written CUDA for Hopper.

The counterpart of :mod:`tpusystem.ops.pallas.decode_matmul`. One greedy
decode step at small batch streams every weight matrix once while its
``[B, dim]`` activation is a few KB, so both functions are bound by the
weight bytes (``csrc/decode_matmul.cu`` holds the design note):

* :func:`decode_matmul` — ``act(x @ w + bias)`` with ``x`` staged in shared
  memory and ``w`` streamed in column tiles (TPU kernel ``_matmul_kernel``).
* :func:`decode_ffn` — the fc → GELU → proj chain in one pass whose
  ``[B, 4 * dim]`` hidden never reaches device memory (TPU kernel
  ``_ffn_kernel``).

Each wrapper follows its tensor's device: a CPU tensor takes the plain
PyTorch version beside it (:func:`decode_matmul_plain`,
:func:`decode_ffn_plain`), a CUDA tensor launches the kernel or raises.
Each keeps a ``launches`` counter of kernel launches. Accumulation is
float32; bias and activation are applied to the float32 sum and rounded once.
The int8/fp8 in-kernel dequantization of the TPU kernels is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpusystem_torch.ops.cuda._build import LIBRARIES

ACTIVATIONS = (None, 'gelu')


def _activate(acc, activation):
    if activation is None:
        return acc
    if activation == 'gelu':
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(acc, approximate='tanh')
    raise ValueError(f'unknown activation {activation!r}; expected one of '
                     f'{ACTIVATIONS}')


def decode_matmul_plain(x, w, bias=None, *, activation=None):
    """Plain PyTorch ``activation(x @ w + bias)``: the weight cast to
    ``x``'s dtype, the product accumulated in float32, bias and activation
    on the float32 sum, one rounding to ``x``'s dtype."""
    acc = torch.matmul(x.float(), w.to(x.dtype).float())
    if bias is not None:
        acc = acc + bias.float()
    return _activate(acc, activation).to(x.dtype)


def decode_ffn_plain(x, w1, b1, w2, b2, *, activation='gelu'):
    """Plain PyTorch ``activation(x @ w1 + b1) @ w2 + b2``, the hidden
    rounded to ``x``'s dtype before the second product (as the TPU kernel
    does), float32 accumulation, one rounding at the end."""
    mid = torch.matmul(x.float(), w1.to(x.dtype).float())
    mid = _activate(mid + b1.float(), activation)
    acc = torch.matmul(mid.to(x.dtype).float(), w2.to(x.dtype).float())
    return (acc + b2.float()).to(x.dtype)


def _library():
    lib = LIBRARIES.library('decode_matmul')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_matmul_bf16.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i32, ptr]
        lib.decode_matmul_bf16.restype = i32
        lib.decode_ffn_bf16.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, ptr]
        lib.decode_ffn_bf16.restype = i32
        lib.decode_ffn_splits.argtypes = [i32]
        lib.decode_ffn_splits.restype = i32
        lib.decode_max_rows.argtypes = []
        lib.decode_max_rows.restype = i32
        lib._typed = True
    return lib


def _pointer(tensor):
    return None if tensor is None else ctypes.c_void_p(tensor.data_ptr())


def _check_cuda(name, x, weights):
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {x.device} are not supported '
                         '(CPU takes the plain version, CUDA the kernel)')
    if x.dim() != 2:
        raise ValueError(f'{name}: x must be [batch, features], got '
                         f'{tuple(x.shape)}')
    for w in (x, *weights):
        if w.dtype != torch.bfloat16:
            raise ValueError(f'{name}: the CUDA kernel takes bfloat16 '
                             f'activations and weights, got {w.dtype}')
        if w.device != x.device:
            raise ValueError(f'{name}: tensors on {w.device} and {x.device}')
    for w in weights:
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f'{name}: weights must be contiguous and 16-byte '
                             'aligned')


def _bias(bias, cols, device):
    if bias is None:
        return None
    if bias.shape != (cols,):
        raise ValueError(f'bias {tuple(bias.shape)} does not match {cols} '
                         'output columns')
    return bias.to(device=device, dtype=torch.float32).contiguous()


def _raise_on(err, name):
    if err:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


def decode_matmul(x, w, bias=None, *, activation=None):
    """``activation(x @ w + bias)`` for decode: ``x`` ``[B, K]``, ``w``
    ``[K, N]`` (flax layout), ``bias`` ``[N]`` applied in float32,
    ``activation`` ``None`` or ``'gelu'`` (tanh). Returns ``[B, N]``.

    On CUDA: bfloat16 ``x`` and ``w`` only, ``N`` a multiple of 8; batches
    over 16 rows launch once per 16-row slice."""
    if x.device.type == 'cpu':
        return decode_matmul_plain(x, w, bias, activation=activation)
    if activation not in ACTIVATIONS:
        raise ValueError(f'unknown activation {activation!r}; expected one '
                         f'of {ACTIVATIONS}')
    _check_cuda('decode_matmul', x, (w,))
    (batch, inner), (inner_w, cols) = x.shape, w.shape
    if inner != inner_w:
        raise ValueError(f'x cols {inner} != w rows {inner_w}')
    if cols % 8:
        raise ValueError(f'decode_matmul: {cols} output columns, the CUDA '
                         'kernel needs a multiple of 8')
    lib = _library()
    x = x.contiguous()
    bias = _bias(bias, cols, x.device)
    out = torch.empty((batch, cols), dtype=torch.bfloat16, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    step = lib.decode_max_rows()
    for start in range(0, batch, step):
        rows = min(step, batch - start)
        err = lib.decode_matmul_bf16(
            _pointer(x[start:start + rows]), _pointer(w), _pointer(bias),
            _pointer(out[start:start + rows]), rows, inner, cols,
            int(activation == 'gelu'), stream)
        _raise_on(err, 'decode_matmul')
        decode_matmul.launches += 1
    return out


def decode_ffn(x, w1, b1, w2, b2, *, activation='gelu'):
    """The fused FFN chain ``activation(x @ w1 + b1) @ w2 + b2``: ``x``
    ``[B, K]``, ``w1`` ``[K, H]``, ``w2`` ``[H, N]``, biases float32. The
    CUDA kernel splits the hidden dimension over blocks and sums their
    float32 partials in a second, deterministic pass; it takes bfloat16,
    ``activation='gelu'``, and ``H`` and ``N`` multiples of 8."""
    if x.device.type == 'cpu':
        return decode_ffn_plain(x, w1, b1, w2, b2, activation=activation)
    if activation != 'gelu':
        raise ValueError("decode_ffn: the CUDA kernel implements "
                         f"activation='gelu' only, got {activation!r}")
    _check_cuda('decode_ffn', x, (w1, w2))
    (batch, inner), (inner_w, hidden) = x.shape, w1.shape
    hidden_w, cols = w2.shape
    if inner != inner_w or hidden != hidden_w:
        raise ValueError(f'chain shapes do not compose: x {tuple(x.shape)}, '
                         f'w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}')
    if hidden % 8 or cols % 8:
        raise ValueError('decode_ffn: the CUDA kernel needs hidden and output '
                         f'widths that are multiples of 8, got {hidden}, '
                         f'{cols}')
    if b1 is None or b2 is None:
        raise ValueError('decode_ffn: both biases are required')
    lib = _library()
    x = x.contiguous()
    b1, b2 = _bias(b1, hidden, x.device), _bias(b2, cols, x.device)
    out = torch.empty((batch, cols), dtype=torch.bfloat16, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    step = lib.decode_max_rows()
    splits = lib.decode_ffn_splits(hidden)
    for start in range(0, batch, step):
        rows = min(step, batch - start)
        partial = torch.empty((splits, rows, cols), dtype=torch.float32,
                              device=x.device)
        err = lib.decode_ffn_bf16(
            _pointer(x[start:start + rows]), _pointer(w1), _pointer(b1),
            _pointer(w2), _pointer(b2), _pointer(partial),
            _pointer(out[start:start + rows]), rows, inner, hidden, cols,
            stream)
        _raise_on(err, 'decode_ffn')
        decode_ffn.launches += 1
    return out


decode_matmul.launches = 0
decode_ffn.launches = 0
