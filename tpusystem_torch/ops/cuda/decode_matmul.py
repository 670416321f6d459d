"""Decode-step weight-streaming matmuls: hand-written CUDA for Hopper.

The counterpart of :mod:`tpusystem.ops.pallas.decode_matmul`. One greedy
decode step at small batch streams every weight matrix once while its
``[B, dim]`` activation is a few KB, so both functions are bound by the
weight bytes (``csrc/decode_matmul.cu`` holds the design note):

* :func:`decode_matmul` — ``act(x @ w + bias)``, ``K`` split across a
  thread-block cluster of :data:`CLUSTER` blocks per 32-column tile: each
  block's weight slab brought in by TMA at its start and multiplied on the
  tensor cores, the partial tiles summed in rank order in the leading
  block's shared memory (TPU kernel ``_matmul_kernel``).
* :func:`decode_ffn` — the fc → GELU → proj chain in one launch whose
  ``[B, 4 * dim]`` hidden never reaches device memory: a cluster of
  :data:`CLUSTER` blocks per slab of hidden columns, every block's w1 and
  w2 slabs brought in by TMA at its start, both products on the tensor
  cores, the hidden slab passed between the cluster's blocks in their
  shared memory, and the slabs' float32 partials summed in slab order by
  the last block to take its share's ticket (TPU kernel ``_ffn_kernel``).

A weight is a bfloat16 matrix or, as in the reference, a
:class:`~tpusystem_torch.ops.precision.QuantizedLeaf` of int8 or float8 e4m3
values and float32 per-output-channel scales: the kernels stream the narrow
bytes, widen each tile on chip and apply the scale to the float32 sum
(:func:`~tpusystem_torch.ops.precision.qdot`'s arithmetic).

Each wrapper follows its tensor's device: a CPU tensor takes the plain
PyTorch version beside it (:func:`decode_matmul_plain`,
:func:`decode_ffn_plain`), a CUDA tensor launches the kernel or raises.
Each keeps a ``launches`` counter of kernel launches and, by weight type,
``mode_launches`` (``'bf16'``, ``'int8'``, ``'fp8'``). Accumulation is
float32; scale, bias and activation are applied to the float32 sum, which
is rounded once.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from tpusystem_torch.ops.cuda._build import LIBRARIES
from tpusystem_torch.ops.precision import QuantizedLeaf, qdot

ACTIVATIONS = (None, 'gelu')
# K4 splits K, and K5 each slab of hidden columns, across a cluster of this
# many blocks (8: the portable size); a size the card refuses makes the call
# raise
CLUSTER = 8
# K5's hidden columns a block: a cluster's slab is CLUSTER times as wide
SLAB_COLUMNS = 32
# the kernels' weight types, by the name of their entry points
MODES = {torch.bfloat16: 'bf16', torch.int8: 'int8',
         torch.float8_e4m3fn: 'fp8'}


def _split(w):
    """``(values, scales)`` of a weight: ``scales`` ``None`` for a plain
    matrix, the per-output-channel row of a :class:`QuantizedLeaf`."""
    if isinstance(w, QuantizedLeaf):
        return w.values, w.scales.reshape(-1)
    return w, None


def _activate(acc, activation):
    if activation is None:
        return acc
    if activation == 'gelu':
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(acc, approximate='tanh')
    raise ValueError(f'unknown activation {activation!r}; expected one of '
                     f'{ACTIVATIONS}')


def decode_matmul_plain(x, w, bias=None, *, activation=None):
    """Plain PyTorch ``activation(x @ w + bias)``: the product as
    :func:`~tpusystem_torch.ops.precision.qdot` takes it (the weight, or a
    :class:`QuantizedLeaf`'s values, cast to ``x``'s dtype, float32 sums,
    times the scales), bias and activation on the float32 sum, one
    rounding to ``x``'s dtype."""
    acc = qdot(x, w)
    if bias is not None:
        acc = acc + bias.float()
    return _activate(acc, activation).to(x.dtype)


def decode_ffn_plain(x, w1, b1, w2, b2, *, activation='gelu'):
    """Plain PyTorch ``activation(x @ w1 + b1) @ w2 + b2``, the hidden
    rounded to ``x``'s dtype before the second product (as the TPU kernel
    does), float32 accumulation, each product times its weight's scales
    when quantized (w1's before the bias and activation, w2's before b2),
    one rounding at the end."""
    mid = _activate(qdot(x, w1) + b1.float(), activation)
    acc = qdot(mid.to(x.dtype), w2)
    return (acc + b2.float()).to(x.dtype)


def _library():
    lib = LIBRARIES.library('decode_matmul')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_matmul_bf16.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.decode_ffn_bf16.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        for mode in ('int8', 'fp8'):
            getattr(lib, f'decode_matmul_{mode}').argtypes = (
                [ptr] * 5 + [i32] * 5 + [ptr])
            getattr(lib, f'decode_ffn_{mode}').argtypes = (
                [ptr] * 10 + [i32] * 5 + [ptr])
        for mode in MODES.values():
            getattr(lib, f'decode_matmul_{mode}').restype = i32
            getattr(lib, f'decode_ffn_{mode}').restype = i32
        lib.decode_max_rows.argtypes = [i32]
        lib.decode_max_rows.restype = i32
        lib._typed = True
    return lib


def _pointer(tensor):
    return None if tensor is None else ctypes.c_void_p(tensor.data_ptr())


def _check_cuda(name, x, weights) -> str:
    """Check the kernel's inputs; return the weights' mode (``'bf16'``,
    ``'int8'`` or ``'fp8'``)."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {x.device} are not supported '
                         '(CPU takes the plain version, CUDA the kernel)')
    if x.dim() != 2:
        raise ValueError(f'{name}: x must be [batch, features], got '
                         f'{tuple(x.shape)}')
    if x.dtype != torch.bfloat16:
        raise ValueError(f'{name}: the CUDA kernel takes bfloat16 '
                         f'activations, got {x.dtype}')
    return _weight_mode(name, x.device, weights)


def _weight_mode(name, device, weights) -> str:
    """The one mode of ``weights`` on ``device``: bfloat16 matrices, or
    :class:`QuantizedLeaf` s of int8 or float8 e4m3 values with a float32
    scale per output channel."""
    modes = set()
    for w in weights:
        values, scales = _split(w)
        quantized = scales is not None
        mode = MODES.get(values.dtype)
        if mode is None or quantized != (mode != 'bf16'):
            raise ValueError(f'{name}: the CUDA kernel takes bfloat16 weights '
                             'or a QuantizedLeaf of int8 / float8_e4m3fn '
                             f'values, got {values.dtype}'
                             + (' with scales' if quantized else ''))
        for tensor in (values,) + ((scales,) if quantized else ()):
            if tensor.device != device:
                raise ValueError(f'{name}: tensors on {tensor.device} and '
                                 f'{device}')
        if not values.is_contiguous() or values.data_ptr() % 16:
            raise ValueError(f'{name}: weights must be contiguous and 16-byte '
                             'aligned')
        if quantized and scales.numel() != values.shape[-1]:
            raise ValueError(f'{name}: {scales.numel()} scales for '
                             f'{values.shape[-1]} output channels')
        modes.add(mode)
    if len(modes) != 1:
        raise ValueError(f'{name}: weights of one type only, got {modes}')
    return modes.pop()


def _scales(w):
    """The float32 scale row of a quantized weight (``None`` for bf16)."""
    scales = _split(w)[1]
    return None if scales is None else scales.float().contiguous()


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


# K5's scratch by (device, stream): the slabs' float32 partials and one
# ticket counter a cluster rank. Launches on one stream run in order, so
# they share it; a launch on another stream has its own, so two in flight
# never share a counter; each launch leaves its counters 0. Past
# WORKSPACE_STREAMS streams the least recently used one's is let go: the
# caching allocator hands its memory only to later work on that stream,
# which runs after the launches that used it. A CUDA graph keeps the
# pointers it was captured with, so a capture would need a workspace of
# its own, held as long as the graph.
WORKSPACE_STREAMS = 8
_WORKSPACES: collections.OrderedDict = collections.OrderedDict()


def _workspace(device, stream: int, floats: int, ranks: int):
    partial, tickets = _WORKSPACES.pop((device, stream), (None, None))
    if partial is None or partial.numel() < floats:
        partial = torch.empty(floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < ranks:
        tickets = torch.zeros(ranks, dtype=torch.int32, device=device)
    _WORKSPACES[(device, stream)] = partial, tickets
    while len(_WORKSPACES) > WORKSPACE_STREAMS:
        _WORKSPACES.popitem(last=False)
    return partial, tickets


def _vector(mode: str) -> int:
    """Weight values per 16-byte load: the column multiple a kernel takes."""
    return 8 if mode == 'bf16' else 16


def decode_matmul(x, w, bias=None, *, activation=None):
    """``activation(x @ w + bias)`` for decode: ``x`` ``[B, K]``, ``w``
    ``[K, N]`` (flax layout), bfloat16 or a :class:`QuantizedLeaf` (its
    scales multiply the float32 sum before the bias), ``bias`` ``[N]``
    applied in float32, ``activation`` ``None`` or ``'gelu'`` (tanh).
    Returns ``[B, N]``.

    On CUDA: bfloat16 ``x``; ``N`` a multiple of 8 (bf16) or 16 (int8 and
    fp8); batches over 16 rows (8 with narrow weights) launch once per
    slice; a cluster launch the card refuses raises ``RuntimeError``."""
    if x.device.type == 'cpu':
        return decode_matmul_plain(x, w, bias, activation=activation)
    if activation not in ACTIVATIONS:
        raise ValueError(f'unknown activation {activation!r}; expected one '
                         f'of {ACTIVATIONS}')
    mode = _check_cuda('decode_matmul', x, (w,))
    values = _split(w)[0]
    (batch, inner), (inner_w, cols) = x.shape, values.shape
    if inner != inner_w:
        raise ValueError(f'x cols {inner} != w rows {inner_w}')
    if cols % _vector(mode):
        raise ValueError(f'decode_matmul: {cols} output columns, the CUDA '
                         f'kernel needs a multiple of {_vector(mode)}')
    lib = _library()
    x = x.contiguous()
    bias = _bias(bias, cols, x.device)
    scales = _scales(w)
    out = torch.empty((batch, cols), dtype=torch.bfloat16, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    kernel = getattr(lib, f'decode_matmul_{mode}')
    step = lib.decode_max_rows(values.element_size())
    for start in range(0, batch, step):
        rows = min(step, batch - start)
        weights = ((_pointer(values),) if scales is None
                   else (_pointer(values), _pointer(scales)))
        err = kernel(_pointer(x[start:start + rows]), *weights,
                     _pointer(bias), _pointer(out[start:start + rows]), rows,
                     inner, cols, int(activation == 'gelu'), CLUSTER, stream)
        _raise_on(err, 'decode_matmul')
        decode_matmul.launches += 1
        decode_matmul.mode_launches[mode] += 1
    return out


def decode_ffn(x, w1, b1, w2, b2, *, activation='gelu'):
    """The fused FFN chain ``activation(x @ w1 + b1) @ w2 + b2``: ``x``
    ``[B, K]``, ``w1`` ``[K, H]``, ``w2`` ``[H, N]`` (both bfloat16, or both
    :class:`QuantizedLeaf` s: w1's scales multiply the hidden sums before
    ``b1`` and the activation, w2's the output sums before ``b2``), biases
    float32.

    On CUDA, one launch per 16 rows (bf16) or 8 rows (int8 and fp8): each
    cluster of :data:`CLUSTER` blocks takes a slab of hidden columns,
    keeps its hidden activation on chip and writes a float32 partial of
    the output; the last block to take its columns' ticket sums the slabs'
    partials in slab order, applies w2's scales to the full sum, then
    ``b2``, and rounds once, so a repeat gives the same bits. The partials
    and the ticket counters are kept per stream. It takes bfloat16 ``x``,
    ``activation='gelu'``, ``H`` and ``N`` multiples of 8 (bf16) or 16
    (int8 and fp8), and ``K`` up to about 6,100 (bf16 at 9-16 rows), 12,200
    (bf16 at up to 8) or 11,700 (int8 and fp8), where x's rows still fit a
    block beside one weight box; a shape past that, or a launch the card
    refuses, raises ``RuntimeError``."""
    if x.device.type == 'cpu':
        return decode_ffn_plain(x, w1, b1, w2, b2, activation=activation)
    if activation != 'gelu':
        raise ValueError("decode_ffn: the CUDA kernel implements "
                         f"activation='gelu' only, got {activation!r}")
    mode = _check_cuda('decode_ffn', x, (w1, w2))
    v1, v2 = _split(w1)[0], _split(w2)[0]
    (batch, inner), (inner_w, hidden) = x.shape, v1.shape
    hidden_w, cols = v2.shape
    if inner != inner_w or hidden != hidden_w:
        raise ValueError(f'chain shapes do not compose: x {tuple(x.shape)}, '
                         f'w1 {tuple(v1.shape)}, w2 {tuple(v2.shape)}')
    if hidden % _vector(mode) or cols % _vector(mode):
        raise ValueError('decode_ffn: the CUDA kernel needs hidden and output '
                         f'widths that are multiples of {_vector(mode)}, got '
                         f'{hidden}, {cols}')
    if b1 is None or b2 is None:
        raise ValueError('decode_ffn: both biases are required')
    lib = _library()
    x = x.contiguous()
    b1, b2 = _bias(b1, hidden, x.device), _bias(b2, cols, x.device)
    s1, s2 = _scales(w1), _scales(w2)
    out = torch.empty((batch, cols), dtype=torch.bfloat16, device=x.device)
    handle = torch.cuda.current_stream(x.device).cuda_stream
    stream = ctypes.c_void_p(handle)
    kernel = getattr(lib, f'decode_ffn_{mode}')
    step = lib.decode_max_rows(v1.element_size())
    slabs = -(-hidden // (CLUSTER * SLAB_COLUMNS))
    partial, tickets = _workspace(x.device, handle, slabs * step * cols,
                                  CLUSTER)
    for start in range(0, batch, step):
        rows = min(step, batch - start)
        if mode == 'bf16':
            weights = (_pointer(v1), _pointer(b1), _pointer(v2),
                       _pointer(b2))
        else:
            weights = (_pointer(v1), _pointer(s1), _pointer(b1), _pointer(v2),
                       _pointer(s2), _pointer(b2))
        err = kernel(_pointer(x[start:start + rows]), *weights,
                     _pointer(partial), _pointer(tickets),
                     _pointer(out[start:start + rows]), rows, inner, hidden,
                     cols, CLUSTER, stream)
        _raise_on(err, 'decode_ffn')
        decode_ffn.launches += 1
        decode_ffn.mode_launches[mode] += 1
    return out


def reset_launches() -> None:
    """Set both kernels' counters, overall and by weight type, to 0."""
    for kernel in (decode_matmul, decode_ffn):
        kernel.launches = 0
        kernel.mode_launches = dict.fromkeys(MODES.values(), 0)


reset_launches()
