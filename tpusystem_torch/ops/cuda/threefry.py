"""Threefry draws on the card: hand-written CUDA for Hopper.

:func:`bernoulli_mask` draws ``jax.random.bernoulli(key, keep_prob, shape)``
bit for bit, the dropout keep mask; :func:`row_uniforms` draws the float32
uniforms in ``[tiny, 1)`` of the sampler's gumbel noise, one key a row
(``csrc/threefry.cu`` holds the design note). Neither replaces a Pallas
kernel: the reference's draws come from XLA. On a CPU device each takes its
plain PyTorch version (the integer ops of
:mod:`tpusystem_torch.ops.threefry`); on a CUDA device it launches its
kernel or raises. Each keeps a ``launches`` counter, and
:func:`row_uniforms_plain` counts its ``runs``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpusystem_torch.ops import threefry
from tpusystem_torch.ops.cuda._build import LIBRARIES


def bernoulli_mask_plain(key, keep_prob: float, shape, device=None):
    """The plain PyTorch keep mask:
    :func:`tpusystem_torch.ops.threefry.bernoulli`."""
    return threefry.bernoulli(key, keep_prob, shape, device)


def _library():
    lib = LIBRARIES.library('threefry')
    if not getattr(lib, '_typed', False):
        lib.threefry_bernoulli_mask.argtypes = [
            ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.threefry_bernoulli_mask.restype = ctypes.c_int
        lib.threefry_row_uniforms.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.threefry_row_uniforms.restype = ctypes.c_int
        lib._typed = True
    return lib


def bernoulli_mask(key, keep_prob: float, shape, device):
    """Boolean keep mask of ``shape`` on ``device``: True where the float32
    uniform of ``key`` at the element's flat index is below
    ``float32(keep_prob)``."""
    device = torch.device(device)
    if device.type == 'cpu':
        return bernoulli_mask_plain(key, keep_prob, shape, device)
    if device.type != 'cuda':
        raise ValueError(f'bernoulli_mask: device {device} is not supported '
                         '(CPU takes the plain version, CUDA the kernel)')
    k0, k1 = threefry.as_key(key)
    out = torch.empty(tuple(shape), dtype=torch.bool, device=device)
    count = math.prod(out.shape)
    if count == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().threefry_bernoulli_mask(
        k0, k1, keep_prob, ctypes.c_void_p(out.data_ptr()), count,
        ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f'bernoulli_mask: CUDA launch failed with error '
                           f'{err}')
    bernoulli_mask.launches += 1
    return out


bernoulli_mask.launches = 0


def row_uniforms_plain(keys, cols: int, stride: int = 0):
    """The plain PyTorch per-row uniforms:
    :func:`tpusystem_torch.ops.threefry.uniform_rows`."""
    row_uniforms_plain.runs += 1
    return threefry.uniform_rows(keys, cols, stride)


row_uniforms_plain.runs = 0


def row_uniforms(keys, cols: int, stride: int = 0):
    """Float32 ``[rows, cols]`` uniforms in ``[tiny, 1)`` on ``keys``'
    device: element ``(r, c)`` is the uniform of counter ``r * stride + c``
    under row ``r``'s key. ``keys`` is an int64 ``[rows, 2]`` tensor of
    32-bit words (:func:`tpusystem_torch.ops.threefry.key_tensor`)."""
    device = keys.device
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f'row_uniforms: keys {tuple(keys.shape)} '
                         f'{keys.dtype}, expected int64 [rows, 2]')
    if device.type == 'cpu':
        return row_uniforms_plain(keys, cols, stride)
    if device.type != 'cuda':
        raise ValueError(f'row_uniforms: device {device} is not supported '
                         '(CPU takes the plain version, CUDA the kernel)')
    rows = keys.shape[0]
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if rows == 0 or cols == 0:
        return out
    keys = keys.contiguous()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().threefry_row_uniforms(
        ctypes.c_void_p(keys.data_ptr()), rows, cols, stride,
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f'row_uniforms: CUDA launch failed with error '
                           f'{err}')
    row_uniforms.launches += 1
    return out


row_uniforms.launches = 0
