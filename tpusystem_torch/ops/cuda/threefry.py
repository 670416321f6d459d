"""The dropout keep mask: hand-written CUDA for Hopper.

:func:`bernoulli_mask` draws ``jax.random.bernoulli(key, keep_prob, shape)``
bit for bit (``csrc/threefry.cu`` holds the design note). It replaces no
Pallas kernel: the reference's masks come from XLA. On a CPU device it
takes the plain PyTorch version (:func:`bernoulli_mask_plain`, the integer
ops of :mod:`tpusystem_torch.ops.threefry`); on a CUDA device it launches
the kernel or raises. It keeps a ``launches`` counter.
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
