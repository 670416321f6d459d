"""ctypes bindings for the native batch-assembly core: the port of
:mod:`tpusystem.data.native`.

Builds ``batcher.cpp`` (a copy of the reference's) with the system C++
toolchain on first use, into ``build/`` beside it (git-ignored), keyed by
a source digest, and degrades to pure numpy when no toolchain is available
(or ``TPUSYSTEM_NO_NATIVE`` is set, as for the reference): the native path
is a bandwidth upgrade (a multithreaded row gather with the GIL released)
for host-side batch assembly, never a requirement.

Use :func:`gather` directly, or let
:class:`tpusystem_torch.data.ArrayDataset` and
:class:`~tpusystem_torch.data.MemmapTokens` pick it up. Results are
bit-identical to numpy fancy indexing; batch *order* never depends on
availability (shuffle stays in numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SOURCE = pathlib.Path(__file__).with_name('batcher.cpp')
BUILD_DIR = pathlib.Path(__file__).with_name('build')
_ABI = 2
_lib: ctypes.CDLL | None | bool = False   # False = not tried yet


def _build() -> ctypes.CDLL | None:
    source = _SOURCE.read_bytes()
    digest = hashlib.md5(source).hexdigest()[:16]
    target = BUILD_DIR / f'batcher-{digest}.so'
    if not target.exists():
        try:
            target.parent.mkdir(parents=True, exist_ok=True)
            # mkstemp: each concurrent build gets its own fd-backed scratch
            # path, so two builds never publish a torn .so
            fd, scratch = tempfile.mkstemp(dir=target.parent, suffix='.so')
            os.close(fd)
            os.chmod(scratch, 0o644)
            subprocess.run(
                ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-pthread',
                 str(_SOURCE), '-o', scratch],
                check=True, capture_output=True, timeout=120)
            os.replace(scratch, target)   # atomic under concurrent builds
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(target))
        lib.ts_abi_version.restype = ctypes.c_int
        if lib.ts_abi_version() != _ABI:
            return None
        lib.ts_gather_rows.restype = None
        lib.ts_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        lib.ts_gather_windows.restype = None
        lib.ts_gather_windows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        return lib
    except OSError:
        return None


def library() -> ctypes.CDLL | None:
    """The loaded native library, building it on first call; None when the
    toolchain is unavailable (callers fall back to numpy)."""
    global _lib
    if _lib is False:
        _lib = None if os.environ.get('TPUSYSTEM_NO_NATIVE') else _build()
    return _lib


def available() -> bool:
    return library() is not None


def gather(array: np.ndarray, indices: np.ndarray,
           out: np.ndarray | None = None, threads: int = 0) -> np.ndarray:
    """``array[indices]`` via the native multithreaded row gather.

    Falls back to numpy fancy indexing when the native library is missing
    or the array layout is not row-gatherable (non-contiguous rows).
    Bit-identical to ``array[indices]`` either way.
    """
    lib = library()
    indices = np.asarray(indices)
    # The C side is a raw memcpy over int64 row numbers. Everything with
    # different semantics — boolean masks, float indices, negative or
    # out-of-range values, multi-dim index arrays, non-row-contiguous or
    # object arrays — keeps exact numpy behavior via numpy itself.
    native_ok = (
        lib is not None and array.ndim >= 1 and indices.ndim == 1
        and indices.dtype.kind in 'iu'
        and array.flags.c_contiguous and not array.dtype.hasobject
        and (len(indices) == 0
             or (int(indices.min()) >= 0 and int(indices.max()) < len(array))))
    expected_shape = ((len(indices),) + array.shape[1:] if indices.ndim == 1
                      else None)
    if native_ok and out is not None:
        # a caller-supplied buffer is written as raw bytes: only accept it
        # when that is exactly equivalent to numpy's element-wise copy —
        # including not aliasing the source (the raw memcpy reads rows the
        # previous row's write may already have clobbered)
        native_ok = (out.shape == expected_shape and out.dtype == array.dtype
                     and out.flags.c_contiguous
                     and not np.shares_memory(out, array))
    if not native_ok:
        fallback = array[indices]
        if out is None:
            return fallback
        np.copyto(out, fallback)
        return out
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if out is None:
        out = np.empty(expected_shape, array.dtype)
    row_bytes = array.dtype.itemsize * int(np.prod(array.shape[1:],
                                                   dtype=np.int64))
    lib.ts_gather_rows(
        array.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        len(indices), row_bytes, threads)
    return out


def gather_windows(array: np.ndarray, starts: np.ndarray, window: int,
                   threads: int = 0) -> np.ndarray:
    """Gather ``[len(starts), window]`` element windows from a flat array.

    The LM-corpus hot path: ``array`` is typically a read-only memmap of
    token ids and ``starts`` the (possibly overlapping) sample offsets —
    each window is one contiguous memcpy straight from the page cache,
    multithreaded with the GIL released, instead of numpy's per-element
    fancy indexing over a ``[batch, window]`` position matrix. Falls back
    to equivalent numpy indexing when the native library is missing or the
    inputs are not window-gatherable. Bit-identical either way.
    """
    lib = library()
    starts = np.asarray(starts)
    native_ok = (
        lib is not None and array.ndim == 1 and window > 0
        and starts.ndim == 1 and starts.dtype.kind in 'iu'
        and array.flags.c_contiguous and not array.dtype.hasobject
        and (len(starts) == 0
             or (int(starts.min()) >= 0
                 and int(starts.max()) + window <= len(array))))
    if not native_ok:
        positions = (np.asarray(starts, np.int64)[:, None]
                     + np.arange(window)[None, :])
        return array[positions]
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    byte_starts = starts * array.dtype.itemsize
    out = np.empty((len(starts), window), array.dtype)
    lib.ts_gather_windows(
        array.ctypes.data_as(ctypes.c_void_p),
        byte_starts.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        len(starts), window * array.dtype.itemsize, threads)
    return out
