"""Grouped gather-matmul and matmul-scatter: hand-written CUDA for Hopper.

The counterpart of :mod:`tpusystem.ops.pallas.grouped_matmul`, the two
kernels of the fused MoE path (``csrc/grouped_matmul.cu`` holds the design
note):

* :func:`gather_rows_matmul` (K6) — ``out[j] = (row_scale[j] *
  src[row_ids[j]]) @ rhs[j // rows_per_group]``: the dispatch rides the
  up-projection's loads, so the ``[groups * C, K]`` dispatch buffer never
  forms.
* :func:`matmul_scatter_rows` (K7) — ``row[j] = lhs[j] @ rhs[j //
  rows_per_group] (+ bias)`` and ``out[row_ids[j]] += row_scale[j] *
  row[j]``: the weighted k-way combine follows the down-projection. On the
  card it is a second, deterministic pass over each token's rows in
  ascending row order (the reference's grid order), through the index
  :func:`combine_index` builds with a stable integer sort.

Both take ``transpose_rhs``, which reads ``rhs[g]`` as ``[m, k]`` in place:
the MoE backward reuses the kernels with swapped operands. Row ids use the
output length as the sentinel: K6 gets them pre-clamped and masks empty
slots with scale 0; K7 drops sentinel rows.

Each wrapper follows its tensors' device: a CPU tensor takes the plain
PyTorch version (:func:`gather_rows_matmul_plain`,
:func:`matmul_scatter_rows_plain`), a CUDA tensor launches the kernel or
raises. ``gather_rows_matmul.launches`` and ``matmul_scatter_rows.launches``
count launches (K7's GEMM and combine passes count as one). Products
accumulate in float32 and round once to the input dtype; K6 scales its
gathered rows in that dtype before the product, K7 adds the bias to the
float32 sum and rounds the scaled rows and every add of the combine to it,
as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from tpusystem_torch.ops.cuda._build import LIBRARIES


def _operands(rhs, transpose_rhs: bool):
    """``(groups, contraction, out columns)`` of ``rhs`` and its ``[groups,
    contraction, out]`` view (a transposed view, never a copy)."""
    if transpose_rhs:
        return rhs.shape[0], rhs.shape[2], rhs.shape[1], rhs.transpose(1, 2)
    return rhs.shape[0], rhs.shape[1], rhs.shape[2], rhs


def _check_rows(name, rows, contraction, row_ids, row_scale, groups,
                rows_per_group):
    if rows.dim() != 2 or rows.shape[1] != contraction:
        raise ValueError(f'{name}: rows {tuple(rows.shape)} do not match the '
                         f'rhs contraction dim {contraction}')
    buffer_rows = groups * rows_per_group
    for label, tensor in (('row_ids', row_ids), ('row_scale', row_scale)):
        if tuple(tensor.shape) != (buffer_rows,):
            raise ValueError(f'{name}: {label} {tuple(tensor.shape)}, '
                             f'expected ({buffer_rows},)')


def gather_rows_matmul_plain(src, rhs, row_ids, row_scale, *,
                             rows_per_group: int,
                             transpose_rhs: bool = False):
    """Plain PyTorch K6: gather ``src`` rows (ids clamped), scale them in
    ``src``'s dtype, one float32 product per group, one rounding."""
    groups, _, cols, weights = _operands(rhs, transpose_rhs)
    ids = row_ids.long().clamp(0, src.shape[0] - 1)
    rows = src[ids] * row_scale.to(src.dtype)[:, None]
    product = torch.matmul(rows.reshape(groups, rows_per_group, -1).float(),
                           weights.float())
    return product.to(src.dtype).reshape(groups * rows_per_group, cols)


def combine_index(row_ids, tokens: int):
    """``(order, starts)``: the rows sorted stably by token, and each token's
    first position in that order (``starts[tokens]`` = rows seated; sentinel
    rows lie past it)."""
    sorted_ids, order = torch.sort(row_ids.long(), stable=True)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(tokens + 1, device=row_ids.device))
    return order, starts


def combine_rows_plain(rows, row_ids, row_scale, tokens: int):
    """Plain K7 combine: ``out[t]`` sums ``row_scale[j] * rows[j]`` over
    t's rows in ascending ``j`` from zero, every product and add in
    ``rows``' dtype."""
    weighted = rows * row_scale.to(rows.dtype)[:, None]
    order, starts = combine_index(row_ids, tokens)
    counts = starts[1:] - starts[:-1]
    out = rows.new_zeros((tokens, rows.shape[1]))
    for level in range(int(counts.max())):
        seated = torch.nonzero(counts > level)[:, 0]
        out[seated] = out[seated] + weighted[order[starts[seated] + level]]
    return out


def matmul_scatter_rows_plain(lhs, rhs, bias, row_ids, row_scale,
                              tokens: int, *, rows_per_group: int,
                              transpose_rhs: bool = False,
                              save_rows: bool = True):
    """Plain PyTorch K7: float32 product per group, the bias added to the
    float32 sum, one rounding to ``lhs``'s dtype, then
    :func:`combine_rows_plain`. Returns ``(out, rows | None)``."""
    groups, _, cols, weights = _operands(rhs, transpose_rhs)
    acc = torch.matmul(lhs.reshape(groups, rows_per_group, -1).float(),
                       weights.float())
    if bias is not None:
        acc = acc + bias.float()[:, None]
    rows = acc.to(lhs.dtype).reshape(groups * rows_per_group, cols)
    out = combine_rows_plain(rows, row_ids, row_scale, tokens)
    return out, (rows if save_rows else None)


def _library():
    lib = LIBRARIES.library('grouped_matmul')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.grouped_gather_matmul_bf16.argtypes = [ptr] * 5 + [i32] * 6 + [
            ptr]
        lib.grouped_gather_matmul_bf16.restype = i32
        lib.grouped_matmul_rows_bf16.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.grouped_matmul_rows_bf16.restype = i32
        lib.combine_rows_bf16.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
        lib.combine_rows_bf16.restype = i32
        lib._typed = True
    return lib


def _pointer(tensor):
    return None if tensor is None else ctypes.c_void_p(tensor.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(name, tensors, device) -> None:
    if device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {device} are not supported '
                         '(CPU takes the plain version, CUDA the kernel)')
    for tensor in tensors:
        if tensor.dtype != torch.bfloat16 or tensor.device != device:
            raise ValueError(f'{name}: the CUDA kernel takes bfloat16 '
                             'operands on one device')


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


def gather_rows_matmul(src, rhs, row_ids, row_scale, *, rows_per_group: int,
                       transpose_rhs: bool = False):
    """K6, fused gather + grouped matmul: ``out[j] = (row_scale[j] *
    src[row_ids[j]]) @ rhs[j // rows_per_group]``.

    Args:
        src: ``[n, k]`` token rows, read in place by ``row_ids``.
        rhs: ``[groups, k, m]`` stacked weights (``[groups, m, k]`` with
            ``transpose_rhs``).
        row_ids: ``[groups * rows_per_group]`` int source row per output
            row, pre-clamped to ``[0, n)``.
        row_scale: ``[groups * rows_per_group]`` float per-row factor (0
            masks an empty slot), applied in ``src``'s dtype.
        rows_per_group: rows per group (the expert capacity).

    Returns ``[groups * rows_per_group, m]`` in ``src``'s dtype. On CUDA the
    operands are bfloat16."""
    groups, contraction, cols, _ = _operands(rhs, transpose_rhs)
    _check_rows('gather_rows_matmul', src, contraction, row_ids, row_scale,
                groups, rows_per_group)
    if src.device.type == 'cpu':
        return gather_rows_matmul_plain(src, rhs, row_ids, row_scale,
                                        rows_per_group=rows_per_group,
                                        transpose_rhs=transpose_rhs)
    _check_cuda('gather_rows_matmul', (src, rhs), src.device)
    src, rhs = src.contiguous(), rhs.contiguous()
    ids = row_ids.to(torch.int32).contiguous()
    scale = row_scale.float().contiguous()
    out = torch.empty((groups * rows_per_group, cols), dtype=torch.bfloat16,
                      device=src.device)
    err = _library().grouped_gather_matmul_bf16(
        _pointer(src), _pointer(ids), _pointer(scale), _pointer(rhs),
        _pointer(out), groups, rows_per_group, contraction, cols,
        src.shape[0], int(transpose_rhs), _stream(src.device))
    _raise_on(err, 'gather_rows_matmul')
    gather_rows_matmul.launches += 1
    return out


def _matmul_rows(lhs, rhs, bias, *, rows_per_group: int,
                 transpose_rhs: bool = False):
    """K7's first pass on the card: ``rows[j] = bf16(lhs[j] @ rhs[j //
    rows_per_group] + bias)``, one launch of the grouped product. Counts
    no launch (:func:`matmul_scatter_rows` does)."""
    groups, contraction, cols, _ = _operands(rhs, transpose_rhs)
    _check_cuda('matmul_scatter_rows', (lhs, rhs), lhs.device)
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    rows = torch.empty((groups * rows_per_group, cols), dtype=torch.bfloat16,
                       device=lhs.device)
    err = _library().grouped_matmul_rows_bf16(
        _pointer(lhs), _pointer(rhs), _pointer(bias), _pointer(rows), groups,
        rows_per_group, contraction, cols, int(transpose_rhs),
        _stream(lhs.device))
    _raise_on(err, 'matmul_scatter_rows (grouped matmul)')
    return rows


def _combine_rows(rows, row_scale, index, tokens: int):
    """K7's second pass on the card: the ordered combine of ``rows`` into
    ``[tokens, m]`` through ``index``, :func:`combine_index`'s ``(order,
    starts)``. Counts no launch."""
    scale = row_scale.float().contiguous()
    order, starts = (t.to(torch.int32).contiguous() for t in index)
    out = torch.empty((tokens, rows.shape[1]), dtype=torch.bfloat16,
                      device=rows.device)
    err = _library().combine_rows_bf16(
        _pointer(rows), _pointer(scale), _pointer(order), _pointer(starts),
        _pointer(out), tokens, rows.shape[1], _stream(rows.device))
    _raise_on(err, 'matmul_scatter_rows (combine)')
    return out


def matmul_scatter_rows(lhs, rhs, bias, row_ids, row_scale, tokens: int, *,
                        rows_per_group: int, transpose_rhs: bool = False,
                        save_rows: bool = True):
    """K7, grouped matmul + weighted scatter-combine: ``row[j] = lhs[j] @
    rhs[j // rows_per_group] (+ bias)``, ``out[row_ids[j]] += row_scale[j]
    * row[j]``.

    Args:
        lhs: ``[groups * rows_per_group, k]`` expert-major buffer rows.
        rhs: ``[groups, k, m]`` (``[groups, m, k]`` with ``transpose_rhs``).
        bias: ``[groups, m]`` or ``None``.
        row_ids: ``[groups * rows_per_group]`` int destination token per
            row; ``tokens`` (the sentinel) drops the row.
        row_scale: ``[groups * rows_per_group]`` float combine weight.
        tokens: output rows.
        save_rows: also return the finished (biased, unweighted) rows.

    Returns ``(out [tokens, m], rows [groups * rows_per_group, m] | None)``
    in ``lhs``'s dtype. On CUDA the operands are bfloat16; the rows pass
    through device memory between the GEMM and the combine either way."""
    groups, contraction, cols, _ = _operands(rhs, transpose_rhs)
    _check_rows('matmul_scatter_rows', lhs, contraction, row_ids, row_scale,
                groups, rows_per_group)
    if lhs.shape[0] != groups * rows_per_group:
        raise ValueError(f'matmul_scatter_rows: lhs has {lhs.shape[0]} rows, '
                         f'expected {groups * rows_per_group}')
    if bias is not None and tuple(bias.shape) != (groups, cols):
        raise ValueError(f'matmul_scatter_rows: bias {tuple(bias.shape)}, '
                         f'expected ({groups}, {cols})')
    if lhs.device.type == 'cpu':
        return matmul_scatter_rows_plain(
            lhs, rhs, bias, row_ids, row_scale, tokens,
            rows_per_group=rows_per_group, transpose_rhs=transpose_rhs,
            save_rows=save_rows)
    rows = _matmul_rows(lhs, rhs, bias, rows_per_group=rows_per_group,
                        transpose_rhs=transpose_rhs)
    out = _combine_rows(rows, row_scale, combine_index(row_ids, tokens),
                        tokens)
    matmul_scatter_rows.launches += 1
    return out, (rows if save_rows else None)


gather_rows_matmul.launches = 0
matmul_scatter_rows.launches = 0
