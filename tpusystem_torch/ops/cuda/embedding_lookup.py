"""Row gather and ordered row scatter-add: hand-written CUDA for Hopper.

The counterpart of :mod:`tpusystem.ops.pallas.embedding_lookup`, the kernel
pair under every embedding lookup of the recommender
(``csrc/embedding_lookup.cu`` holds the design note):

* :func:`gather_rows` (K8) — the lookup direction: ``out[j] =
  row_scale[j] * src[row_ids[j]]``, multiplied in float32 and rounded once
  to the output dtype (0 masks padded ids, a pooling weight otherwise).
* :func:`scatter_add_rows` (K9) — the gradient direction: ``out[row_ids[j]]
  += row_scale[j] * rows[j]`` into a zeroed float32 ``[table_rows, dim]``
  table, duplicate ids summed from 0.0 in ascending ``j``, each product and
  each add rounded, as the reference's sequential read-modify-write does; ids
  ``>= table_rows`` (sentinels) are skipped. On the card the ids are sorted
  stably and each distinct id's segment is summed in order: a segment of
  :data:`LONG_SEGMENT` positions or more by one block per 16 columns, its
  products staged in that order and streamed through a ring of bulk copies
  into back-to-back adds, shorter ones many to a warp. The card finds the
  segments itself (the call never waits for it); no float atomics, every
  call repeats bitwise.

:func:`embedding_lookup` wraps the pair in a ``torch.autograd.Function``
(the reference's ``custom_vjp``): the forward is K8, the backward K9 for the
table's gradient and, only when the scale needs one, an unscaled K8
re-gather for the scale's.

Each wrapper follows its tensors' device: a CPU tensor takes the plain
PyTorch version (:func:`gather_rows_plain`, :func:`scatter_add_rows_plain`),
a CUDA tensor launches the kernel or raises. ``gather_rows.launches`` and
``scatter_add_rows.launches`` count launches. The TPU tiling rule of the
reference (``lookup_plan``: ``dim`` a multiple of 128, id blocks of 8, the
``block_rows`` and ``interpret`` knobs) is not carried over: the kernels
take any ``dim`` and any id count, so ``impl='auto'`` is ``'fused'`` on a
CUDA tensor and ``'take'`` on a CPU tensor, as the reference is off-TPU.
"""

from __future__ import annotations

import ctypes

import torch

from tpusystem_torch.ops.cuda._build import LIBRARIES

_GATHER = {(torch.float32, torch.float32): 'gather_rows_f32',
           (torch.bfloat16, torch.bfloat16): 'gather_rows_bf16',
           (torch.bfloat16, torch.float32): 'gather_rows_bf16_f32'}
_SCATTER = {torch.float32: 'scatter_add_rows_f32',
            torch.bfloat16: 'scatter_add_rows_bf16'}
# K9: segments of this many sorted positions or more take the long path (a
# block per 16 columns); shorter ones the short path (many to a warp)
LONG_SEGMENT = 256


def gather_rows_plain(src, row_ids, row_scale, *, out_dtype=None):
    """Plain PyTorch K8: the rows at the (clamped) ids, times the scale in
    float32, rounded once to ``out_dtype`` (default ``src.dtype``)."""
    ids = row_ids.long().clamp(0, src.shape[0] - 1)
    scaled = src.index_select(0, ids).float() * row_scale.float()[:, None]
    return scaled.to(out_dtype or src.dtype)


def scatter_add_rows_plain(rows, row_ids, row_scale, table_rows: int):
    """Plain PyTorch K9: ``index_add_`` of the float32 products into zeros,
    sentinel ids sent to a spare row that is dropped. On the CPU
    ``index_add_`` adds in index order, one rounding per add, as the
    reference's sequential read-modify-write."""
    ids = row_ids.long()
    ids = torch.where((ids >= 0) & (ids < table_rows), ids,
                      torch.full_like(ids, table_rows))
    out = torch.zeros((table_rows + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, ids, rows.float() * row_scale.float()[:, None])
    return out[:table_rows]


def _library():
    lib = LIBRARIES.library('embedding_lookup')
    if not getattr(lib, '_typed', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in _GATHER.values():
            getattr(lib, name).argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            getattr(lib, name).restype = i32
        for name in _SCATTER.values():
            getattr(lib, name).argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
            getattr(lib, name).restype = i32
        lib.scatter_group_columns.argtypes = []
        lib.scatter_group_columns.restype = i32
        lib._typed = True
    return lib


def _pointer(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


def _check_ids(name, row_ids, row_scale, count, device) -> None:
    for label, tensor in (('row_ids', row_ids), ('row_scale', row_scale)):
        if tuple(tensor.shape) != (count,):
            raise ValueError(f'{name}: {label} {tuple(tensor.shape)}, '
                             f'expected ({count},)')
        if tensor.device != device:
            raise ValueError(f'{name}: {label} on {tensor.device}, the rows '
                             f'on {device}')
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: tensors on {device} are not supported '
                         '(CPU takes the plain version, CUDA the kernel)')


def gather_rows(src, row_ids, row_scale, *, out_dtype=None):
    """K8, fused row gather: ``out[j] = row_scale[j] * src[row_ids[j]]``.

    Args:
        src: ``[rows, dim]`` table, read in place.
        row_ids: ``[n]`` int source row per output row, pre-clamped to
            ``[0, rows)`` (masked by ``row_scale``; the kernel clamps again
            for memory safety).
        row_scale: ``[n]`` float per-row factor, applied in float32.
        out_dtype: the output dtype, default ``src.dtype``. On CUDA: float32
            from float32, bfloat16 or float32 from bfloat16.

    Returns ``[n, dim]``."""
    out_dtype = out_dtype or src.dtype
    if src.dim() != 2:
        raise ValueError(f'gather_rows: src {tuple(src.shape)} is not 2-D')
    count, dim = row_ids.shape[0], src.shape[1]
    _check_ids('gather_rows', row_ids, row_scale, count, src.device)
    if src.device.type == 'cpu':
        return gather_rows_plain(src, row_ids, row_scale, out_dtype=out_dtype)
    name = _GATHER.get((src.dtype, out_dtype))
    if name is None:
        raise ValueError(f'gather_rows: the CUDA kernel takes {src.dtype} to '
                         f'{out_dtype} nowhere; it takes '
                         f'{sorted(str(pair) for pair in _GATHER)}')
    if src.shape[0] < 1:
        raise ValueError('gather_rows: src has no rows')
    src = src.contiguous()
    ids = row_ids.to(torch.int32).contiguous()
    scale = row_scale.float().contiguous()
    out = torch.empty((count, dim), dtype=out_dtype, device=src.device)
    vec = (dim * src.element_size() % 16 == 0 and src.data_ptr() % 16 == 0
           and out.data_ptr() % 32 == 0)
    err = getattr(_library(), name)(
        _pointer(src), _pointer(ids), _pointer(scale), _pointer(out), count,
        dim, src.shape[0], int(vec), _stream(src.device))
    _raise_on(err, 'gather_rows')
    gather_rows.launches += 1
    return out


def sort_ids(row_ids):
    """``(sorted_ids, order)``: the ids (int32) sorted stably and their
    positions, the index K9 sums each id's rows through in ascending
    position."""
    return torch.sort(row_ids.to(torch.int32), stable=True)


def scatter_add_into(out, rows, row_scale, sorted_ids, order) -> None:
    """Launch K9 into ``out`` (``[table_rows, dim]`` float32, contiguous):
    each id's row of ``out`` is overwritten with its ordered sum; the rows
    no id names keep what they held. The kernel alone, for timing it apart
    from the zero fill; :func:`scatter_add_rows` is the entry point."""
    name = _SCATTER.get(rows.dtype)
    if name is None:
        raise ValueError(f'scatter_add_rows: the CUDA kernel takes float32 or '
                         f'bfloat16 rows, not {rows.dtype}')
    if out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError('scatter_add_rows: out must be contiguous float32')
    rows = rows.contiguous()
    scale = row_scale.float().contiguous()
    lib = _library()
    count, dim = rows.shape
    group = lib.scatter_group_columns()
    # the products in sorted order, in planes of `group` columns
    staged = torch.empty((-(-dim // group), count, group), dtype=torch.float32,
                         device=rows.device)
    vec = dim % 4 == 0 and rows.data_ptr() % (4 * rows.element_size()) == 0
    err = getattr(lib, name)(
        _pointer(rows), _pointer(scale), _pointer(sorted_ids),
        _pointer(order), _pointer(staged), _pointer(out), count, dim,
        out.shape[0], LONG_SEGMENT, int(vec), _stream(rows.device))
    _raise_on(err, 'scatter_add_rows')


def scatter_add_rows(rows, row_ids, row_scale, table_rows: int):
    """K9, fused row scatter-add: ``out[row_ids[j]] += row_scale[j] *
    rows[j]`` into a zeroed float32 ``[table_rows, dim]`` table.

    ``table_rows`` is the sentinel id: ids ``>= table_rows`` move nothing.
    Accumulation is float32 whatever the rows' dtype (the caller rounds
    once to the table dtype); duplicate ids add in ascending ``j`` from
    0.0, every product and add rounded, bitwise the reference's sequential
    read-modify-write."""
    if rows.dim() != 2:
        raise ValueError(f'scatter_add_rows: rows {tuple(rows.shape)} is not '
                         '2-D')
    _check_ids('scatter_add_rows', row_ids, row_scale, rows.shape[0],
               rows.device)
    if rows.device.type == 'cpu':
        return scatter_add_rows_plain(rows, row_ids, row_scale, table_rows)
    out = torch.zeros((table_rows, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    sorted_ids, order = sort_ids(row_ids)
    scatter_add_into(out, rows, row_scale, sorted_ids, order)
    scatter_add_rows.launches += 1
    return out


gather_rows.launches = 0
scatter_add_rows.launches = 0


# ---------------------------------------------------------------------------
# the differentiable lookup built on the pair


def _take_lookup(table, clamped, scale):
    """Reference / CPU path: a gather and the masking multiply in float32
    (autograd's ``index_add_`` is the gradient scatter). The multiply is
    K8's, so the two forwards agree bitwise."""
    safe = clamped.clamp(max=table.shape[0] - 1)
    rows = table.index_select(0, safe)
    return (rows.float() * scale[:, None]).to(table.dtype)


class _FusedLookup(torch.autograd.Function):
    """K8 forward; K9 for ``d_table`` (float32, rounded once to the table
    dtype) and, only when ``scale`` needs a gradient, the unscaled K8
    re-gather for ``d_scale[j] = <table[id_j], d_out[j]>``, zero on
    sentinel rows (their gather clamped to a real row)."""

    @staticmethod
    def forward(ctx, table, clamped, scale):
        ctx.save_for_backward(table, clamped, scale)
        return gather_rows(table, clamped.clamp(max=table.shape[0] - 1),
                           scale)

    @staticmethod
    def backward(ctx, d_out):
        table, clamped, scale = ctx.saved_tensors
        rows = table.shape[0]
        d_table = d_scale = None
        if ctx.needs_input_grad[0]:
            d_table = scatter_add_rows(d_out, clamped, scale,
                                       rows).to(table.dtype)
        if ctx.needs_input_grad[2]:
            regathered = gather_rows(table, clamped.clamp(max=rows - 1),
                                     torch.ones_like(scale))
            d_scale = (regathered.float() * d_out.float()).sum(-1)
            d_scale = torch.where(clamped < rows, d_scale,
                                  torch.zeros_like(d_scale))
        return d_table, None, d_scale


def embedding_lookup(table, ids, weights=None, *, impl: str = 'auto'):
    """Differentiable embedding lookup ``out[j] = w[j] * table[ids[j]]``.

    Ids outside ``[0, rows)`` (``-1`` multi-hot padding) give zero rows and
    no gradient. ``weights`` (optional, ``[n]``) scales each row; its
    gradient is the rowwise dot with the cotangent.

    ``impl``: ``'take'`` is the gather path (autograd supplies the gradient
    scatter), ``'fused'`` the K8/K9 pair behind :class:`_FusedLookup`,
    ``'auto'`` fused on a CUDA table and take on a CPU one."""
    rows = table.shape[0]
    ids = ids.to(torch.int32)
    valid = (ids >= 0) & (ids < rows)
    clamped = torch.where(valid, ids, torch.full_like(ids, rows))
    scale = valid.float()
    if weights is not None:
        scale = scale * weights.float()
    if impl == 'auto':
        impl = 'fused' if table.is_cuda else 'take'
    if impl == 'take':
        return _take_lookup(table, clamped, scale)
    if impl != 'fused':
        raise ValueError(f'unknown impl {impl!r}; '
                         "expected 'auto', 'fused' or 'take'")
    return _FusedLookup.apply(table, clamped, scale)
