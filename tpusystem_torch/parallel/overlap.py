"""Latency-hiding tensor-parallel collectives: the port of
:mod:`tpusystem.parallel.overlap`, decomposed all-gather / reduce-scatter
matmuls over the ``model`` mesh axis.

* :func:`allgather_matmul` is ``all_gather(x) @ w`` as ``n`` ring steps:
  each rank's shard of ``x`` rotates around the ring and every step's
  partial matmul fills one row block of the result; the next shard's
  shift is issued before the step's matmul.
* :func:`matmul_reducescatter` is the dual, ``reduce_scatter(x @ w)`` as
  ``n`` partial matmuls whose running float32 sum shifts one hop a step
  toward the row block's owner.

The reference calls them inside ``shard_map``; a port rank calls them on
the pieces it holds, with the :class:`~tpusystem_torch.parallel.mesh.Mesh`
and the axis (the collectives of
:mod:`tpusystem_torch.parallel.collectives`). Each is a
``torch.autograd.Function`` whose backward is the other's decomposition
(the transpose of an overlapped all-gather-matmul is an overlapped
matmul-reduce-scatter with swapped operands, and the reverse), the weight
gradient the shared :func:`_ring_transpose_matmul` ring. Every partial
product accumulates in float32 and the cross-step sum is carried in
float32, then cast once to the operands' result dtype. The shifts run in
program order: the overlap is the decomposition's, which a rank's eager
calls keep but do not hide.

Fallback: when the axis has one rank or ``chunks`` cannot tile the shard
rows, both take the **one-shot** collective (all-gather then matmul,
matmul then reduce-scatter); the pure :func:`allgather_plan` /
:func:`reducescatter_plan` pin which path a shape takes.

Model wiring: :func:`tp_ffn` (bias and activation, GPT-2) and
:func:`tp_swiglu` (gate and up fused into one ring, Llama) are the TP-only
cases of :func:`tpusystem_torch.parallel.schedule.scheduled_ffn` and
:func:`~tpusystem_torch.parallel.schedule.scheduled_swiglu`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from tpusystem_torch.parallel.collectives import (all_gather, reduce_scatter,
                                                  ring_shift_chunked)
from tpusystem_torch.parallel.mesh import (DATA, FSDP, MODEL, SEQ, Mesh,
                                           PartitionSpec)

__all__ = ['OverlapPlan', 'allgather_plan', 'reducescatter_plan',
           'allgather_matmul', 'matmul_reducescatter', 'DenseParams',
           'overlap_applicable', 'tp_ffn', 'tp_swiglu']


class OverlapPlan(NamedTuple):
    """Which path a (shape, ring, chunks) combination takes.

    ``path`` is ``'overlap'`` (decomposed ring) or ``'one-shot'`` (the
    monolithic collective); ``chunks`` is the per-hop ppermute split the
    overlap path will use; ``reason`` documents a fallback.
    """

    path: str
    chunks: int
    reason: str


def allgather_plan(rows: int, ring: int, chunks: int = 1) -> OverlapPlan:
    """Plan for ``allgather_matmul`` with per-device shards of ``rows``."""
    if ring == 1:
        return OverlapPlan('one-shot', 1, 'axis_size == 1')
    if chunks < 1 or rows % chunks:
        return OverlapPlan(
            'one-shot', 1,
            f'shard rows ({rows}) not divisible by chunks ({chunks})')
    return OverlapPlan('overlap', chunks, '')


def reducescatter_plan(rows: int, ring: int, chunks: int = 1) -> OverlapPlan:
    """Plan for ``matmul_reducescatter`` with ``rows`` total result rows.

    ``rows % ring != 0`` raises: a scatter over non-dividing rows has no
    semantics on the one-shot path either (``psum_scatter`` tiles).
    """
    if ring == 1:
        return OverlapPlan('one-shot', 1, 'axis_size == 1')
    if rows % ring:
        raise ValueError(
            f'matmul_reducescatter needs rows ({rows}) divisible by the '
            f'ring ({ring}) — the scattered result has no shape otherwise')
    if chunks < 1 or (rows // ring) % chunks:
        return OverlapPlan(
            'one-shot', 1,
            f'scatter block ({rows // ring}) not divisible by chunks '
            f'({chunks})')
    return OverlapPlan('overlap', chunks, '')


def _partial_matmul(a, b):
    """One ring step's matmul, always accumulating in float32."""
    return torch.matmul(a.float(), b.float())


def _out_dtype(x, w):
    return torch.promote_types(x.dtype, w.dtype)


def _allgather_matmul_overlap(mesh, axis, chunks, x, w):
    """The decomposed ring: shard ``s`` of ``x`` rotates forward and its
    partial matmul lands in row block ``s`` of the result; the next
    shard's shift is issued before the step's matmul."""
    ring = mesh.axis_size(axis)
    rank = mesh.axis_index(axis)
    rows = x.shape[0]
    out = x.new_zeros((ring * rows, w.shape[1]), dtype=_out_dtype(x, w))
    held = x
    incoming = ring_shift_chunked(held, mesh, axis, chunks=chunks)
    for step in range(ring):
        if step:
            held = incoming
            if step + 1 < ring:
                incoming = ring_shift_chunked(held, mesh, axis,
                                              chunks=chunks)
        # forward shifts: at step s we hold the shard of rank (rank - s)
        source = (rank - step) % ring
        out[source * rows:(source + 1) * rows] = _partial_matmul(
            held, w).to(out.dtype)
    return out


def _matmul_reducescatter_overlap(mesh, axis, chunks, x, w):
    """The dual ring: at step ``t`` every rank computes the partial for row
    block ``(rank - 1 - t) mod n`` and folds it into the running float32
    sum arriving from the previous rank, so after ``n`` steps block
    ``rank`` lands home with all ``n`` contributions."""
    ring = mesh.axis_size(axis)
    rank = mesh.axis_index(axis)
    rows = x.shape[0] // ring

    def block(step):
        start = ((rank - 1 - step) % ring) * rows
        return x[start:start + rows]

    total = _partial_matmul(block(0), w)
    for step in range(1, ring):
        inflight = ring_shift_chunked(total, mesh, axis, chunks=chunks)
        total = inflight + _partial_matmul(block(step), w)
    return total.to(_out_dtype(x, w))


def _ring_transpose_matmul(mesh, axis, chunks, rotating, sliced):
    """``sum_j rotating_j^T @ sliced[j*m:(j+1)*m]`` with ``rotating_j`` rank
    ``j``'s shard: the weight-gradient ring both backwards share, float32
    accumulator, the forward rings' order."""
    ring = mesh.axis_size(axis)
    rank = mesh.axis_index(axis)
    rows = rotating.shape[0]
    held = rotating
    incoming = ring_shift_chunked(held, mesh, axis, chunks=chunks)
    total = torch.zeros((rotating.shape[1], sliced.shape[1]),
                        dtype=torch.float32, device=rotating.device)
    for step in range(ring):
        if step:
            held = incoming
            if step + 1 < ring:
                incoming = ring_shift_chunked(held, mesh, axis,
                                              chunks=chunks)
        source = (rank - step) % ring
        total = total + _partial_matmul(
            held.T, sliced[source * rows:(source + 1) * rows])
    return total


class _AllgatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axis, chunks):
        ctx.save_for_backward(x, w)
        ctx.ring = (mesh, axis, chunks)
        return _allgather_matmul_overlap(mesh, axis, chunks, x, w)

    @staticmethod
    def backward(ctx, grad):
        # y = AG(x) @ w: dx is the dual decomposition with swapped operands
        # (an overlapped matmul-reduce-scatter of the cotangent against
        # w^T), dw the shared transpose ring
        x, w = ctx.saved_tensors
        dx = _matmul_reducescatter_overlap(*ctx.ring, grad, w.T).to(x.dtype)
        dw = _ring_transpose_matmul(*ctx.ring, x, grad).to(w.dtype)
        return dx, dw, None, None, None


class _MatmulReducescatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axis, chunks):
        ctx.save_for_backward(x, w)
        ctx.ring = (mesh, axis, chunks)
        return _matmul_reducescatter_overlap(mesh, axis, chunks, x, w)

    @staticmethod
    def backward(ctx, grad):
        # z = RS(x @ w): the reduce-scatter's transpose is the all-gather,
        # so dx is an overlapped all-gather-matmul of the cotangent against
        # w^T; dw the transpose ring with the roles swapped
        x, w = ctx.saved_tensors
        dx = _allgather_matmul_overlap(*ctx.ring, grad, w.T).to(x.dtype)
        dw = _ring_transpose_matmul(*ctx.ring, grad, x).T.to(w.dtype)
        return dx, dw, None, None, None


def allgather_matmul(x, w, mesh: Mesh, axis: str = MODEL, *,
                     chunks: int = 1):
    """``all_gather(x, axis) @ w`` decomposed into ring steps.

    ``x`` is this rank's row shard ``[rows, k]`` of a ``[ring * rows, k]``
    tensor split over ``axis``; ``w`` the local ``[k, p]`` column shard of
    a Megatron up-projection (never gathered). Each of the ``axis_size``
    steps' partial matmul fills one row block of the ``[ring * rows, p]``
    result; ``chunks`` splits each hop's payload into that many shifts
    (:func:`~tpusystem_torch.parallel.collectives.ring_shift_chunked`).

    Differentiable: the backward computes ``dx`` as the dual
    :func:`matmul_reducescatter` of the cotangent against ``w.T`` and
    ``dw`` by the shared transpose ring. Falls back to the one-shot
    all-gather and matmul when the axis has one rank or ``chunks`` cannot
    tile the shard (:func:`allgather_plan`).
    """
    plan = allgather_plan(x.shape[0], mesh.axis_size(axis), chunks)
    if plan.path == 'one-shot':
        gathered = all_gather(x, mesh, axis, dimension=0)
        return _partial_matmul(gathered, w).to(_out_dtype(x, w))
    return _AllgatherMatmul.apply(x, w, mesh, axis, plan.chunks)


def matmul_reducescatter(x, w, mesh: Mesh, axis: str = MODEL, *,
                         chunks: int = 1):
    """``reduce_scatter(x @ w, axis)`` decomposed into ring steps.

    ``x`` is the local ``[rows, k]`` activation against ``w``'s local
    ``[k, p]`` row shard of a Megatron down-projection; the partial
    products are summed over the ring and row block ``r`` of the ``[rows /
    ring, p]`` result lands on rank ``r``. Differentiable: ``dx`` is the
    dual :func:`allgather_matmul` of the cotangent against ``w.T``. Falls
    back to the one-shot matmul and reduce-scatter of the float32 product
    when the axis has one rank or ``chunks`` cannot tile the scatter block
    (:func:`reducescatter_plan`); rows not divisible by the ring raise.
    """
    plan = reducescatter_plan(x.shape[0], mesh.axis_size(axis), chunks)
    if plan.path == 'one-shot':
        # scatter the f32 partial products and cast AFTER: the fallback
        # must keep the module's f32-reduction contract
        product = _partial_matmul(x, w)
        if mesh.axis_size(axis) > 1:
            product = reduce_scatter(product, mesh, axis, dimension=0)
        return product.to(_out_dtype(x, w))
    return _MatmulReducescatter.apply(x, w, mesh, axis, plan.chunks)


# ---------------------------------------------------------------------------
# Model wiring: sequence-split FFN behind the ``tp_impl`` knob
# ---------------------------------------------------------------------------


class DenseParams(nn.Module):
    """Bare ``kernel``/``bias`` parameters under the module's scope:
    exactly what ``nn.Dense`` creates (the same paths and shapes; the
    models draw them), retrievable so the overlap path can run the matmul
    through the decomposed collectives. The models' dense layers are
    :class:`DenseParams` with a product (``models/gpt2.py`` ``Dense``), so
    ``tp_impl`` and ``schedule`` never change a checkpoint."""

    def __init__(self, features_in: int, features: int, *, device,
                 use_bias: bool = True) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self):
        """``(kernel, bias)``; ``bias`` is ``None`` without one."""
        return self.kernel, self.bias


def overlap_applicable(mesh, hidden_shape, grown_features: int,
                       axis: str = MODEL) -> bool:
    """Can the overlap FFN split ``[batch, seq, dim]`` activations with the
    hidden dim split over ``axis``? Falls back to the GSPMD path when the
    mesh is absent, the TP axis is trivial, the sequence cannot split over
    ``(seq, model)`` rows, or the FFN width cannot split."""
    if mesh is None:
        return False
    sizes = dict(mesh.shape)
    ring = sizes.get(axis, 1)
    if ring <= 1:
        return False
    _, seq, _ = hidden_shape
    row_split = ring * sizes.get(SEQ, 1)
    return seq % row_split == 0 and grown_features % ring == 0


def _row_specs(mesh, batch: int, axis: str):
    """Activation spec ``[batch, seq, dim]``: batch over ``(data, fsdp)``
    when it divides (replicated otherwise), sequence rows over ``(seq,
    model)``. A port rank's batch rows are already its own; the scheduled
    FFN splits the sequence over the spec's row axes."""
    sizes = dict(mesh.shape)
    data_axes = tuple(name for name in (DATA, FSDP) if name in sizes)
    data_parallel = math.prod(sizes[name] for name in data_axes)
    batch_axes = (data_axes if data_axes and batch % data_parallel == 0
                  else None)
    row_axes = tuple(name for name in (SEQ, axis) if name in sizes)
    return PartitionSpec(batch_axes, row_axes or None, None)


def tp_ffn(x, kernel_up, bias_up, kernel_down, bias_down, mesh, *,
           activation=None, axis: str = MODEL, chunks: int = 1):
    """Sequence-split Megatron FFN with decomposed collectives: the TP-only
    case of :func:`tpusystem_torch.parallel.schedule.scheduled_ffn` (the
    delegation is exact). ``activation`` defaults to the tanh GELU."""
    from tpusystem_torch.parallel.schedule import (OverlapSchedule,
                                                   scheduled_ffn)
    return scheduled_ffn(x, kernel_up, bias_up, kernel_down, bias_down,
                         mesh, schedule=OverlapSchedule(tp='overlap',
                                                        chunks=chunks),
                         activation=activation, axis=axis)


def tp_swiglu(x, kernel_gate, kernel_up, kernel_down, mesh, *,
              axis: str = MODEL, chunks: int = 1):
    """Sequence-split SwiGLU FFN (Llama) with decomposed collectives: the
    gate and up column shards concatenate into one ``[dim, 2 * grown]``
    right operand, so the rows ride the ring once for both matmuls. The
    TP-only case of
    :func:`tpusystem_torch.parallel.schedule.scheduled_swiglu`."""
    from tpusystem_torch.parallel.schedule import (OverlapSchedule,
                                                   scheduled_swiglu)
    return scheduled_swiglu(x, kernel_gate, kernel_up, kernel_down, mesh,
                            schedule=OverlapSchedule(tp='overlap',
                                                     chunks=chunks),
                            axis=axis)
