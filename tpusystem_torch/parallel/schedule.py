"""One overlap scheduler: the port of :mod:`tpusystem.parallel.schedule`.

:class:`OverlapSchedule` owns *when* each collective runs relative to
compute, as one strategy object:

* **TP rings** (``tp='overlap'``): the decomposed
  :func:`~tpusystem_torch.parallel.overlap.allgather_matmul` /
  :func:`~tpusystem_torch.parallel.overlap.matmul_reducescatter`.
* **FSDP prefetch** (``fsdp='prefetch'``): the FFN kernels enter the FFN
  still FSDP-split (the step leaves them so) and are gathered there by a
  ``torch.autograd.Function`` ring pair, the gather forward
  (:func:`~tpusystem_torch.parallel.collectives.ring_allgather`) and the
  reduce-scatter of the weight gradient backward
  (:func:`~tpusystem_torch.parallel.collectives.ring_reducescatter`).

:func:`scheduled_ffn` / :func:`scheduled_swiglu` run both on the pieces a
rank holds: the sequence rows of its batch split over ``model`` (the
rank's block taken from the activation every ``model`` rank holds whole,
and gathered back whole at the end), the kernels' FSDP gathers issued at
FFN entry, then the TP collectives decomposed or one-shot per
``schedule.tp``. A kernel reaches them as the step hands it over: whole,
or this rank's piece over ``model`` (and over ``fsdp`` under prefetch),
which :func:`~tpusystem_torch.parallel.sharding.held_axes` names.

Fallbacks are planned, never implicit: the pure :func:`fsdp_plan` pins
which path each leaf takes (``'skip'``, ``'one-shot'``, ``'ring'``), its
dimension choice :func:`~tpusystem_torch.parallel.sharding.fsdp_shard_dim`,
the placement policy's. :func:`pp_plan` and :func:`moe_plan` are the
pipeline's and the expert exchange's planners, copied: ``pp=`` drives the
GPipe loop's skewed tick (:func:`~tpusystem_torch.parallel.pipeline.
pipeline_apply`); ``moe=`` the expert layers' quota exchange
(:class:`~tpusystem_torch.ops.moe.MoEMLP`). :func:`decode_tp_plan` is the
serving engine's. The knob never changes a parameter tree: the models keep
their dense layers' paths either way.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpusystem_torch.parallel.collectives import (_raw_all_gather,
                                                  _raw_reduce_scatter,
                                                  _group, all_gather,
                                                  copy_to, gather_from,
                                                  reduce_scatter,
                                                  ring_allgather,
                                                  ring_reducescatter,
                                                  scatter_to)
from tpusystem_torch.parallel.mesh import DATA, FSDP, MODEL, SEQ, spec_axes
from tpusystem_torch.parallel.overlap import (_out_dtype, _partial_matmul,
                                              _row_specs, allgather_matmul,
                                              matmul_reducescatter,
                                              overlap_applicable)
from tpusystem_torch.parallel.sharding import fsdp_shard_dim, held_axes
from tpusystem_torch.registry import register

__all__ = ['OverlapSchedule', 'resolve_schedule', 'FsdpPlan', 'fsdp_plan',
           'PpPlan', 'pp_plan', 'MoePlan', 'moe_plan', 'DecodeTpPlan',
           'decode_tp_plan', 'prefetched', 'schedule_applicable',
           'scheduled_ffn', 'scheduled_swiglu', 'over_fsdp_whole']


@register
class OverlapSchedule:
    """Which collectives are decomposed and scheduled, and how finely.

    Args:
        tp: ``'gspmd'`` leaves the Megatron TP collectives monolithic;
            ``'overlap'`` routes the FFN through the decomposed rings
            (:mod:`tpusystem_torch.parallel.overlap`).
        fsdp: ``'gspmd'`` leaves the parameter gather to the step;
            ``'prefetch'`` gathers the FFN kernels with the decomposed ring
            pair at FFN entry and scatters their gradients where autograd
            reverses it.
        chunks: per-hop shift payload split shared by every ring this
            schedule owns (TP and FSDP).
        fsdp_min_size: leaves with fewer elements are expected unsharded
            (must match the placement policy's ``fsdp_min_size``).
        pp: ``'gspmd'`` | ``'overlap'``: the GPipe pipeline's tick
            (:func:`~tpusystem_torch.parallel.pipeline.pipeline_apply`).
        moe: ``'gspmd'`` | ``'overlap'``: the expert layers' quota
            exchange, one-shot or pipelined in pieces under the expert
            products (:func:`moe_plan`).

    A registered entity: its knobs capture into the experiment identity
    hash (the reference's hash for the same knobs), so runs under
    different schedules are distinguishable while their checkpoints stay
    interchangeable (the schedule never changes a param tree).
    """

    def __init__(self, tp: str = 'gspmd', fsdp: str = 'gspmd',
                 chunks: int = 1, fsdp_min_size: int = 4096,
                 pp: str = 'gspmd', moe: str = 'gspmd'):
        if tp not in ('gspmd', 'overlap'):
            raise ValueError(f'unknown schedule tp {tp!r}; '
                             "expected 'gspmd' or 'overlap'")
        if fsdp not in ('gspmd', 'prefetch'):
            raise ValueError(f'unknown schedule fsdp {fsdp!r}; '
                             "expected 'gspmd' or 'prefetch'")
        if pp not in ('gspmd', 'overlap'):
            raise ValueError(f'unknown schedule pp {pp!r}; '
                             "expected 'gspmd' or 'overlap'")
        if moe not in ('gspmd', 'overlap'):
            raise ValueError(f'unknown schedule moe {moe!r}; '
                             "expected 'gspmd' or 'overlap'")
        if chunks < 1:
            raise ValueError(f'chunks must be >= 1, got {chunks}')
        self.tp = tp
        self.fsdp = fsdp
        self.chunks = chunks
        self.fsdp_min_size = fsdp_min_size
        self.pp = pp
        self.moe = moe

    def _key(self):
        return (self.tp, self.fsdp, self.chunks, self.fsdp_min_size,
                self.pp, self.moe)

    def __eq__(self, other):
        return (isinstance(other, OverlapSchedule)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f'OverlapSchedule(tp={self.tp!r}, fsdp={self.fsdp!r}, '
                f'chunks={self.chunks}, fsdp_min_size={self.fsdp_min_size}, '
                f'pp={self.pp!r}, moe={self.moe!r})')

    @classmethod
    def for_policy(cls, policy, *, tp: str = 'gspmd',
                   fsdp: str = 'prefetch', chunks: int = 1,
                   pp: str = 'gspmd', moe: str = 'gspmd'):
        """Schedule paired to a placement policy: ``fsdp_min_size`` is
        copied from the :class:`~tpusystem_torch.parallel.sharding.
        ShardingPolicy`, so the plans see the leaves it split."""
        return cls(tp=tp, fsdp=fsdp, chunks=chunks,
                   fsdp_min_size=policy.fsdp_min_size, pp=pp, moe=moe)


def resolve_schedule(schedule, tp_impl: str = 'gspmd',
                     tp_chunks: int = 1) -> OverlapSchedule:
    """The models' knob seam: one :class:`OverlapSchedule` from either the
    ``schedule=`` object or the legacy ``tp_impl=``/``tp_chunks=`` pair.

    ``schedule=None`` folds the legacy pair into an equivalent schedule
    (``fsdp='gspmd'``); passing both a schedule and non-default legacy
    knobs raises, so a config can never silently say two different things.
    """
    if tp_impl not in ('gspmd', 'overlap'):
        raise ValueError(f'unknown tp_impl {tp_impl!r}; '
                         "expected 'gspmd' or 'overlap'")
    if schedule is None:
        return OverlapSchedule(tp=tp_impl, chunks=tp_chunks)
    if not isinstance(schedule, OverlapSchedule):
        raise TypeError('schedule= expects an OverlapSchedule, got '
                        f'{type(schedule).__name__}')
    if tp_impl != 'gspmd' or tp_chunks != 1:
        raise ValueError('pass schedule= or the legacy tp_impl=/tp_chunks= '
                         'knobs, not both')
    return schedule


class FsdpPlan(NamedTuple):
    """Which path one leaf's FSDP gather takes.

    ``path`` is ``'ring'`` (decomposed latency-hiding gather),
    ``'one-shot'`` (the monolithic all-gather — the requested chunks
    cannot tile the shard), or ``'skip'`` (the leaf was never
    fsdp-sharded: trivial axis, tiny leaf, or no divisible dimension —
    it arrives whole, no collective). ``dim`` is the gathered dimension
    (``-1`` when skipped), ``chunks`` the per-hop ppermute split the ring
    will use, ``reason`` documents a fallback.
    """

    path: str
    dim: int
    chunks: int
    reason: str


def fsdp_plan(shape: tuple[int, ...], ring: int, *, taken=(),
              chunks: int = 1, min_size: int = 4096,
              row_split: int = 1) -> FsdpPlan:
    """Plan one leaf's FSDP prefetch — pure, so tests can pin the path.

    Mirrors the placement side exactly: a leaf the policy's
    ``_with_fsdp`` left unsharded (below ``min_size``, or no unclaimed
    dimension divides ``ring``) plans ``'skip'``, and the gathered
    dimension is :func:`~tpusystem_torch.parallel.sharding.fsdp_shard_dim`'s
    choice (``taken`` = indices already claimed by TP rule axes).
    ``row_split`` is how many ways dimension 0 is already split by those
    rule axes (the TP ring over a down-projection's rows): the
    chunk-tiling check sees the LOCAL row count the shift will split.
    """
    if ring == 1:
        return FsdpPlan('skip', -1, 1, 'axis_size == 1')
    if math.prod(shape) < min_size:
        return FsdpPlan('skip', -1, 1,
                        f'leaf below fsdp_min_size ({min_size})')
    dim = fsdp_shard_dim(tuple(shape), ring, tuple(taken))
    if dim is None:
        return FsdpPlan('skip', -1, 1,
                        'no unsharded dimension divisible by the fsdp axis')
    if shape[0] % row_split:
        return FsdpPlan('one-shot', dim, 1,
                        f'rows ({shape[0]}) not divisible by the row '
                        f'split ({row_split})')
    shard_rows = (shape[0] // ring if dim == 0
                  else shape[0] // row_split)
    if chunks < 1 or shard_rows % chunks:
        return FsdpPlan('one-shot', dim, 1,
                        f'local shard rows ({shard_rows}) not divisible '
                        f'by chunks ({chunks})')
    return FsdpPlan('ring', dim, chunks, '')


_SKIP = FsdpPlan('skip', -1, 1, 'fsdp prefetch inactive')


class PpPlan(NamedTuple):
    """Which tick schedule the GPipe pipeline takes.

    ``path`` is ``'overlap'`` (the skewed double-buffered schedule: every
    stage-to-stage send issued under the next microbatch's compute),
    ``'one-shot'`` (the classic tick — send after the compute that
    produced it; the requested ``chunks`` cannot tile the microbatch
    rows, or the interleaved schedule owns the ticks), or ``'skip'``
    (``stage`` axis of size 1: there are no sends to hide). ``chunks``
    is the per-hop ppermute payload split the overlap hop will use,
    ``reason`` documents a fallback.
    """

    path: str
    chunks: int
    reason: str


def pp_plan(rows: int, stages: int, chunks: int = 1,
            interleave: int = 1) -> PpPlan:
    """Plan the pipeline's stage-to-stage sends — pure, so tests can pin
    the path (the reference's, copied)."""
    if stages == 1:
        return PpPlan('skip', 1, 'axis_size == 1')
    if interleave > 1:
        return PpPlan('one-shot', 1,
                      'interleaved schedule keeps the classic ticks')
    if chunks < 1 or rows % chunks:
        return PpPlan('one-shot', 1,
                      f'microbatch rows ({rows}) not divisible by chunks '
                      f'({chunks})')
    return PpPlan('overlap', chunks, '')


class MoePlan(NamedTuple):
    """Which dispatch schedule the sharded sparse MoE takes.

    ``path`` is ``'overlap'`` (local rows split into ``pieces``
    microbatch pieces, piece ``k+1``'s dispatch ``all_to_all`` issued
    under the expert matmuls of piece ``k``), ``'one-shot'`` (the single
    whole-batch exchange — the ragged exchanges, or rows that won't
    split), or ``'skip'`` (expert axis of size 1: no exchange exists).
    ``reason`` documents a fallback.
    """

    path: str
    pieces: int
    reason: str


def moe_plan(local_rows: int, expert_size: int, exchange: str = 'quota',
             pieces: int = 2) -> MoePlan:
    """Plan the expert-parallel dispatch pipeline — pure, so tests can
    pin the path (the reference's, copied;
    :class:`~tpusystem_torch.ops.moe.MoEMLP` follows it)."""
    if expert_size == 1:
        return MoePlan('skip', 1, 'axis_size == 1')
    if exchange != 'quota':
        return MoePlan('one-shot', 1,
                       f'{exchange!r} exchange seats at the receiver; '
                       'pipelined dispatch is quota-only')
    if pieces < 2 or local_rows % pieces or local_rows < 2 * pieces:
        return MoePlan('one-shot', 1,
                       f'local rows ({local_rows}) will not split into '
                       f'{pieces} pieces')
    return MoePlan('overlap', pieces, '')


class DecodeTpPlan(NamedTuple):
    """Which sharding path the serving engine's compiled steps take.

    ``path`` is ``'single'`` (no mesh, or a trivial ``model`` axis — the
    engine runs exactly as before on one device), ``'gspmd'`` (the decode
    and prefill programs run with TP-sharded matmuls: params placed by
    the module's ``partition_rules()``, the paged KV pool sharded over
    heads, block tables replicated so the host keeps ONE authority), or
    ``'unsupported'`` (the mesh carries a non-trivial axis serving cannot
    shard over — data/fsdp/seq/expert/stage parallelism belongs to
    training; serving batches are row-churned, not data-sharded).
    ``model`` is the TP degree, ``reason`` documents a fallback or gate.
    """

    path: str
    model: int
    reason: str


def decode_tp_plan(mesh) -> DecodeTpPlan:
    """Plan the engine's TP sharding — pure, so tests can pin the path.

    ``mesh`` is a built :class:`~tpusystem_torch.parallel.mesh.Mesh` (or
    ``None``). Only the ``model`` axis may exceed 1: the engine's row
    dimension churns every step (admit/evict rewrite individual rows in
    place), so sharding rows across devices would turn every seat into a
    cross-device scatter. The fused chain has no ring arms —
    :func:`~tpusystem_torch.train.decode_fused.fused_paged_reason` gates
    it and ``decode_impl='auto'`` takes the module path.
    """
    if mesh is None:
        return DecodeTpPlan('single', 1, 'no mesh')
    sizes = dict(getattr(mesh, 'shape', {}))
    model = sizes.get(MODEL, 1)
    offending = {axis: size for axis, size in sizes.items()
                 if axis != MODEL and size > 1}
    if offending:
        return DecodeTpPlan(
            'unsupported', model,
            f'serving shards over the {MODEL!r} axis only; mesh carries '
            f'non-trivial {sorted(offending)} — rows churn in place every '
            'step, so data-style sharding would scatter every seat')
    if model == 1:
        return DecodeTpPlan('single', 1, 'model axis of size 1')
    return DecodeTpPlan('gspmd', model, '')


class _RingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, mesh, axis, dim, chunks):
        ctx.ring = (mesh, axis, dim, chunks)
        return ring_allgather(shard, mesh, axis, dimension=dim,
                              chunks=chunks)

    @staticmethod
    def backward(ctx, grad):
        # the gather is a copy, so its transpose is the pure reduce-scatter
        # ring: each rank's block of the (per-rank partial) cotangent summed
        # around the ring in f32, landing home split like the leaf. The
        # sum over the other batch axes is the step's (sync_grads).
        mesh, axis, dim, chunks = ctx.ring
        return (ring_reducescatter(grad, mesh, axis, dimension=dim,
                                   chunks=chunks), None, None, None, None)


class _OneShotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, mesh, axis, dim):
        ctx.group, ctx.dim = _group(mesh, axis), dim
        return _raw_all_gather(shard, ctx.group, dim)

    @staticmethod
    def backward(ctx, grad):
        # scatter the f32 cotangent and cast once, so a leaf whose chunks
        # stop tiling keeps the ring path's f32-reduction contract
        total = _raw_reduce_scatter(grad.float(), ctx.group, ctx.dim)
        return total.to(grad.dtype), None, None, None


def prefetched(shard, plan: FsdpPlan, mesh, axis: str = FSDP):
    """Gather one FSDP-split leaf per its plan: ``'ring'`` is the
    decomposed pair (gather forward, reduce-scatter backward),
    ``'one-shot'`` the monolithic all-gather (its backward scatters the
    f32 cotangent), ``'skip'`` returns the leaf untouched."""
    if plan.path == 'skip':
        return shard
    if plan.path == 'one-shot':
        return _OneShotGather.apply(shard, mesh, axis, plan.dim)
    return _RingGather.apply(shard, mesh, axis, plan.dim, plan.chunks)


def _weight_spec_plan(base_entries, shape, prefetch_on: bool,
                      schedule: OverlapSchedule, fsdp_size: int,
                      row_split: int = 1):
    """(spec, plan) for one FFN kernel: the TP base spec with the fsdp axis
    added on exactly the dimension the placement policy picked.
    ``row_split`` = the TP axis size when ``base_entries[0]`` carries it
    (a down-projection's rows are TP-split, so the plan's chunk check sees
    the local row count)."""
    from tpusystem_torch.parallel.mesh import PartitionSpec as P
    entries = list(base_entries)
    if not prefetch_on:
        return P(*entries), _SKIP
    taken = [index for index, axis in enumerate(entries) if axis is not None]
    plan = fsdp_plan(shape, fsdp_size, taken=taken, chunks=schedule.chunks,
                     min_size=schedule.fsdp_min_size, row_split=row_split)
    if plan.path != 'skip':
        entries[plan.dim] = FSDP
    return P(*entries), plan


def _prefetch_on(schedule: OverlapSchedule, sizes, batch: int) -> bool:
    """The ONE prefetch-safety gate, shared by :func:`schedule_applicable`
    and the ``scheduled_*`` entry points. The manual gradient scatter
    assumes each rank contributed a distinct batch slice: ``batch`` is
    the global batch, which must split over ``(data, fsdp)``."""
    fsdp_size = sizes.get(FSDP, 1)
    return (schedule.fsdp == 'prefetch' and fsdp_size > 1
            and batch % (sizes.get(DATA, 1) * fsdp_size) == 0)


def _prefetch_applicable(schedule, mesh, hidden_shape, grown_features: int,
                         axis: str) -> bool:
    sizes = dict(mesh.shape)
    batch, seq, _ = hidden_shape
    if not _prefetch_on(schedule, sizes, batch):
        return False
    ring = sizes.get(axis, 1)
    if ring > 1:
        return overlap_applicable(mesh, hidden_shape, grown_features, axis)
    return seq % sizes.get(SEQ, 1) == 0


def schedule_applicable(schedule: OverlapSchedule, mesh, hidden_shape,
                        grown_features: int, axis: str = MODEL) -> bool:
    """Should the FFN take the scheduled path for this shape?

    ``hidden_shape`` is the global ``[batch, seq, dim]`` (a rank's batch
    rows times the ``(data, fsdp)`` ranks). True when the schedule
    decomposes at least one collective family the shape supports: TP
    rings per :func:`~tpusystem_torch.parallel.overlap.overlap_applicable`,
    or FSDP prefetch when the fsdp axis is non-trivial AND the batch
    splits over ``(data, fsdp)``. Shapes that qualify for neither take
    the models' Megatron Dense path — same params, so the fallback never
    changes a tree.
    """
    if mesh is None:
        return False
    if (schedule.tp == 'overlap'
            and overlap_applicable(mesh, hidden_shape, grown_features, axis)):
        return True
    return _prefetch_applicable(schedule, mesh, hidden_shape,
                                grown_features, axis)


def _tp_up(rows, w, mesh, axis, schedule):
    """``all_gather(rows) @ w`` under the schedule: the decomposed ring
    when ``tp='overlap'``, the one-shot collective otherwise (still
    f32-accumulated)."""
    if schedule.tp == 'overlap':
        return allgather_matmul(rows, w, mesh, axis, chunks=schedule.chunks)
    if mesh.axis_size(axis) > 1:
        rows = all_gather(rows, mesh, axis, dimension=0)
    return _partial_matmul(rows, w).to(_out_dtype(rows, w))


def _tp_down(grown, w, mesh, axis, schedule):
    """``reduce_scatter(grown @ w)`` under the schedule, the dual of
    :func:`_tp_up`; the one-shot path scatters the f32 product before
    casting."""
    if schedule.tp == 'overlap':
        return matmul_reducescatter(grown, w, mesh, axis,
                                    chunks=schedule.chunks)
    product = _partial_matmul(grown, w)
    if mesh.axis_size(axis) > 1:
        product = reduce_scatter(product, mesh, axis, dimension=0)
    return product.to(_out_dtype(grown, w))


def over_fsdp_whole(weight, mesh):
    """A leaf that arrives split over ``fsdp`` (a prefetched kernel on a
    path that does not prefetch) gathered whole over it, one-shot; any
    other leaf as it is."""
    held = held_axes(weight)
    split = [dim for dim, axes in held.items() if FSDP in axes]
    if not split:
        return weight
    gathered = prefetched(weight, FsdpPlan('one-shot', split[0], 1, ''),
                          mesh)
    rest = {dim: axes for dim, axes in held.items() if FSDP not in axes}
    if rest:
        gathered.held = rest
    return gathered


def _kernel(weight, base_entries, prefetch_on, schedule, mesh, axis,
            row_split=1):
    """One FFN kernel as the region computes with it: gathered over
    ``fsdp`` where it arrives split there (per its plan; the placement's
    dimension wins where the two disagree), then this rank's block over
    ``axis`` on the dimension ``base_entries`` names (cut from a kernel
    that arrives whole over ``axis``; backward, the blocks' gradients are
    gathered whole)."""
    held = held_axes(weight)
    split = [dim for dim, axes in held.items() if FSDP in axes]
    if split:
        whole = tuple(size * mesh.axis_size(held.get(dim, ()))
                      for dim, size in enumerate(weight.shape))
        _, plan = _weight_spec_plan(base_entries, whole, prefetch_on,
                                    schedule, mesh.shape[FSDP], row_split)
        if plan.path == 'skip' or plan.dim != split[0]:
            plan = FsdpPlan('one-shot', split[0], 1,
                            'the placement split another dimension')
        weight = prefetched(weight, plan, mesh)
    dim = base_entries.index(axis)
    if axis not in held.get(dim, ()):
        weight = scatter_to(weight, mesh, axis, dimension=dim)
    return weight


def _row_axes(mesh, batch: int, axis: str) -> tuple:
    """The axes of more than one rank that split the sequence rows."""
    return tuple(name for name in spec_axes(_row_specs(mesh, batch, axis)[1])
                 if mesh.shape[name] > 1)


def _region(mesh, x, axis):
    """This rank's sequence rows ``[batch * seq / n, dim]`` of the
    activation every ``axis`` rank holds whole, and their ``[batch, seq /
    n, dim]`` shape."""
    rows = scatter_to(x, mesh, _row_axes(mesh, x.shape[0], axis),
                      dimension=1)
    return rows.reshape(-1, rows.shape[-1]), rows.shape


def _leave(mesh, out, shape, axis):
    """The rows gathered back whole over the axes that split them."""
    return gather_from(out.reshape(shape), mesh,
                       _row_axes(mesh, shape[0], axis), dimension=1)


def scheduled_ffn(x, kernel_up, bias_up, kernel_down, bias_down, mesh, *,
                  schedule: OverlapSchedule, activation=None,
                  axis: str = MODEL):
    """Sequence-split FFN (bias and activation, GPT-2) under one schedule.

    ``x`` is this rank's batch rows ``[batch, seq, dim]``, whole over
    ``axis``; the result is too. Inside, the rank's block of the sequence
    rows all-gathers into the up matmul against its column block of the
    up kernel, the activation applies on the gathered rows, and the down
    matmul against its row block of the down kernel reduce-scatters the
    rows back, decomposed or one-shot per ``schedule.tp``. Under
    ``schedule.fsdp='prefetch'`` both kernel gathers issue at entry
    (:func:`prefetched`). ``bias_up`` rides its column block; ``bias_down``
    lands after the scatter, so the sum counts it once (its gradient is
    summed over ``axis``). ``activation`` defaults to the tanh GELU.
    """
    activation = activation or (lambda t: F.gelu(t, approximate='tanh'))
    sizes = dict(mesh.shape)
    batch = x.shape[0] * mesh.axis_size((DATA, FSDP))
    prefetch_on = _prefetch_on(schedule, sizes, batch)
    w_up = _kernel(kernel_up, (None, axis), prefetch_on, schedule, mesh,
                   axis)
    w_down = _kernel(kernel_down, (axis, None), prefetch_on, schedule, mesh,
                     axis, row_split=sizes.get(axis, 1))
    b_up = scatter_to(bias_up, mesh, axis, dimension=0)
    b_down = copy_to(bias_down, mesh, axis)
    rows, shape = _region(mesh, x, axis)
    grown = activation(_tp_up(rows, w_up, mesh, axis, schedule) + b_up)
    out = _tp_down(grown, w_down, mesh, axis, schedule) + b_down
    return _leave(mesh, out, shape, axis)


def scheduled_swiglu(x, kernel_gate, kernel_up, kernel_down, mesh, *,
                     schedule: OverlapSchedule, axis: str = MODEL):
    """Sequence-split SwiGLU FFN (Llama) under one schedule: the gate and
    up kernels gather over fsdp first, then their column blocks
    concatenate into the single ``[dim, 2 * grown / n]`` right operand, so
    the rows ride the TP ring once for both matmuls. No biases."""
    sizes = dict(mesh.shape)
    batch = x.shape[0] * mesh.axis_size((DATA, FSDP))
    prefetch_on = _prefetch_on(schedule, sizes, batch)
    w_gate, w_up = (_kernel(kernel, (None, axis), prefetch_on, schedule,
                            mesh, axis) for kernel in (kernel_gate,
                                                       kernel_up))
    w_down = _kernel(kernel_down, (axis, None), prefetch_on, schedule, mesh,
                     axis, row_split=sizes.get(axis, 1))
    rows, shape = _region(mesh, x, axis)
    fused = torch.cat([w_gate, w_up], dim=1)
    grown = _tp_up(rows, fused, mesh, axis, schedule)
    gate, up = grown.chunk(2, dim=1)
    hidden = F.silu(gate) * up
    out = _tp_down(hidden, w_down, mesh, axis, schedule)
    return _leave(mesh, out, shape, axis)
