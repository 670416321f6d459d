"""Pipeline parallelism over the ``stage`` mesh axis: the port of
:mod:`tpusystem.parallel.pipeline`.

Layers are stacked at a leading ``layers`` dimension, which splits over
``stage``: each rank runs ``layers / stages`` contiguous layers (with
``interleave = v > 1``, ``v`` non-contiguous chunks of a chunk-major
``[v, layers / v, ...]`` stack) on the microbatches that travel
stage to stage by ring shifts over the stage group. Every rank of a
stage group holds the same activations before and after the pipe (the
embeddings and the head run on each), its rows of the batch split over
``(data, fsdp)``.

The reference runs the schedule inside ``shard_map`` and lets autodiff
replay it in reverse. The port runs it eagerly, one tick at a time, and
writes the backward out: :func:`pipeline_apply` is one
``torch.autograd.Function`` whose backward drains the pipe tick by tick in
the transposed order (the reverse ring shift of every forward hop, in the
reverse order), recomputing each unit from its stashed input under
``remat=True``, so every rank issues every hop and every hop's reverse in
the same order whatever its stage skipped; :func:`pipeline_train` (1F1B)
takes its gradients explicitly, one unit at a time, as the reference
does. An idle unit (fill, drain, the padding of a short group) skips its
compute: the ranks of its ``model`` group share its stage and so its
tick, so the tensor-parallel collectives inside a unit run on all of them
or none (the reference runs units masked under PP x TP for the same
reason, where its compiler cannot see that).

Under FSDP the 1F1B step hands :func:`pipeline_train` stand-ins for the
leaves it would gather: each unit gathers what it runs on, a stage's chunk
of the stack or the replicated leaves of the head and the tail, and drops
it when the unit ends.

The hidden state enters the pipe replicated over ``stage`` (its gradient
is summed over the stage group: only stage 0 feeds it) and leaves it
replicated (the last stage's outputs summed over the stage group with the
others' zeros; each stage rank's loss is the same, so the backward takes
the last stage's own cotangent).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch

from tpusystem_torch.parallel.collectives import (_raw_all_gather,
                                                  _raw_all_reduce,
                                                  all_reduce_mean, reduce_from,
                                                  ring_shift_chunked)
from tpusystem_torch.parallel.mesh import (DATA, FSDP, STAGE, Mesh,
                                           PartitionSpec as P)
from tpusystem_torch.parallel.sharding import (ShardingPolicy, gathered,
                                               guard_stand_ins, held_axes,
                                               is_deferred, unit_gathering)

__all__ = ['pipeline_apply', 'pipeline_train', 'PipelineParallel',
           'compose_stacked_rules']

# One layer of the pipelined stack: (layer_params, activations) -> activations
BlockFn = Callable[[dict, torch.Tensor], Any]


def _unit_runner(mesh):
    """How schedule units execute: ``run_unit(predicate, run, skip)`` runs
    ``run()`` where the unit is active and ``skip()`` where it idles. A
    unit's ``model`` group shares its stage coordinate, hence its tick and
    its predicate: the tensor-parallel collectives inside a unit run on all
    of the group's ranks or on none, so an idle unit may skip its compute
    on every mesh."""
    return lambda predicate, run, skip: run() if predicate else skip()


def _stage_scan(block_fn: BlockFn, has_aux: bool = False,
                held: dict | None = None):
    """Apply a chunk of layers: ``run(params, state)``, ``params`` a dict of
    ``[layers_in_chunk, ...]`` tensors, one ``unbind`` each; a layer slice
    carries the axes ``held`` names for it (its tensor-parallel split).
    With ``has_aux`` the block returns ``(x, aux_scalar)`` per layer and the
    body returns ``(x, aux_sum)``, the float32 sum over the chunk."""
    held = held or {}

    def layers(params):
        names = list(params)
        pieces = []
        for name in names:
            slices = params[name].unbind(0)
            for piece in slices if held.get(name) else ():
                piece.held = held[name]
            pieces.append(slices)
        return [dict(zip(names, layer)) for layer in zip(*pieces)]

    if has_aux:
        def run_aux(params, state):
            aux = torch.zeros((), dtype=torch.float32, device=state.device)
            for layer_params in layers(params):
                state, unit_aux = block_fn(layer_params, state)
                aux = aux + unit_aux.float()
            return state, aux
        return run_aux

    def run(params, state):
        for layer_params in layers(params):
            state = block_fn(layer_params, state)
        return state
    return run


@functools.lru_cache(maxsize=None)
def _stash_slots(stages: int, interleave: int, microbatches: int) -> int:
    """Smallest per-chunk stash size such that ``m % slots`` indexing never
    clobbers a live microbatch input.

    A chunk input written at its forward tick must survive until its
    backward tick; reuse of slot ``m % slots`` by microbatch ``m + slots``
    is safe iff that later forward happens strictly after this backward.
    Checked directly against the schedule formulas (see
    :func:`pipeline_train`); for ``interleave == 1`` this recovers the
    classic 1F1B bound ``2 * stages - 1``."""
    def fwd_tick(c, s, m):
        group, pos = divmod(m, stages)
        return s + group * interleave * stages + c * stages + pos

    def bwd_tick(c, s, m):
        group, pos = divmod(m, stages)
        return ((interleave * stages + stages - 2 - s)
                + group * interleave * stages
                + (interleave - 1 - c) * stages + pos)

    for slots in range(1, microbatches + 1):
        if all(fwd_tick(c, s, m + slots) > bwd_tick(c, s, m)
               for c in range(interleave) for s in range(stages)
               for m in range(microbatches - slots)):
            return slots
    return microbatches


def _schedule(stages: int, chunks: int, microbatches: int):
    """``unit(index) -> (active, chunk, microbatch)``: the forward slot of
    the interleaved schedule (groups of ``stages`` microbatches per chunk
    sweep, a partial last group padded with idle units); for one chunk it
    reduces to ``(0 <= index < M, 0, index)``."""
    span = chunks * stages
    padded = (microbatches if chunks == 1
              else -(-microbatches // stages) * stages)

    def unit(index: int):
        group, rem = divmod(index, span)
        chunk, pos = divmod(rem, stages)
        m = group * stages + pos
        active = 0 <= index < chunks * padded and m < microbatches
        return (active, min(max(chunk, 0), chunks - 1),
                min(max(m, 0), microbatches - 1))
    return unit, padded


def _group(mesh: Mesh, axes: tuple):
    """The process group over those of ``axes`` with more than one rank
    (None for none)."""
    live = tuple(axis for axis in axes if mesh.shape[axis] > 1)
    if not live or not mesh.distributed:
        return None
    return mesh.group(live)


def _sum_over(value: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """``value`` summed in float32 over ``axes`` (no autograd), cast back."""
    group = _group(mesh, axes)
    if group is None:
        return value
    return _raw_all_reduce(value.float(), group).to(value.dtype)


def _alias(tensor: torch.Tensor) -> torch.Tensor:
    """A leaf of its own over ``tensor``'s values, requiring grad where it
    can, with ``tensor``'s tensor-parallel marks."""
    alias = tensor.detach().requires_grad_(tensor.is_floating_point())
    if held_axes(tensor):
        alias.held = held_axes(tensor)
    return alias


def _grads(outputs, inputs, cotangents) -> list:
    """``torch.autograd.grad`` with unused inputs' gradients as zeros."""
    found = torch.autograd.grad(outputs, inputs, cotangents,
                                allow_unused=True)
    return [torch.zeros_like(leaf) if grad is None else grad
            for leaf, grad in zip(inputs, found)]


def _whole(params: dict) -> dict:
    """The dict with each stand-in gathered whole (a unit's leaves)."""
    return {name: gathered(leaf) for name, leaf in params.items()}


def _uses(params: dict, aliases: dict) -> dict:
    """One use of each leaf of ``params`` through its alias: a stand-in's
    gathered now through its anchor, another's the alias itself."""
    return {name: (params[name].lazy.through(alias)
                   if is_deferred(params[name]) else alias)
            for name, alias in aliases.items()}


def _listed(alias) -> list:
    return alias if isinstance(alias, list) else [alias]


def _layers(stack: '_Stack', layered: dict, aliases: dict):
    """``layer(index)``: a layer's parameter dict in the one-stage loop, a
    stand-in's layer gathered through its anchor when it is asked for,
    another leaf's slice of its alias (one ``unbind``) with its
    tensor-parallel marks."""
    slices = {}
    for name, alias in aliases.items():
        if name not in stack.lazies:
            slices[name] = alias.unbind(0)
            for piece in slices[name] if stack.held.get(name) else ():
                piece.held = stack.held[name]

    def layer(index: int) -> dict:
        return {name: (layered[name][index].through(aliases[name][index])
                       if name in stack.lazies else slices[name][index])
                for name in stack.names}
    return layer


class _Stack:
    """This rank's layer chunks of a stacked parameter dict: each leaf as
    ``[chunks, layers_in_chunk, ...]`` (a view of the piece the rank holds,
    or of its slice of a whole stack), the tensor-parallel marks of a layer
    slice, and the global layer count. A stand-in of a leaf still to
    gather (:func:`~tpusystem_torch.parallel.sharding.defer_leaf`) is
    gathered a chunk at a time, when :meth:`chunk` hands the chunk to a
    unit."""

    def __init__(self, stacked: dict, mesh: Mesh, chunks: int) -> None:
        stages = mesh.shape[STAGE]
        self.names = list(stacked)
        self.chunks = chunks
        first = stacked[self.names[0]]
        lead = 1 if chunks == 1 else 2
        self.stage_dim = stage_dim = lead - 1
        if chunks > 1 and first.shape[0] != chunks:
            raise ValueError(
                f'interleave={chunks} expects chunk-major stacked params '
                f'[{chunks}, layers/{chunks}, ...]; got leading dims '
                f'{tuple(first.shape[:2])}')
        piece = STAGE in held_axes(first).get(stage_dim, ())
        local = first.shape[stage_dim] * (stages if piece else 1)
        self.layers = local * (chunks if chunks > 1 else 1)
        if self.layers % (stages * chunks):
            raise ValueError(f'{self.layers} layers not divisible by '
                             f'{stages} stages x {chunks} chunks')
        # a whole stack on a stage axis of many ranks: this rank's slice
        self.whole = stages > 1 and not piece
        self.leaves, self.held, self.shapes = [], {}, []
        self.lazies: dict = {}
        index = mesh.coordinate[STAGE] if stages > 1 else 0
        for name in self.names:
            leaf = stacked[name]
            marks = held_axes(leaf)
            if is_deferred(leaf):
                if self.whole:
                    raise ValueError(f'{name}: a stand-in of a whole stack '
                                     'on a stage axis of many ranks')
                self.lazies[name] = ([leaf.lazy] if chunks == 1
                                     else leaf.lazy.layers(lead_held=True))
                leaf = leaf.lazy.stand_in()     # its shape and dtype only
            if self.whole:
                size = leaf.shape[stage_dim] // stages
                leaf = leaf.narrow(stage_dim, index * size, size)
            self.shapes.append(leaf.shape)
            if chunks == 1:
                leaf = leaf.unsqueeze(0)
            inner = {dim - lead: tuple(axis for axis in axes
                                       if axis != STAGE)
                     for dim, axes in marks.items() if dim >= lead}
            inner = {dim: axes for dim, axes in inner.items() if axes}
            if inner:
                self.held[name] = inner
            self.leaves.append(leaf)

    def chunk(self, leaves, c: int) -> dict:
        return {name: (self.lazies[name][c].gather() if name in self.lazies
                       else leaf[c])
                for name, leaf in zip(self.names, leaves)}

    def layer_leaves(self) -> dict:
        """Each leaf's layers in layer-major order: a stand-in's as one
        lazy leaf a layer (gathered by the layer's unit), another's as
        the ``[layers, ...]`` stack, a view of the rank's leaf."""
        return {name: ([layer for lazy in self.lazies[name]
                        for layer in lazy.layers(lead_held=True)]
                       if name in self.lazies
                       else leaf.reshape((-1,) + tuple(leaf.shape[2:])))
                for name, leaf in zip(self.names, self.leaves)}

    def restore(self, index: int, grad: torch.Tensor, mesh: Mesh
                ) -> torch.Tensor:
        """The ``[chunks, layers_in_chunk, ...]`` gradient of leaf
        ``index`` in the leaf's own shape and dtype; for a whole stack, the
        whole gradient, gathered over the stage group."""
        grad = grad.reshape(self.shapes[index]).to(
            self.leaves[index].dtype)
        if self.whole:
            grad = _raw_all_gather(grad, mesh.group(STAGE), self.stage_dim)
        return grad


class _Units:
    """The forward and the backward of one schedule unit (a chunk of
    layers on a microbatch). ``record`` (a graph is being recorded) makes
    ``forward`` stash what ``backward`` needs: the unit's input under
    ``remat`` (recomputed in the backward), else its autograd graph."""

    def __init__(self, body, stack: _Stack, has_aux: bool, remat: bool,
                 record: bool) -> None:
        self.body, self.stack = body, stack
        self.has_aux, self.remat, self.record = has_aux, remat, record
        self.stash: dict = {}

    def forward(self, leaves, c: int, x, key):
        params = self.stack.chunk(leaves, c)
        if self.record and not self.remat:
            with torch.enable_grad():
                aliases = {name: _alias(leaf)
                           for name, leaf in params.items()}
                given = _alias(x)
                out = self.body(aliases, given)
            self.stash[key] = (aliases, given, out)
        else:
            with torch.no_grad():
                out = self.body(params, x)
            if self.record:
                self.stash[key] = x
        if not self.has_aux:
            return out.detach(), None
        return out[0].detach(), out[1].detach()

    def backward(self, leaves, c: int, key, d_y, d_aux):
        saved = self.stash.pop(key)
        if isinstance(saved, tuple):
            aliases, given, out = saved
        else:
            with torch.enable_grad():
                aliases = {name: _alias(leaf) for name, leaf in
                           self.stack.chunk(leaves, c).items()}
                given = _alias(saved)
                out = self.body(aliases, given)
        outputs = list(out) if self.has_aux else [out]
        cotangents = [d_y] + ([d_aux] if self.has_aux else [])
        grads = _grads(outputs, list(aliases.values()) + [given], cotangents)
        return grads[:-1], grads[-1]


class _Pipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node: ``forward(run, hidden,
    *leaves) -> (outputs, aux_local)``; its backward drains the pipe."""

    @staticmethod
    def forward(ctx, run, hidden, *leaves):
        outputs, aux = run.forward(hidden, leaves)
        ctx.run, ctx.leaves = run, leaves
        return outputs, aux

    @staticmethod
    def backward(ctx, d_out, d_aux):
        d_hidden, d_leaves = ctx.run.backward(ctx.leaves, d_out, d_aux)
        ctx.run = ctx.leaves = None
        return (None, d_hidden, *d_leaves)


class _GPipe:
    """One call of :func:`pipeline_apply`: its forward ticks, classic or
    skewed (``plan.path == 'overlap'``), and their transposed backward."""

    def __init__(self, units: _Units, mesh: Mesh, microbatches: int,
                 chunks: int, plan) -> None:
        self.units, self.mesh = units, mesh
        self.microbatches, self.chunks, self.plan = microbatches, chunks, plan
        self.overlap = plan.path == 'overlap'
        self.stages = mesh.shape[STAGE]
        self.stage = mesh.coordinate[STAGE] if self.stages > 1 else 0
        self.unit, padded = _schedule(self.stages, chunks, microbatches)
        self.ticks = (microbatches + 2 * (self.stages - 1) if self.overlap
                      else chunks * padded + self.stages - 1)
        self.shape = None

    def _shift(self, value, reverse: bool = False):
        """A hop to the next stage, or back, split into ``plan.chunks``
        shifts (:func:`~tpusystem_torch.parallel.collectives.pp_hop`'s
        chunked shift)."""
        if self.stages == 1:
            return value
        return ring_shift_chunked(value, self.mesh, STAGE, reverse=reverse,
                                  chunks=self.plan.chunks)

    def _step(self, t: int):
        """``(active, chunk, microbatch, fed)`` of tick ``t`` on this stage;
        ``fed`` when the unit reads its microbatch from the batch rather
        than from the previous stage. The skewed tick runs microbatch ``m``
        on stage ``s`` at tick ``m + 2s``."""
        if self.overlap:
            index = t - 2 * self.stage
            active = 0 <= index < self.microbatches
            m = min(max(index, 0), self.microbatches - 1)
            return active, 0, m, self.stage == 0
        active, c, m = self.unit(t - self.stage)
        return active, c, m, self.stage == 0 and c == 0

    def _emits(self, active: bool, c: int) -> bool:
        """Whether the unit is a microbatch's last: the last stage's final
        chunk."""
        return (active and self.stage == self.stages - 1
                and c == self.chunks - 1)

    def forward(self, hidden, leaves):
        count = self.microbatches
        self.shape = hidden.shape
        batches = hidden.reshape((count, hidden.shape[0] // count)
                                 + tuple(hidden.shape[1:]))
        zero = torch.zeros_like(batches[0])
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        emitted = [zero] * count
        state = arrived = zero
        for t in range(self.ticks):
            if self.overlap:
                # the send of last tick's output issues first, at tick top:
                # this tick's compute reads the message of the tick before
                incoming = self._shift(state)
            active, c, m, fed = self._step(t)
            x = batches[m] if fed else (arrived if self.overlap else state)
            if active:
                y, unit_aux = self.units.forward(leaves, c, x, t)
                if unit_aux is not None:
                    aux = aux + unit_aux
            else:
                y = zero
            if self._emits(active, c):
                emitted[m] = y
            if self.overlap:
                state, arrived = y, incoming
            elif t < self.ticks - 1:
                state = self._shift(y)
        outputs = torch.stack(emitted).reshape(hidden.shape)
        if self.stages > 1:
            outputs = _broadcast_from_last(outputs, self.mesh, self.stage)
        return outputs, aux

    def backward(self, leaves, d_out, d_aux):
        count = self.microbatches
        inner = (count, self.shape[0] // count) + tuple(self.shape[1:])
        zero = d_out.new_zeros(inner[1:])
        # every stage rank's loss is the same: the last stage's own
        # cotangent is its outputs' (_emits holds on the last stage only)
        d_out = d_out.reshape(inner)
        d_feed = [zero] * count
        acc = [torch.zeros(leaf.shape, dtype=torch.float32,
                           device=leaf.device) for leaf in leaves]
        d_aux = d_aux.float()
        pending = back = zero
        for t in reversed(range(self.ticks)):
            active, c, m, fed = self._step(t)
            if self.overlap:
                # the reverse of tick t's hop issues first
                arriving = self._shift(back, reverse=True)
            d_y = pending
            if self._emits(active, c):
                d_y = d_y + d_out[m]
            if active:
                grads, d_x = self.units.backward(leaves, c, t, d_y, d_aux)
                for total, grad in zip(acc, grads):
                    total[c] += grad.float()
            else:
                d_x = zero
            if fed:
                d_feed[m] = d_feed[m] + d_x
                d_state = zero
            else:
                d_state = d_x
            if self.overlap:
                back, pending = d_state, arriving
            elif t > 0:
                pending = self._shift(d_state, reverse=True)
        d_hidden = torch.stack(d_feed).reshape(self.shape)
        if self.stages > 1:       # only stage 0 fed the pipe
            d_hidden = _sum_over(d_hidden, self.mesh, (STAGE,))
        return d_hidden, [grad.to(leaf.dtype)
                          for grad, leaf in zip(acc, leaves)]


def _broadcast_from_last(outputs, mesh: Mesh, stage: int):
    """The last stage's ``outputs`` on every rank of its stage group: a
    float32 sum over the group with the other stages' zeros, exact in any
    dtype (the reference walks the buffer round the ring in ``count - 1``
    single-pair hops; one all-reduce moves it here)."""
    if stage != mesh.shape[STAGE] - 1:
        outputs = torch.zeros_like(outputs)
    return _sum_over(outputs, mesh, (STAGE,))


def pipeline_apply(block_fn: BlockFn, stacked_params: dict,
                   hidden: torch.Tensor, mesh: Mesh, *, microbatches: int,
                   remat: bool = True, interleave: int = 1, schedule=None,
                   has_aux: bool = False):
    """Run ``hidden`` through a layer stack pipelined over ``stage``.

    Args:
        block_fn: per-layer function ``(layer_params, x) -> x``, or
            ``(layer_params, x) -> (x, aux)`` with ``has_aux=True``;
            ``layer_params`` maps each name of ``stacked_params`` to its
            layer slice.
        stacked_params: dict of tensors with a leading ``layers`` dimension,
            this rank's pieces split over ``stage`` (marked so, as the
            placed step hands them over: :func:`~tpusystem_torch.parallel.
            sharding.gather_leaf`) or the whole stacks, of which the rank
            takes its slice. ``layers`` must divide by the stage count.
            With ``interleave = v > 1`` the leaves are chunk-major ``[v,
            layers/v, ...]`` split over ``stage`` at dimension 1.
        hidden: this rank's activations ``[rows, ...]`` (its rows of the
            batch split over ``(data, fsdp)``, the same on every rank of
            its stage group); the rows must divide by ``microbatches``.
        mesh: the mesh (a ``stage`` axis of size 1 degenerates to a
            microbatch loop).
        interleave: virtual-pipeline chunks per rank: microbatches ride the
            ring ``v`` times through chunk-sized units (the forward slot of
            :func:`pipeline_train`'s schedule; a partial last group pads
            with idle units).
        schedule: optional :class:`~tpusystem_torch.parallel.schedule.
            OverlapSchedule`. With ``pp='overlap'`` the loop takes the
            skewed double-buffered tick: each stage issues the hop of last
            tick's output at tick top (:func:`~tpusystem_torch.parallel.
            collectives.pp_hop`), before this tick's compute, which reads
            the message of the tick before; one more fill tick a stage
            (``M + 2(S-1)`` ticks). Both ticks compute the same math on the
            same operands, so outputs and gradients are bit for bit equal.
            :func:`~tpusystem_torch.parallel.schedule.pp_plan` pins the
            classic fallback.
        has_aux: ``block_fn`` returns ``(x, aux_scalar)`` per layer (the
            MoE router losses); the call returns ``(hidden, aux)``, ``aux``
            the mean over every (unit, microbatch): summed over stages,
            averaged over batch shards.
    """
    from tpusystem_torch.parallel.schedule import PpPlan, pp_plan
    stages = mesh.shape[STAGE]
    stack = _Stack(stacked_params, mesh, interleave)
    data_parallel = mesh.shape[DATA] * mesh.shape[FSDP]
    if hidden.shape[0] % microbatches:
        raise ValueError(
            f'batch {hidden.shape[0] * data_parallel} not divisible by '
            f'data*fsdp*microbatches = {data_parallel}*{microbatches}')
    # the pp= arm: the pure plan decides skewed-overlap against classic
    # ticks from the microbatch's rows (what pp_hop's chunked shift splits)
    micro_rows = hidden.shape[0] // microbatches
    if schedule is not None and schedule.pp == 'overlap':
        plan = pp_plan(micro_rows, stages, chunks=schedule.chunks,
                       interleave=interleave)
    else:
        plan = PpPlan('skip', 1, 'pp overlap inactive')
    record = torch.is_grad_enabled() and (hidden.requires_grad or any(
        leaf.requires_grad for leaf in stack.leaves))
    units = _Units(_stage_scan(block_fn, has_aux, stack.held), stack,
                   has_aux, remat, record)
    run = _GPipe(units, mesh, microbatches, interleave, plan)
    outputs, aux_local = _Pipe.apply(run, hidden, *stack.leaves)
    if not has_aux:
        return outputs
    # every unit lives on one stage: the sum over stages (each stage rank
    # computes the same loss, so the backward keeps its own cotangent),
    # the mean over (unit, microbatch), then over the batch shards
    aux = reduce_from(aux_local, mesh, STAGE) / (microbatches * stack.layers)
    if data_parallel > 1:
        aux = all_reduce_mean(aux, mesh, (DATA, FSDP))
    return outputs, aux


def pipeline_train(head_fn, block_fn, tail_fn, mesh: Mesh, *,
                   microbatches: int, weight_fn=None, interleave: int = 1):
    """1F1B-scheduled pipelined loss and gradients (one combined pass).

    The GPipe path (:func:`pipeline_apply` under autograd) stashes
    O(microbatches) unit inputs per stage, because its backward replays the
    whole forward in reverse. This schedule interleaves forwards with
    backwards, so a microbatch's backward runs a bounded number of ticks
    after its forward and the per-stage stash holds :func:`_stash_slots`
    inputs a chunk, whatever the microbatch count (block outputs are
    recomputed in the backward). The last stage backwards each microbatch
    in the tick it forwards it (classic 1F1B).

    **Interleaved schedule** (``interleave = v > 1``): virtual stage ``q =
    c * stages + s`` lives on rank ``s``, and microbatches travel the ring
    ``v`` times through chunk-sized units. With ``S`` stages and ``M``
    microbatches, tick ``r`` on stage ``s``:

    * forward: unit ``i = r - s`` (active while ``0 <= i < vM``), group
      ``g = i // (vS)``, chunk ``c_f = (i % (vS)) // S``, microbatch
      ``m_f = gS + i % S``;
    * backward: ``j = r - (vS + S - 2 - s)``, group ``g = j // (vS)``,
      chunk ``c_b = v - 1 - (j % (vS)) // S``, microbatch ``m_b = gS + j %
      S``;

    which for ``v = 1`` are classic 1F1B (forward ``r - s``, backward ``r -
    (2S - 2 - s)``). A partial last group (``M % S``) pads with idle units.
    Each tick ends with two hops over the stage group, the forward message
    to ``s + 1`` and the backward message to ``s - 1``, on every rank.

    No autograd runs through the round loop: each unit's gradients are
    taken by ``torch.autograd.grad`` on the unit recomputed from its
    stashed input, accumulated in float32, and returned in the parameter
    dtypes.

    Args:
        head_fn: ``(replicated_params, micro_inputs) -> activations``, run
            at stage 0 (chunk 0).
        block_fn: ``(layer_params, x) -> x`` per layer; the stack as
            :func:`pipeline_apply` takes it.
        tail_fn: ``(replicated_params, activations, micro_targets) ->
            scalar mean loss``, run at the last stage (last chunk).
            ``replicated_params`` is one dict shared by head and tail (a
            tied embedding's two gradient contributions are summed).
        mesh: the mesh, with a ``stage`` axis and batch rows split over
            ``(data, fsdp)``.
        microbatches: microbatches a step; this rank's rows must divide by
            it.
        weight_fn: optional ``(micro_targets) -> scalar`` microbatch weight
            (the masked LM losses' unmasked-token count), the weighting
            ``build_train_step(accumulate=...)`` applies; ``None`` weighs
            microbatches equally.
        interleave: virtual-pipeline chunks per rank (chunk-major stacks).

    Returns:
        ``step(replicated_params, stacked_params, inputs, targets) ->
        (loss, (d_replicated, d_stacked))``, the loss and gradients
        weight-averaged over microbatches and batch shards, keyed like the
        inputs; a stacked leaf given whole gets its whole gradient.
    """
    stages = mesh.shape[STAGE]
    chunks = interleave
    slots = _stash_slots(stages, chunks, microbatches)
    unit, padded = _schedule(stages, chunks, microbatches)
    rounds = chunks * padded + chunks * stages + stages - 2
    data_parallel = mesh.shape[DATA] * mesh.shape[FSDP]
    run_unit = _unit_runner(mesh)

    def weigh(targets):
        if weight_fn is None:
            return torch.ones((), dtype=torch.float32, device=targets.device)
        return weight_fn(targets).float()

    def step(replicated_params: dict, stacked_params: dict, inputs, targets):
        # a stand-in used outside the units that gather it raises
        given = [*replicated_params.values(), *stacked_params.values()]
        with (guard_stand_ins() if any(map(is_deferred, given))
              else contextlib.nullcontext()):
            return run(replicated_params, stacked_params, inputs, targets)

    def run(replicated_params: dict, stacked_params: dict, inputs, targets):
        if inputs.shape[0] % microbatches:
            raise ValueError(
                f'batch {inputs.shape[0] * data_parallel} not divisible by '
                f'data*fsdp*microbatches = {data_parallel}*{microbatches}')
        stack = _Stack(stacked_params, mesh, chunks)
        body = _stage_scan(block_fn, held=stack.held)
        stage = mesh.coordinate[STAGE] if stages > 1 else 0
        last = stages - 1
        micro = lambda a: a.reshape((microbatches, a.shape[0] // microbatches)
                                    + tuple(a.shape[1:]))
        micro_in, micro_tgt = micro(inputs), micro(targets)
        reps = dict(replicated_params)
        rep_names = list(reps)
        device = inputs.device
        d_reps = [torch.zeros(leaf.shape, dtype=torch.float32,
                              device=leaf.device) for leaf in reps.values()]
        d_stacked = [torch.zeros(leaf.shape, dtype=torch.float32,
                                 device=leaf.device) for leaf in stack.leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        weight_acc = torch.zeros((), dtype=torch.float32, device=device)

        def add(totals, grads, scale=None):
            for total, grad in zip(totals, grads):
                total += grad.float() if scale is None else grad.float() * scale

        if stages == 1:
            # one stage: the plain microbatch loop, the head inside the
            # objective so the embedding's gradients flow; the chunk
            # dimension flattens back to the layer-major stack. Each unit
            # (the head, each layer, the tail) gathers its stand-ins when
            # it runs, through an anchor that takes the whole leaf's
            # gradient, and the backward gathers them again
            layered = stack.layer_leaves()
            deferred = bool(stack.lazies) or any(map(is_deferred,
                                                     reps.values()))
            for m in range(microbatches):
                tgt = micro_tgt[m]
                weight = weigh(tgt)
                with torch.enable_grad(), (unit_gathering() if deferred
                                           else contextlib.nullcontext()):
                    r_alias = {name: (leaf.lazy.anchor() if is_deferred(leaf)
                                      else _alias(leaf))
                               for name, leaf in reps.items()}
                    s_alias = {name: ([lazy.anchor() for lazy in leaf]
                                      if name in stack.lazies
                                      else _alias(leaf))
                               for name, leaf in layered.items()}
                    x = head_fn(_uses(reps, r_alias), micro_in[m])
                    layer = _layers(stack, layered, s_alias)
                    for index in range(stack.layers):
                        x = block_fn(layer(index), x)
                    loss_m = weight * tail_fn(_uses(reps, r_alias), x, tgt)
                    del x
                grads = _grads([loss_m], list(r_alias.values())
                               + [anchor for name in stack.names
                                  for anchor in _listed(s_alias[name])],
                               None)
                loss_acc += loss_m.detach().float()
                weight_acc += weight
                add(d_reps, grads[:len(reps)])
                grads = grads[len(reps):]
                for name, total in zip(stack.names, d_stacked):
                    count = len(_listed(s_alias[name]))
                    grad = (torch.stack(grads[:count])
                            if name in stack.lazies else grads[0])
                    total += grad.reshape(total.shape).float()
                    grads = grads[count:]
                del r_alias, s_alias, loss_m, grads
        else:
            with torch.no_grad():
                zero_act = torch.zeros_like(head_fn(_whole(reps),
                                                    micro_in[0]))
            stash = zero_act.new_zeros((chunks, slots) + zero_act.shape)
            fwd_msg = bwd_msg = zero_act
            for r in range(rounds):
                active_f, c_f, m_f = unit(r - stage)
                with torch.no_grad():
                    x = run_unit(active_f and stage == 0 and c_f == 0,
                                 lambda: head_fn(_whole(reps),
                                                 micro_in[m_f]),
                                 lambda: fwd_msg)
                    y = run_unit(active_f,
                                 lambda: body(stack.chunk(stack.leaves, c_f),
                                              x),
                                 lambda: zero_act)
                if active_f:
                    stash[c_f, m_f % slots] = x
                # tail: the last stage turns its final-chunk forward into a
                # loss and a cotangent seed in the same tick (1F1B)
                tgt = micro_tgt[m_f]
                active_t = active_f and stage == last and c_f == chunks - 1
                dy = zero_act
                if active_t:
                    weight = weigh(tgt)
                    with torch.enable_grad():
                        r_alias = {name: _alias(leaf)
                                   for name, leaf in _whole(reps).items()}
                        given = _alias(y)
                        loss_m = tail_fn(r_alias, given, tgt)
                        grads = _grads([loss_m],
                                       list(r_alias.values()) + [given], None)
                    # the weight rides the cotangent seed, so every gradient
                    # downstream (blocks, head) is weighted with no more work
                    dy = (grads[-1] * weight.to(grads[-1].dtype)).to(y.dtype)
                    loss_acc += loss_m.detach().float() * weight
                    weight_acc += weight
                    add(d_reps, grads[:-1], weight)
                    del r_alias, given, loss_m, grads
                # backward unit: recompute the chunk from its stashed input
                active_b, c_b_rev, m_b = unit(
                    r - (chunks * stages + stages - 2 - stage))
                c_b = chunks - 1 - c_b_rev
                cot = dy if stage == last and c_b == chunks - 1 else bwd_msg
                dx = zero_act
                if active_b:
                    with torch.enable_grad():
                        aliases = {name: _alias(leaf) for name, leaf in
                                   stack.chunk(stack.leaves, c_b).items()}
                        given = _alias(stash[c_b, m_b % slots])
                        grads = _grads([body(aliases, given)],
                                       list(aliases.values()) + [given],
                                       [cot])
                    for total, grad in zip(d_stacked, grads[:-1]):
                        total[c_b] += grad.float()
                    dx = grads[-1]
                    del aliases, given, grads
                    # stage 0's chunk-0 input cotangent flows into the head
                    if stage == 0 and c_b == 0:
                        with torch.enable_grad():
                            r_alias = {name: _alias(leaf) for name, leaf
                                       in _whole(reps).items()}
                            head = head_fn(r_alias, micro_in[m_b])
                            add(d_reps, _grads([head],
                                               list(r_alias.values()), [dx]))
                        del r_alias, head
                if r < rounds - 1:
                    fwd_msg = ring_shift_chunked(y, mesh, STAGE)
                    bwd_msg = ring_shift_chunked(dx, mesh, STAGE,
                                                 reverse=True)
        # weighted means: sum(w_m * value_m) / sum(w_m) over the
        # microbatches of every batch shard; the loss and the replicated
        # gradients also sum over the stages (each term lives on one)
        everywhere = (DATA, FSDP, STAGE)
        total = _sum_over(weight_acc, mesh, everywhere)
        loss = _sum_over(loss_acc, mesh, everywhere) / total
        d_reps = _flat_sum(d_reps, mesh, everywhere)
        d_stacked = _flat_sum(d_stacked, mesh, (DATA, FSDP))
        out_reps = {name: (grad / total).to(reps[name].dtype)
                    for name, grad in zip(rep_names, d_reps)}
        out_stacked = {name: stack.restore(index, grad / total, mesh)
                       for index, (name, grad) in enumerate(
                           zip(stack.names, d_stacked))}
        return loss, (out_reps, out_stacked)

    return step


def _flat_sum(grads: list, mesh: Mesh, axes: tuple) -> list:
    """Float32 tensors summed over ``axes`` in one flat all-reduce."""
    if _group(mesh, axes) is None or not grads:
        return grads
    flat = _sum_over(torch.cat([grad.reshape(-1) for grad in grads]), mesh,
                     axes)
    return [part.view_as(grad) for part, grad in zip(
        flat.split([grad.numel() for grad in grads]), grads)]


def PipelineParallel(stacked_prefix: str = r'(^|/)h/', extra_rules=(),
                     stacked_rules=(), fsdp: bool = False,
                     fsdp_min_size: int = 4096,
                     interleave: int = 1) -> ShardingPolicy:
    """Sharding policy for pipelined models: leaves under ``stacked_prefix``
    (the stacked layer collection) split their leading ``layers`` dimension
    over ``stage``; everything else follows ``extra_rules`` / FSDP.

    ``stacked_rules`` composes Megatron TP within stages: ``(pattern,
    spec)`` pairs matched against the within-stack leaf path (the per-block
    rules the unpipelined family ships, e.g. ``('attn/qkv/kernel$',
    P(None, 'model'))``), each spec shifted right past the stage
    dimension(s), so a qkv kernel lands on ``P(stage, None, 'model')``.
    Leaves no stacked rule matches fall back to plain stage splitting.

    ``interleave > 1`` matches :func:`pipeline_train`'s chunk-major layout
    (leaves ``[interleave, layers/interleave, ...]``): the second dimension
    splits over ``stage``, so each rank holds its ``interleave``
    non-contiguous chunks."""
    rules = compose_stacked_rules(stacked_prefix, stacked_rules, interleave)
    rules += tuple(extra_rules)
    return ShardingPolicy(rules=rules, fsdp=fsdp, fsdp_min_size=fsdp_min_size)


def compose_stacked_rules(stacked_prefix: str, stacked_rules,
                          interleave: int = 1):
    """Shift within-stack TP rules past the stage dimension(s) and append
    the plain stage-splitting fallback: the rule set both
    :func:`PipelineParallel` and the pipelined model families build their
    policies from. ``stacked_rules`` patterns are ``re.search``-ed against
    the leaf path, so anchor them to the leaf end (``kernel$``)."""
    stage_dims = (STAGE,) if interleave <= 1 else (None, STAGE)
    rules = tuple(
        (rf'(?:{stacked_prefix}).*(?:{pattern})', P(*stage_dims, *spec))
        for pattern, spec in stacked_rules)
    return rules + ((stacked_prefix, P(*stage_dims)),)
