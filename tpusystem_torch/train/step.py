"""Step builders: the port of :mod:`tpusystem.train.step`.

The reference traces the whole step (forward, loss, ``value_and_grad`` and
the optimizer update) into one jitted program that donates its state. The
port runs the same step eagerly: the forward and the loss build an autograd
graph, ``torch.autograd.grad`` takes the gradients (the flash kernels carry
their own backward), and the optimizer updates the parameters and its slots
in place. The step returns the state it was given.

:func:`build_multi_step` runs N steps per call as a Python loop over eager
steps (the counterpart of the reference's ``lax.scan``): the per-step losses
(and, guarded, health rows) stay on the card, stacked, for the caller's one
read. ``jit=`` is accepted and ignored, as by every ``build_*`` function
of the port.

On a state that a sharding policy placed on a mesh of ranks
(:mod:`tpusystem_torch.parallel.sharding`) the same step runs SPMD: each
rank gets its rows of the global batch, gathers the leaves FSDP split
(a gather whose backward reduce-scatters; all of them whole before the
forward, held until the backward ends), differentiates its share of the
global batch's mean loss (``loss * weight / total weight``, the weights
summed over the batch axes, so masked losses stay the global mean), sums
the gradients over the batch axes that do not split the leaf, and updates
its own pieces and slots. The loss it returns is the global one.
:func:`build_1f1b_train_step` raises ``NotImplementedError`` (ROADMAP queue
1, 9d. Pipelines).
"""

from __future__ import annotations

from collections.abc import Callable
from inspect import signature
from typing import Any

import numpy as np
import torch

from tpusystem_torch.ops.threefry import PRNGKey, as_key, split
from tpusystem_torch.parallel.collectives import all_reduce_sum
from tpusystem_torch.parallel.sharding import (gather_leaf, is_placed, local,
                                               local_tree, shard_axes)
from tpusystem_torch.train.optim import masked_update
from tpusystem_torch.train.state import TrainState

# apply_fn contract: (params, inputs, rng, train) -> outputs; rng a threefry
# key (two 32-bit words) or None
ApplyFn = Callable[[dict, Any, tuple | None, bool], Any]
# criterion contract: (outputs, targets) -> scalar loss
Criterion = Callable[[Any, Any], torch.Tensor]


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               f'(ROADMAP queue 1: {item})')


def module_apply(module: torch.nn.Module) -> ApplyFn:
    """Adapt an ``nn.Module`` to the step builders' apply contract (the
    counterpart of ``flax_apply``): the forward runs with ``params`` in
    place of the module's own tensors (``torch.func.functional_call``) and
    gets ``train=`` and ``rng=`` (the step's threefry key, from which
    dropout derives its masks) only when its ``forward`` accepts them."""
    accepted = signature(module.forward).parameters

    def apply(params, inputs, rng=None, train=False):
        kwargs = {'train': train} if 'train' in accepted else {}
        if rng is not None and 'rng' in accepted:
            kwargs['rng'] = rng
        return torch.func.functional_call(module, params, (inputs,), kwargs)

    return apply


def _detach(outputs):
    if isinstance(outputs, torch.Tensor):
        return outputs.detach()
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(_detach(item) for item in outputs)
    return outputs


# the axes a global batch splits over, and its gradients sum over
BATCH_AXES = ('data', 'fsdp')


def sync_grads(grads: list, placed: list, mesh) -> list:
    """Sum each rank's gradients over the batch axes that do not split the
    leaf (a gathered leaf's backward summed over the axes that do): one
    flat all-reduce per set of axes."""
    buckets: dict = {}
    for index, leaf in enumerate(placed):
        split_over = {axis for axes in shard_axes(leaf).values()
                      for axis in axes}
        axes = tuple(axis for axis in BATCH_AXES if axis not in split_over)
        if axes:
            buckets.setdefault(axes, []).append(index)
    grads = list(grads)
    for axes, indices in buckets.items():
        flat = torch.cat([grads[index].reshape(-1).float()
                          for index in indices])
        flat = all_reduce_sum(flat, mesh, axes)
        for index, part in zip(indices, flat.split(
                [grads[index].numel() for index in indices])):
            grads[index] = part.view_as(grads[index]).to(grads[index].dtype)
    return grads


def build_train_step(apply_fn: ApplyFn, criterion: Criterion, optimizer, *,
                     accumulate: int = 1, jit: bool = True, guard=None,
                     fault=None):
    """Build ``step(state, inputs, targets) -> (state, (outputs, loss))``.

    ``optimizer`` is a :class:`tpusystem_torch.train.optim.Optimizer`; it
    updates ``state`` in place, and the step returns that same state with
    its counter advanced. ``outputs`` and ``loss`` are detached.

    ``accumulate=N`` splits the leading batch dimension of ``inputs`` and
    ``targets`` (tensors) into N sequential microbatches, each with its own
    forward and backward, and averages their gradients in float32 before
    the single update. When the criterion has ``weight(targets)`` (the
    masked LM losses return their unmasked-token count), microbatch losses
    and grads are weighted by it, so the result equals the full-batch step
    even when padding gives microbatches different token counts; other
    criteria are averaged equally. The returned ``outputs`` are the last
    microbatch's, ``loss`` the weighted mean. Microbatch ``i`` takes key
    ``i`` of ``split(step key, accumulate)``, as the reference does.

    ``guard=`` (a :class:`tpusystem_torch.train.Guard`) judges each step on
    the card (loss and global-grad-norm finiteness, the EMA spike z-score)
    and suppresses a bad step's update through
    :func:`~tpusystem_torch.train.optim.masked_update`, scaled by
    ``state.health.lr_scale``: no host sync. Arm the state first
    (``guard.arm(state)``). The step counter advances on a suppressed step
    too (the batch was consumed), while the optimizer's count does not.

    ``fault=`` is the chaos seam: ``fault(step, grads, loss) -> (grads,
    loss)`` right after the gradients, ``step`` the 1-based index of the
    step being computed (a tensor on the card), ``grads`` keyed like the
    parameters (:class:`tpusystem_torch.parallel.chaos.CorruptGrads`).

    A placed state (``state.mesh`` a mesh of ranks) takes this rank's rows
    and steps SPMD (the module docstring); ``outputs`` are this rank's, the
    ``fault=`` seam and the guard see this rank's pieces of the summed
    gradients, and the guard's norm is the global one."""
    weight_fn = getattr(criterion, 'weight', None)

    def value_and_grad(leaves, params, inputs, targets, rng):
        outputs = apply_fn(params, inputs, rng, True)
        loss = criterion(outputs, targets)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _detach(outputs), grads

    def step(state: TrainState, inputs, targets):
        if is_placed(state):
            return placed_step(state, inputs, targets)
        rng = state.next_rng()
        names = list(state.params)
        leaves = [state.params[name] for name in names]
        if accumulate == 1:
            loss, outputs, grads = value_and_grad(leaves, state.params,
                                                  inputs, targets, rng)
        else:
            batch = inputs.shape[0]
            if batch % accumulate:
                raise ValueError(f'batch {batch} not divisible by '
                                 f'accumulate={accumulate}')
            size = batch // accumulate
            device = state.step.device
            sums = [torch.zeros_like(leaf, dtype=torch.float32)
                    for leaf in leaves]
            loss_sum = torch.zeros((), device=device)
            weight_sum = torch.zeros((), device=device)
            for micro_inputs, micro_targets, micro_rng in zip(
                    inputs.split(size), targets.split(size),
                    split(rng, accumulate)):
                loss, outputs, grads = value_and_grad(
                    leaves, state.params, micro_inputs, micro_targets,
                    micro_rng)
                weight = (weight_fn(micro_targets).float() if weight_fn
                          else torch.ones((), device=device))
                for total, grad in zip(sums, grads):
                    total.add_(grad.float() * weight)
                loss_sum = loss_sum + loss * weight
                weight_sum = weight_sum + weight
            weight_sum = torch.clamp(weight_sum, min=1e-8)  # all-pad batch
            grads = [(total / weight_sum).to(leaf.dtype)
                     for total, leaf in zip(sums, leaves)]
            loss = loss_sum / weight_sum
        return update(state, names, leaves, state.params, state.opt_state,
                      dict(zip(names, grads)), loss, outputs)

    def update(state, names, leaves, params, opt_state, grads, loss,
               outputs):
        if fault is not None:
            grads, loss = fault(state.step + 1, grads, loss)
        if guard is not None:
            assert state.health is not None, (
                'guard= needs health stats on the TrainState: arm it with '
                'Guard.arm(state) before the first step')
            ok = guard.judge(state.health, loss,
                             [grads[name] for name in names], leaves)
            masked_update(optimizer, grads, opt_state, params, ok,
                          scale=state.health.lr_scale)
        else:
            optimizer.step(params, grads, opt_state)
        state.step += 1
        return state, (outputs, loss)

    def placed_step(state: TrainState, inputs, targets):
        """The step over a state placed on a mesh of ranks: ``inputs`` and
        ``targets`` are this rank's rows of the global batch. The loss
        differentiated is this rank's share of the global batch's mean,
        ``loss * weight / total weight``, so the gradients summed over the
        data-like axes are the global mean's, masked losses included."""
        mesh = state.mesh
        rng = state.next_rng()
        names = list(state.params)
        placed = [state.params[name] for name in names]
        held = [local(leaf) for leaf in placed]
        if accumulate > 1 and inputs.shape[0] % accumulate:
            raise ValueError(f'batch {inputs.shape[0]} not divisible by '
                             f'accumulate={accumulate}')
        micro = (list(zip(inputs.split(inputs.shape[0] // accumulate),
                          targets.split(targets.shape[0] // accumulate),
                          split(rng, accumulate)))
                 if accumulate > 1 else [(inputs, targets, rng)])
        device = state.step.device
        weights = [weight_fn(micro_targets).float() if weight_fn
                   else torch.ones((), device=device)
                   for _, micro_targets, _ in micro]
        total = all_reduce_sum(torch.stack(weights).sum(), mesh, BATCH_AXES)
        total = torch.clamp(total, min=1e-8)         # all-pad batch
        grads, loss = None, torch.zeros((), device=device)
        for (micro_inputs, micro_targets, micro_rng), weight in zip(
                micro, weights):
            leaves = [piece.detach().requires_grad_(piece.is_floating_point())
                      for piece in held]
            params = {name: gather_leaf(leaf, whole, mesh)
                      for name, leaf, whole in zip(names, leaves, placed)}
            outputs = apply_fn(params, micro_inputs, micro_rng, True)
            share = criterion(outputs, micro_targets) * (weight / total)
            found = torch.autograd.grad(share, leaves)
            grads = (list(found) if grads is None
                     else [sum_ + grad for sum_, grad in zip(grads, found)])
            loss = loss + share.detach()
            outputs = _detach(outputs)
        grads = sync_grads(grads, placed, mesh)
        loss = all_reduce_sum(loss, mesh, BATCH_AXES)
        return update(state, names, held, dict(zip(names, held)),
                      local_tree(state.opt_state), dict(zip(names, grads)),
                      loss, outputs)

    return step


def build_eval_step(apply_fn: ApplyFn, criterion: Criterion, *,
                    jit: bool = True):
    """Build ``step(state, inputs, targets) -> (outputs, loss)``: the
    forward in eval mode, without gradients. On a placed state the inputs
    are this rank's rows and the loss is the global batch's."""

    weight_fn = getattr(criterion, 'weight', None)

    @torch.no_grad()
    def step(state: TrainState, inputs, targets):
        if not is_placed(state):
            outputs = apply_fn(state.params, inputs, None, False)
            return outputs, criterion(outputs, targets)
        # a placed state: this rank's rows, the global batch's loss
        mesh = state.mesh
        params = {name: gather_leaf(local(leaf), leaf, mesh)
                  for name, leaf in state.params.items()}
        outputs = apply_fn(params, inputs, None, False)
        weight = (weight_fn(targets).float() if weight_fn
                  else torch.ones((), device=state.step.device))
        total = torch.clamp(all_reduce_sum(weight, mesh, BATCH_AXES),
                            min=1e-8)
        share = criterion(outputs, targets) * (weight / total)
        return outputs, all_reduce_sum(share, mesh, BATCH_AXES)

    return step


def _at(tree, index: int):
    """Row ``index`` of every tensor (or array) of a batch tree."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_at(item, index) for item in tree)
    if isinstance(tree, dict):
        return {key: _at(item, index) for key, item in tree.items()}
    return tree[index]


def _length(tree) -> int:
    if isinstance(tree, (tuple, list)):
        return _length(tree[0])
    if isinstance(tree, dict):
        return _length(next(iter(tree.values())))
    return tree.shape[0]


def build_multi_step(step, *, jit: bool = True, outputs_fn=None,
                     guard: bool = False):
    """N train steps per call (``tpusystem/train/step.py:182``).

    ``multi(state, inputs, targets) -> (state, losses)``: ``inputs`` and
    ``targets`` carry a leading ``[N, ...]`` dimension and ``losses`` is the
    ``[N]`` float32 tensor of the steps' losses, stacked on the card. The N
    steps run as a Python loop over ``step`` (the counterpart of the
    reference's ``lax.scan``); nothing is read back per step, so the caller
    syncs once for the whole group. ``outputs_fn`` (e.g. ``lambda o:
    o.argmax(-1)``) stacks a reduced output per step: the return becomes
    ``(state, (stacked_reduced_outputs, losses))``. ``guard=True`` (a step
    built with ``guard=``) also stacks each step's health row
    (``state.health.last``): ``(state, (losses, health[N, 4]))``, health
    last when ``outputs_fn`` is given too."""

    def multi(state: TrainState, inputs, targets):
        if guard:
            assert state.health is not None, (
                'guard=True needs a guarded step and an armed state '
                '(Guard.arm) — see build_train_step(guard=...)')
        losses, reduced, rows = [], [], []
        for index in range(_length(inputs)):
            state, (outputs, loss) = step(state, _at(inputs, index),
                                          _at(targets, index))
            losses.append(torch.as_tensor(loss).float())
            if outputs_fn is not None:
                reduced.append(outputs_fn(outputs))
            if guard:
                rows.append(state.health.last.clone())
        ys = (torch.stack(losses),)
        if outputs_fn is not None:
            ys = (torch.stack(reduced),) + ys
        if guard:
            ys = ys + (torch.stack(rows),)
        return state, ys[0] if len(ys) == 1 else ys

    return multi


def build_multi_eval_step(step, *, jit: bool = True, outputs_fn=None):
    """Eval counterpart of :func:`build_multi_step`
    (``tpusystem/train/step.py:232``): ``multi(state, inputs, targets) ->
    losses[N]`` (or ``(stacked_reduced_outputs, losses)`` with
    ``outputs_fn``) over stacked batches, ``step`` from
    :func:`build_eval_step`."""

    def multi(state: TrainState, inputs, targets):
        losses, reduced = [], []
        for index in range(_length(inputs)):
            outputs, loss = step(state, _at(inputs, index),
                                 _at(targets, index))
            losses.append(torch.as_tensor(loss).float())
            if outputs_fn is not None:
                reduced.append(outputs_fn(outputs))
        if outputs_fn is None:
            return torch.stack(losses)
        return torch.stack(reduced), torch.stack(losses)

    return multi


def grouped_batches(loader, size: int):
    """Yield tuples of ``[n, batch, ...]`` stacks of up to ``size``
    consecutive batches — the host-side feeder for
    :func:`build_multi_step` (``tpusystem/train/step.py:249``). Accepts
    loaders yielding tuples (``(inputs, targets)``) or bare arrays; the tail
    stack is shorter when the loader's length does not divide ``size``.
    Tensors stack with ``torch.stack`` (on their device), host arrays with
    ``np.stack``."""
    group: list = []

    def flush():
        return tuple(
            torch.stack(parts) if isinstance(parts[0], torch.Tensor)
            else np.stack(parts)
            for parts in zip(*group))

    for batch in loader:
        group.append(batch if isinstance(batch, tuple) else (batch,))
        if len(group) == size:
            yield flush()
            group = []
    if group:
        yield flush()


def build_1f1b_train_step(*args, **kwargs):
    """The 1F1B pipelined train step: not ported yet."""
    raise _not_ported('build_1f1b_train_step',
                      'multi-GPU parallelism, 9d. Pipelines')


def init_state(module: torch.nn.Module, optimizer, *,
               rng=0) -> TrainState:
    """A :class:`TrainState` over ``module``'s own parameters, which the
    step then updates in place: the module's weights are its initialization
    (drawn from a seeded generator when it was built, or loaded with
    ``load_state_dict``) and the optimizer's slots start at zero. ``rng``
    (an int seed or a key) is split as the reference's ``init_state``
    splits it into the init key and the carried key: the state carries the
    second, so a seed gives the reference's dropout stream."""
    params = dict(module.named_parameters())
    key = PRNGKey(rng) if isinstance(rng, int) else as_key(rng)
    return TrainState.create(params, optimizer.init(params), split(key)[1])
