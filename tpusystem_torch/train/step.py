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
:func:`build_1f1b_train_step` raises ``NotImplementedError`` (ROADMAP queue
1, 9. Multi-GPU parallelism).
"""

from __future__ import annotations

from collections.abc import Callable
from inspect import signature
from typing import Any

import numpy as np
import torch

from tpusystem_torch.ops.threefry import PRNGKey, as_key, split
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
    parameters (:class:`tpusystem_torch.parallel.chaos.CorruptGrads`)."""
    weight_fn = getattr(criterion, 'weight', None)

    def value_and_grad(leaves, params, inputs, targets, rng):
        outputs = apply_fn(params, inputs, rng, True)
        loss = criterion(outputs, targets)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _detach(outputs), grads

    def step(state: TrainState, inputs, targets):
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
        grads = dict(zip(names, grads))
        if fault is not None:
            grads, loss = fault(state.step + 1, grads, loss)
        if guard is not None:
            assert state.health is not None, (
                'guard= needs health stats on the TrainState: arm it with '
                'Guard.arm(state) before the first step')
            ok = guard.judge(state.health, loss,
                             [grads[name] for name in names], leaves)
            masked_update(optimizer, grads, state.opt_state, state.params,
                          ok, scale=state.health.lr_scale)
        else:
            optimizer.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, (outputs, loss)

    return step


def build_eval_step(apply_fn: ApplyFn, criterion: Criterion, *,
                    jit: bool = True):
    """Build ``step(state, inputs, targets) -> (outputs, loss)``: the
    forward in eval mode, without gradients."""

    @torch.no_grad()
    def step(state: TrainState, inputs, targets):
        outputs = apply_fn(state.params, inputs, None, False)
        return outputs, criterion(outputs, targets)

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
    raise _not_ported('build_1f1b_train_step', 'multi-GPU parallelism')


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
