"""Step builders: the port of :mod:`tpusystem.train.step`.

The reference traces the whole step (forward, loss, ``value_and_grad`` and
the optimizer update) into one jitted program that donates its state. The
port runs the same step eagerly: the forward and the loss build an autograd
graph, ``torch.autograd.grad`` takes the gradients (the flash kernels carry
their own backward), and the optimizer updates the parameters and its slots
in place. The step returns the state it was given.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: ``guard=`` and ``fault=`` (the in-step anomaly guard and the chaos
seam), :func:`build_multi_step` and :func:`build_1f1b_train_step`.
"""

from __future__ import annotations

from collections.abc import Callable
from inspect import signature
from typing import Any

import torch

from tpusystem_torch.ops.threefry import PRNGKey, as_key, split
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
                     accumulate: int = 1, guard=None, fault=None):
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
    ``i`` of ``split(step key, accumulate)``, as the reference does."""
    if guard is not None:
        raise _not_ported('build_train_step(guard=)', 'guard and Sentinel')
    if fault is not None:
        raise _not_ported('build_train_step(fault=)', 'guard and Sentinel')
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
        optimizer.step(state.params, dict(zip(names, grads)),
                       state.opt_state)
        state.step += 1
        return state, (outputs, loss)

    return step


def build_eval_step(apply_fn: ApplyFn, criterion: Criterion):
    """Build ``step(state, inputs, targets) -> (outputs, loss)``: the
    forward in eval mode, without gradients."""

    @torch.no_grad()
    def step(state: TrainState, inputs, targets):
        outputs = apply_fn(state.params, inputs, None, False)
        return outputs, criterion(outputs, targets)

    return step


def build_multi_step(*args, **kwargs):
    """N train steps per host dispatch: not ported yet."""
    raise _not_ported('build_multi_step', 'build_multi_step')


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
