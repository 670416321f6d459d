"""Optimizers as registered entities, with optax's semantics.

The port of :mod:`tpusystem.train.optim`. Each class is a hashable
hyperparameter recipe (registry digest equal to the reference's) that
applies optax's update as plain tensor code over a dict of parameters:
``init(params)`` makes the slots, ``step(params, grads, state)`` updates
parameters and slots **in place** (the reference returns new trees and
donates the old ones; in place keeps one copy on the card). The slots are
``{'count': int32 device tensor, 'mu': {...}, 'nu': {...}}`` (Adam, AdamW)
or ``{'count', 'trace'}`` (SGD with momentum), keyed like the parameters.

Where optax differs from ``torch.optim``, the port follows optax:

* ``clip_by_global_norm`` comes first: ``g`` if the global norm is below
  ``max_norm``, else ``g / norm * max_norm``, with no epsilon;
* bias correction uses the count after its increment;
* ``eps`` is added outside the square root;
* weight decay is added to the update of every leaf (optax's
  ``mask=None``) before the update is scaled by ``-lr``;
* a schedule is read at the count **before** it increments
  (``scale_by_schedule``), so a warmup from 0 makes the first update 0.

Schedules are evaluated in float32 on the count's device: a step never
waits on the host. ``masked_update`` (the guard's in-graph skip) is not
ported yet.
"""

from __future__ import annotations

import math

import torch

from tpusystem_torch.registry import register


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax's ``clip_by_global_norm``: the grads unchanged when their
    global norm is below ``max_norm``, else each ``g / norm * max_norm``."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    trigger = norm < max_norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    return [torch.where(trigger, grad, clip)
            for grad, clip in zip(grads, clipped)]


def warmup_constant(lr: float, warmup_steps: int):
    """optax ``join_schedules([linear_schedule(0, lr, warmup),
    constant_schedule(lr)], [warmup])`` over an int count tensor."""
    def schedule(count):
        frac = 1 - torch.clamp(count, 0, warmup_steps) / warmup_steps
        ramp = (0.0 - lr) * frac + lr
        return torch.where(count < warmup_steps, ramp,
                           torch.full_like(ramp, lr))
    return schedule


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  end_value: float):
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup_steps,
    decay_steps, end_value)`` over an int count tensor."""
    alpha = 0.0 if lr == 0.0 else end_value / lr
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count):
        frac = 1 - torch.clamp(count, 0, warmup_steps) / warmup_steps
        ramp = (0.0 - lr) * frac + lr
        since = torch.clamp(count - warmup_steps, max=cosine_steps).float()
        cosine = 0.5 * (1 + torch.cos(math.pi * since / cosine_steps))
        decayed = lr * ((1 - alpha) * cosine + alpha)
        return torch.where(count < warmup_steps, ramp, decayed)
    return schedule


def _count(params) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _leaves(params, grads, slots=()):
    names = list(params)
    return ([params[name] for name in names], [grads[name] for name in names],
            *([slot[name] for name in names] for slot in slots))


class Optimizer:
    """Base: a named, hashable recipe applied in place."""

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    def step(self, params: dict, grads: dict, state: dict) -> None:
        """One update of ``params`` and ``state`` in place, from ``grads``
        keyed like ``params``."""
        raise NotImplementedError


def _adam_direction(grads, mu, nu, count, b1, b2, eps):
    """optax ``scale_by_adam``: the moments updated in place, and
    ``mu_hat / (sqrt(nu_hat) + eps)`` with the corrections at ``count``
    (already incremented)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    squares = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(squares, 1 - b2)
    torch._foreach_add_(nu, squares)
    exponent = count.float()
    direction = torch._foreach_div(mu, 1 - torch.pow(b1, exponent))
    scale = torch._foreach_div(nu, 1 - torch.pow(b2, exponent))
    torch._foreach_sqrt_(scale)
    torch._foreach_add_(scale, eps)
    torch._foreach_div_(direction, scale)
    return direction


RUN_ELEMENTS = 1 << 28      # 1 GiB of float32 updates per _apply run


def _runs(leaves):
    """``(start, stop)`` spans of consecutive leaves holding at most
    :data:`RUN_ELEMENTS` elements together (a larger leaf alone)."""
    start, size = 0, 0
    for index, leaf in enumerate(leaves):
        if index > start and size + leaf.numel() > RUN_ELEMENTS:
            yield start, index
            start, size = index, 0
        size += leaf.numel()
    if start < len(leaves):
        yield start, len(leaves)


def _apply(params, updates, step_size) -> None:
    """optax ``scale_by_learning_rate`` then ``apply_updates``:
    ``p + (-lr) * u``. It runs over spans of leaves (:func:`_runs`), so the
    temporary ``-lr * u`` holds at most one span, not a copy of every
    update: a recommender's tables fill a fifth of the card."""
    for start, stop in _runs(params):
        torch._foreach_add_(params[start:stop], torch._foreach_mul(
            updates[start:stop], step_size))


@register
class SGD(Optimizer):
    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False):
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov

    def init(self, params):
        state = {'count': _count(params)}
        if self.momentum:
            state['trace'] = {name: torch.zeros_like(leaf)
                              for name, leaf in params.items()}
        return state

    @torch.no_grad()
    def step(self, params, grads, state):
        if self.momentum:
            leaves, grads, trace = _leaves(params, grads, (state['trace'],))
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = trace
            if self.nesterov:
                updates = torch._foreach_mul(trace, self.momentum)
                torch._foreach_add_(updates, grads)
        else:
            leaves, updates = _leaves(params, grads)
        _apply(leaves, updates, -self.lr)
        state['count'] += 1


@register
class Adam(Optimizer):
    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        return {'count': _count(params),
                'mu': {name: torch.zeros_like(leaf)
                       for name, leaf in params.items()},
                'nu': {name: torch.zeros_like(leaf)
                       for name, leaf in params.items()}}

    @torch.no_grad()
    def step(self, params, grads, state):
        leaves, grads, mu, nu = _leaves(params, grads,
                                        (state['mu'], state['nu']))
        state['count'] += 1
        updates = _adam_direction(grads, mu, nu, state['count'], self.b1,
                                  self.b2, self.eps)
        _apply(leaves, updates, -self.lr)


@register
class AdamW(Adam):
    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 grad_clip: float = 0.0, warmup_steps: int = 0,
                 decay_steps: int = 0, min_lr_ratio: float = 0.1):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps
        self.min_lr_ratio = min_lr_ratio

    def schedule(self):
        """The learning rate: a float, or a function of the int count
        tensor (warmup then constant, or warmup then cosine decay to
        ``lr * min_lr_ratio``), as the reference's ``AdamW.schedule``."""
        if not self.warmup_steps and not self.decay_steps:
            return self.lr
        if self.warmup_steps and not self.decay_steps:
            return warmup_constant(self.lr, self.warmup_steps)
        return warmup_cosine(self.lr, max(self.warmup_steps, 1),
                             max(self.decay_steps, self.warmup_steps + 1),
                             self.lr * self.min_lr_ratio)

    @torch.no_grad()
    def step(self, params, grads, state):
        leaves, grads, mu, nu = _leaves(params, grads,
                                        (state['mu'], state['nu']))
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        schedule = self.schedule()
        step_size = (-schedule(state['count']) if callable(schedule)
                     else -schedule)
        state['count'] += 1
        updates = _adam_direction(grads, mu, nu, state['count'], self.b1,
                                  self.b2, self.eps)
        torch._foreach_add_(updates,
                            torch._foreach_mul(leaves, self.weight_decay))
        _apply(leaves, updates, step_size)
