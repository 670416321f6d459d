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
waits on the host.

:func:`masked_update` is the guard's skip (``tpusystem/train/optim.py:26-53``):
every step takes ``ok`` (a bool tensor on the card) and ``scale`` (a
float32 tensor multiplying the updates). The new slots and parameters are
computed into temporaries, one span of leaves at a time (:func:`_runs`),
and ``torch.where(ok, new, old)`` writes them back, so a bad step moves
neither the parameters nor any slot (the count included) and no host read
is needed. The global gradient norm counts a leaf that a scanned model
stacks at a leading layer dimension as its layer slices, in layer order
(:func:`global_norm`), so a scanned model clips as the unrolled one does,
bit for bit.
"""

from __future__ import annotations

import math

import torch

from tpusystem_torch.registry import register


def _norm_units(grads: list, params: list | None) -> list:
    """The tensors whose norms make the global norm: each gradient, except
    that a run of consecutive leaves stacked at a leading layer dimension
    (parameters marked ``stacked``, as a scanned model's are) counts as its
    slices, layer by layer: the order in which the unrolled model's leaves
    come."""
    if params is None or not any(getattr(p, 'stacked', False)
                                 for p in params):
        return list(grads)
    units, run = [], []

    def flush():
        for layer in zip(*(grad.unbind(0) for grad in run)):
            units.extend(layer)
        run.clear()

    for grad, param in zip(grads, params):
        if getattr(param, 'stacked', False):
            if run and run[0].shape[0] != grad.shape[0]:
                flush()
            run.append(grad)
            continue
        flush()
        units.append(grad)
    flush()
    return units


def global_norm(grads: list, params: list | None = None) -> torch.Tensor:
    """optax's ``global_norm`` in float32 on the grads' device: the norm of
    the leaves' norms. With ``params`` (keyed alike) a stacked leaf counts
    as its layer slices (:func:`_norm_units`)."""
    groups = {id(group): group for group in
              (getattr(param, 'shard_group', None) for param in params or ())
              if group is not None}
    if groups:
        return _sharded_norm(grads, params, groups)
    units = _norm_units(grads, params)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(units)))


def _sharded_norm(grads: list, params: list, groups: dict) -> torch.Tensor:
    """The global norm where some leaves are pieces split over ranks (their
    ``shard_group``): each rank's squares of its own pieces summed over
    that group, plus the squares of the whole leaves, counted once."""
    whole = [grad for grad, param in zip(grads, params)
             if getattr(param, 'shard_group', None) is None]
    total = (torch.stack(torch._foreach_norm(whole)).square().sum()
             if whole else torch.zeros((), device=grads[0].device))
    for key, group in groups.items():
        pieces = [grad for grad, param in zip(grads, params)
                  if id(getattr(param, 'shard_group', None)) == key]
        squares = torch.stack(torch._foreach_norm(pieces)).square().sum()
        torch.distributed.all_reduce(squares, group=group)
        total = total + squares
    return total.sqrt()


def clip_by_global_norm(grads: list, max_norm: float,
                        params: list | None = None) -> list:
    """optax's ``clip_by_global_norm``: the grads unchanged when their
    global norm is below ``max_norm``, else each ``g / norm * max_norm``."""
    norm = global_norm(grads, params)
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

    def step(self, params: dict, grads: dict, state: dict, *,
             ok: torch.Tensor | None = None,
             scale: torch.Tensor | None = None) -> None:
        """One update of ``params`` and ``state`` in place, from ``grads``
        keyed like ``params``. With ``ok`` (a bool tensor) the update is
        :func:`masked_update`'s: applied where ``ok`` holds, nothing moved
        where it does not; ``scale`` (with ``ok``) multiplies the
        updates."""
        raise NotImplementedError


def masked_update(optimizer: Optimizer, grads: dict, opt_state: dict,
                  params: dict, ok: torch.Tensor, *,
                  scale: torch.Tensor | None = None) -> None:
    """One optimizer update, suppressed on the card when ``ok`` is False
    (``tpusystem/train/optim.py:26``): the new slots and parameters are
    computed unconditionally and ``torch.where(ok, new, old)`` keeps the old
    ones on a bad step, so a NaN gradient reaches neither the weights nor
    the moments, and nothing waits on the host. ``scale`` (typically
    ``HealthStats.lr_scale``) multiplies the updates: for SGD, Adam and
    AdamW that is the learning rate scaled. Updates ``params`` and
    ``opt_state`` in place (the reference returns them)."""
    optimizer.step(params, grads, opt_state, ok=ok, scale=scale)


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
    return _corrected(mu, nu, count, b1, b2, eps)


def _corrected(mu, nu, count, b1, b2, eps):
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


def _select(ok, news, olds) -> None:
    """``old = where(ok, new, old)`` for each pair, in place."""
    for new, old in zip(news, olds):
        old.copy_(torch.where(ok, new, old))


def _masked_apply(ok, scale, params, updates, step_size) -> None:
    """The masked :func:`_apply` of one span: ``p + ((-lr) * u) * scale``
    into a temporary, selected by ``ok``."""
    deltas = torch._foreach_mul(updates, step_size)
    if scale is not None:
        torch._foreach_mul_(deltas, scale)
    _select(ok, torch._foreach_add(params, deltas), params)


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

    def _updates(self, trace, grads):
        """optax ``trace``: the new trace, in place, and the updates."""
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        if not self.nesterov:
            return trace
        updates = torch._foreach_mul(trace, self.momentum)
        torch._foreach_add_(updates, grads)
        return updates

    @torch.no_grad()
    def step(self, params, grads, state, *, ok=None, scale=None):
        slots = (state['trace'],) if self.momentum else ()
        leaves, grads, *traces = _leaves(params, grads, slots)
        if ok is None:
            updates = (self._updates(traces[0], grads) if self.momentum
                       else grads)
            _apply(leaves, updates, -self.lr)
            state['count'] += 1
            return
        for start, stop in _runs(leaves):
            span = slice(start, stop)
            updates = grads[span]
            if self.momentum:
                trace = torch._foreach_mul(traces[0][span], 1.0)
                updates = self._updates(trace, grads[span])
                _select(ok, trace, traces[0][span])
            _masked_apply(ok, scale, leaves[span], updates, -self.lr)
        state['count'] += ok.int()


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

    weight_decay = 0.0
    grad_clip = 0.0

    def schedule(self):
        return self.lr

    @torch.no_grad()
    def step(self, params, grads, state, *, ok=None, scale=None):
        leaves, grads, mu, nu = _leaves(params, grads,
                                        (state['mu'], state['nu']))
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, leaves)
        schedule = self.schedule()
        step_size = (-schedule(state['count']) if callable(schedule)
                     else -schedule)
        if ok is None:
            state['count'] += 1
            updates = _adam_direction(grads, mu, nu, state['count'],
                                      self.b1, self.b2, self.eps)
            if self.weight_decay:
                torch._foreach_add_(updates, torch._foreach_mul(
                    leaves, self.weight_decay))
            _apply(leaves, updates, step_size)
            return
        count = state['count'] + 1
        for start, stop in _runs(leaves):
            span = slice(start, stop)
            # the moments into temporaries: the old ones must survive a
            # bad step, so nothing is updated before the selection
            new_mu = torch._foreach_mul(mu[span], self.b1)
            torch._foreach_add_(new_mu, torch._foreach_mul(grads[span],
                                                           1 - self.b1))
            new_nu = torch._foreach_mul(nu[span], self.b2)
            squares = torch._foreach_mul(grads[span], grads[span])
            torch._foreach_mul_(squares, 1 - self.b2)
            torch._foreach_add_(new_nu, squares)
            del squares
            updates = _corrected(new_mu, new_nu, count, self.b1, self.b2,
                                 self.eps)
            if self.weight_decay:
                torch._foreach_add_(updates, torch._foreach_mul(
                    leaves[span], self.weight_decay))
            _masked_apply(ok, scale, leaves[span], updates, step_size)
            _select(ok, new_mu, mu[span])
            _select(ok, new_nu, nu[span])
        state['count'] += ok.int()


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
