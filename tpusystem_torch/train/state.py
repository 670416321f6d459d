"""Training state: the port of :class:`tpusystem.train.state.TrainState`.

The reference's state is an immutable pytree that a jitted step takes and
donates, so its buffers are reused in place. The port's step updates the
state **in place** instead: the parameters (the module's own tensors), the
optimizer's slots, the step counter and the guard's statistics change where
they lie, and the step returns the same object. The carried PRNG key is the
reference's threefry key, two 32-bit words held on the host
(:mod:`tpusystem_torch.ops.threefry`: deriving a key never waits on the
card), split each step as the reference splits it.
"""

from __future__ import annotations

from typing import Any

import torch

from tpusystem_torch.ops.threefry import PRNGKey, as_key, split

__all__ = ['TrainState', 'HealthStats', 'resume_extras']

HEALTH_FIELDS = ('ema_norm', 'ema_sq', 'count', 'bad_steps', 'lr_scale',
                 'last')


class HealthStats:
    """Device-side training-health statistics (the ``guard=`` companion,
    ``tpusystem/train/state.py:26-68``): 0-d tensors and the float32[4]
    ``last`` row on the parameters' device, updated in place by the guarded
    step with no host sync.

    Attributes:
        ema_norm: biased EMA of the global gradient norm (healthy steps
            only — an anomaly must not poison the statistic that detects
            it).
        ema_sq: biased EMA of the squared gradient norm (the spike
            z-score's variance source).
        count: healthy steps folded into the EMAs (bias correction and the
            spike detector's warmup gate).
        bad_steps: cumulative count of steps whose update was suppressed.
        lr_scale: multiplier applied to the optimizer's updates, the
            host-side backoff lever (:class:`tpusystem_torch.train.Sentinel`
            halves it in place).
        last: the most recent step's health row ``[ok, loss, grad_norm,
            zscore]`` (columns
            :data:`tpusystem_torch.train.sentinel.HEALTH_COLUMNS`).
    """

    def __init__(self, ema_norm, ema_sq, count, bad_steps, lr_scale,
                 last) -> None:
        self.ema_norm, self.ema_sq, self.count = ema_norm, ema_sq, count
        self.bad_steps, self.lr_scale, self.last = bad_steps, lr_scale, last

    @classmethod
    def create(cls, device=None) -> 'HealthStats':
        def scalar(value, dtype):
            return torch.tensor(value, dtype=dtype, device=device)
        return cls(ema_norm=scalar(0.0, torch.float32),
                   ema_sq=scalar(0.0, torch.float32),
                   count=scalar(0, torch.int32),
                   bad_steps=scalar(0, torch.int32),
                   lr_scale=scalar(1.0, torch.float32),
                   last=torch.tensor([1.0, 0.0, 0.0, 0.0],
                                     dtype=torch.float32, device=device))

    def tensors(self) -> dict:
        """``{field: tensor}`` in the reference's field order."""
        return {name: getattr(self, name) for name in HEALTH_FIELDS}


class TrainState:
    """Parameters, optimizer slots, the carried key, a step counter that
    lives on the parameters' device (incrementing it never waits on the
    host) and, once armed, the guard's :class:`HealthStats`.

    Attributes:
        params: ``{name: tensor}``, updated in place by the step.
        opt_state: the optimizer's slots (:meth:`Optimizer.init`).
        rng: the carried threefry key, ``(k0, k1)``.
        step: scalar int32 tensor on the parameters' device.
        health: :class:`HealthStats` when the state is armed for a guarded
            step (``Guard.arm(state)``), else None.
        mesh: the :class:`~tpusystem_torch.parallel.mesh.Mesh` a sharding
            policy placed the state on (its leaves then DTensors),
            else None.
    """

    def __init__(self, params: dict, opt_state: Any, rng: tuple,
                 step: torch.Tensor, health: HealthStats | None = None
                 ) -> None:
        self.params, self.opt_state, self.rng, self.step = (
            params, opt_state, rng, step)
        self.health = health
        self.mesh = None     # set when a sharding policy places the state

    @classmethod
    def create(cls, params: dict, opt_state: Any,
               rng=0, health: HealthStats | None = None) -> 'TrainState':
        """``rng`` an int seed (``PRNGKey(rng)``) or a key."""
        rng = PRNGKey(rng) if isinstance(rng, int) else as_key(rng)
        device = next(iter(params.values())).device
        return cls(params, opt_state, rng,
                   torch.zeros((), dtype=torch.int32, device=device), health)

    @property
    def device(self) -> torch.device:
        return self.step.device

    def next_rng(self) -> tuple:
        """Split the carried key (``tpusystem/train/state.py:103-106``):
        carry the first half, return the second."""
        self.rng, sub = split(self.rng)
        return sub

    @property
    def global_step(self) -> int:
        """Host-side view of the step counter (waits on the device:
        checkpoint and logging cadence only, never per step)."""
        return int(self.step)


def resume_extras(state: TrainState, loader: Any = None, **extra: Any) -> dict:
    """Host-side resume metadata to ride a checkpoint's ``extras``
    (``tpusystem/train/state.py:115``): the step, the loader's cursor
    (anything with a ``state()`` method) and any extra keyword pairs,
    verbatim::

        ckpt.save(identity, state.global_step, state,
                  extras=resume_extras(state, loader))
        ...
        state, step, extras = ckpt.resume(identity, state)
        loader.seek(extras['cursor'])          # skip consumed batches
    """
    return {'step': int(state.step),
            'cursor': None if loader is None else loader.state(),
            **extra}
