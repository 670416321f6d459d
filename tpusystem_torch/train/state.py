"""Training state: the port of :class:`tpusystem.train.state.TrainState`.

The reference's state is an immutable pytree that a jitted step takes and
donates, so its buffers are reused in place. The port's step updates the
state **in place** instead: the parameters (the module's own tensors), the
optimizer's slots and the step counter change where they lie, and the step
returns the same object. The carried PRNG key becomes a ``torch.Generator``
(on the CPU: drawing from it never waits on the card) from which each step
takes a fresh generator. ``health`` (the guard's statistics) is not ported
yet.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ['TrainState', 'split_rng']


def split_rng(generator: torch.Generator, count: int) -> list:
    """``count`` fresh generators seeded from ``generator`` (which advances):
    the counterpart of ``jax.random.split``."""
    seeds = torch.randint(0, 2 ** 62, (count,), generator=generator)
    return [torch.Generator().manual_seed(int(seed)) for seed in seeds]


class TrainState:
    """Parameters, optimizer slots, the carried generator and a step counter
    that lives on the parameters' device (incrementing it never waits on
    the host).

    Attributes:
        params: ``{name: tensor}``, updated in place by the step.
        opt_state: the optimizer's slots (:meth:`Optimizer.init`).
        rng: the carried ``torch.Generator``.
        step: scalar int32 tensor on the parameters' device.
    """

    def __init__(self, params: dict, opt_state: Any, rng: torch.Generator,
                 step: torch.Tensor) -> None:
        self.params, self.opt_state, self.rng, self.step = (
            params, opt_state, rng, step)

    @classmethod
    def create(cls, params: dict, opt_state: Any,
               rng: torch.Generator | int = 0, health: Any = None
               ) -> 'TrainState':
        if health is not None:
            raise _health_not_ported()
        if isinstance(rng, int):
            rng = torch.Generator().manual_seed(rng)
        device = next(iter(params.values())).device
        return cls(params, opt_state, rng,
                   torch.zeros((), dtype=torch.int32, device=device))

    @property
    def health(self):
        raise _health_not_ported()

    def next_rng(self) -> torch.Generator:
        """Advance the carried generator; return a fresh one seeded from
        it (the counterpart of splitting the carried key)."""
        return split_rng(self.rng, 1)[0]

    @property
    def global_step(self) -> int:
        """Host-side view of the step counter (waits on the device:
        checkpoint and logging cadence only, never per step)."""
        return int(self.step)


def _health_not_ported():
    return NotImplementedError('TrainState.health (the guard= statistics) is '
                               'not ported to tpusystem_torch yet (ROADMAP '
                               'queue 1: guard and Sentinel)')
