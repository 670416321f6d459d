"""Training state: the port of :class:`tpusystem.train.state.TrainState`.

The reference's state is an immutable pytree that a jitted step takes and
donates, so its buffers are reused in place. The port's step updates the
state **in place** instead: the parameters (the module's own tensors), the
optimizer's slots and the step counter change where they lie, and the step
returns the same object. The carried PRNG key is the reference's threefry
key, two 32-bit words held on the host (:mod:`tpusystem_torch.ops.threefry`:
deriving a key never waits on the card), split each step as the reference
splits it. ``health`` (the guard's statistics) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from tpusystem_torch.ops.threefry import PRNGKey, as_key, split

__all__ = ['TrainState']


class TrainState:
    """Parameters, optimizer slots, the carried key and a step counter
    that lives on the parameters' device (incrementing it never waits on
    the host).

    Attributes:
        params: ``{name: tensor}``, updated in place by the step.
        opt_state: the optimizer's slots (:meth:`Optimizer.init`).
        rng: the carried threefry key, ``(k0, k1)``.
        step: scalar int32 tensor on the parameters' device.
    """

    def __init__(self, params: dict, opt_state: Any, rng: tuple,
                 step: torch.Tensor) -> None:
        self.params, self.opt_state, self.rng, self.step = (
            params, opt_state, rng, step)

    @classmethod
    def create(cls, params: dict, opt_state: Any,
               rng=0, health: Any = None) -> 'TrainState':
        """``rng`` an int seed (``PRNGKey(rng)``) or a key."""
        if health is not None:
            raise _health_not_ported()
        rng = PRNGKey(rng) if isinstance(rng, int) else as_key(rng)
        device = next(iter(params.values())).device
        return cls(params, opt_state, rng,
                   torch.zeros((), dtype=torch.int32, device=device))

    @property
    def health(self):
        raise _health_not_ported()

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


def _health_not_ported():
    return NotImplementedError('TrainState.health (the guard= statistics) is '
                               'not ported to tpusystem_torch yet (ROADMAP '
                               'queue 1: guard and Sentinel)')
