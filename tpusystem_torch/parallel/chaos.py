"""Deterministic fault injection for serving: the port of
:mod:`tpusystem.parallel.chaos`, its serving subset.

Copied as they are from the reference:

* :class:`ChaosPick` and :func:`pick_chaos` — the seeded victim and tick
  of one fleet chaos certification
  (:func:`tpusystem_torch.serve.certify_fleet`);
* :class:`WorkerKilled` and :class:`DieAtStep` — a scripted worker death
  at a chosen step (in-process: a raise; cross-process: ``os._exit``);
* :class:`StalledStep` — a scripted serving-step stall at a chosen tick,
  the wedge the step watchdog turns into ``EngineStalled``;
* :class:`PreemptionWave` — several kills fired together at one step.

Not ported yet: ``Faults``, ``ChaosTransport`` and ``ChaosHub`` wrap the
TCP transport and hub (ROADMAP queue 1, 9. Multi-GPU parallelism);
``CorruptGrads``, ``CorruptBatch`` and ``FlipParamBit`` hurt a train step
(8. Checkpoint, recovery, guard and Sentinel); ``TenantChaosPick`` and
``pick_tenant_chaos`` serve the orchestrator (10).
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable

__all__ = ['ChaosPick', 'pick_chaos', 'WorkerKilled', 'DieAtStep',
           'StalledStep', 'PreemptionWave']


@dataclass(frozen=True)
class ChaosPick:
    """One drawn fleet-chaos scenario: kill ``component`` after router
    tick ``step`` (see :func:`pick_chaos`)."""

    component: str
    step: int


def pick_chaos(seed: int, components: tuple[str, ...] | list[str], *,
               lo: int = 1, hi: int = 8) -> ChaosPick:
    """Draw the victim for one fleet chaos-certification run.

    The randomized half of ``certify_fleet`` (the other half is the
    invariant check): a uniformly-chosen component from ``components``
    (router, standby, a prefill or decode replica, the supervisor...) is
    killed after a uniformly-chosen router tick in ``[lo, hi]``. Both
    draws come from one ``random.Random(seed)`` in a fixed order, so a
    seed IS the scenario — a red run replays exactly from its seed, the
    same discipline as the reference's ``Faults``.
    """
    if not components:
        raise ValueError('need at least one component to pick from')
    if lo < 0 or hi < lo:
        raise ValueError(f'need 0 <= lo <= hi, got [{lo}, {hi}]')
    rng = random.Random(seed)
    component = components[rng.randrange(len(components))]
    return ChaosPick(component=component, step=rng.randint(lo, hi))


class WorkerKilled(RuntimeError):
    """In-process stand-in for a worker death (see :class:`DieAtStep`)."""

    def __init__(self, step: int):
        super().__init__(f'worker scripted to die at step {step}')
        self.step = step


@dataclass
class DieAtStep:
    """Scripted worker death at a chosen global step.

    Call it with the just-completed step number from the training loop::

        die = DieAtStep(step=7)                # in-process: raises
        for batch in loader:
            state, _ = step(state, *batch)
            checkpointer.save(identity, state.global_step, state, ...)
            die(state.global_step)

    ``action='raise'`` (default) raises :class:`WorkerKilled` — the
    in-process form, letting a test's "restart" run in the same process.
    ``action='exit'`` calls ``os._exit(code)`` — the cross-process form: no
    'bye' frame, no atexit, no flushing; the genuine article for
    subprocess chaos tests. A callable ``action`` runs verbatim (e.g.
    ``transport.kill`` to sever just the control plane).
    """

    step: int
    action: str | Callable[[], None] = 'raise'
    code: int = 1
    fired: bool = field(default=False, init=False)

    def __call__(self, current_step: int) -> None:
        if self.fired or current_step != self.step:
            return
        self.fired = True
        if callable(self.action):
            self.action()
        elif self.action == 'exit':
            os._exit(self.code)
        else:
            raise WorkerKilled(self.step)


@dataclass
class StalledStep:
    """Scripted serving-step stall at a chosen scheduler tick — the
    hung/anomalously-slow decode the step watchdog
    (:class:`tpusystem_torch.serve.StepWatchdog`) must classify as
    ``EngineStalled`` instead of wedging forever.

    Wire it as a serving loop's fault seam (the 1-based upcoming tick,
    the :class:`DieAtStep` convention)::

        replica = ServingReplica(build, fault=StalledStep(tick=4,
                                                          seconds=2.0))

    ``action`` defaults to a real ``time.sleep(seconds)`` — the genuine
    article for wall-clock watchdogs. Tests pass a callable instead
    (advance a fake clock, or raise the stall directly) so tier-1 drills
    the verdict with zero real sleeps. Fires once.
    """

    tick: int
    seconds: float = 0.0
    action: Callable[[], None] | None = None
    fired: bool = field(default=False, init=False)

    def __call__(self, current_tick: int) -> None:
        if self.fired or current_tick != self.tick:
            return
        self.fired = True
        if self.action is not None:
            self.action()
        else:
            time.sleep(self.seconds)


@dataclass
class PreemptionWave:
    """Scripted multi-host loss at a chosen global step — the elastic
    drill's signature fault: k of n hosts die *together* (a spot-market
    reclaim, a rack power event), and the membership protocol must fold
    every loss into ONE resize (the settle window's job), never one
    resize per host.

    ``kills`` are callables fired in order (``transport.kill`` for a
    control-plane-only death, ``os.kill`` of a worker for the real
    thing, a fleet handle's
    :meth:`~tpusystem_torch.serve.ReplicaHandle.kill` for the serving-fleet
    drill — the router tick is the ``step``); ``stagger`` seconds
    between them models losses spread inside a wave — pick it below the
    coordinator's settle window to assert the one-resize contract,
    above it to drill the two-epoch case (``sleep`` is injectable so a
    fake-clock drill staggers without real waits). Same fired-once
    discipline as :class:`DieAtStep`::

        wave = PreemptionWave(step=5, kills=(t2.kill, t3.kill))
        for batch in loader:
            state, _ = step(state, *batch)
            wave(int(state.step))
    """

    step: int
    kills: tuple = ()
    stagger: float = 0.0
    sleep: Callable[[float], None] = time.sleep
    fired: bool = field(default=False, init=False)

    def __call__(self, current_step: int) -> None:
        if self.fired or current_step != self.step:
            return
        self.fired = True
        for index, kill in enumerate(self.kills):
            if index and self.stagger:
                self.sleep(self.stagger)
            kill()
