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
* :class:`PreemptionWave` — several kills fired together at one step;
* the divergence drills, on tensors: :class:`CorruptGrads` (the train
  step's ``fault=`` seam: NaN, Inf or a spike from a step, decided on the
  card), :class:`CorruptBatch` (a window of the batch stream) and
  :class:`FlipParamBit` (one bit of one element, in place).

Not ported yet: ``Faults``, ``ChaosTransport`` and ``ChaosHub`` wrap the
TCP transport and hub (ROADMAP queue 1, 9. Multi-GPU parallelism);
``TenantChaosPick`` and ``pick_tenant_chaos`` serve the orchestrator (10).
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

__all__ = ['ChaosPick', 'pick_chaos', 'WorkerKilled', 'DieAtStep',
           'StalledStep', 'PreemptionWave', 'CorruptGrads', 'CorruptBatch',
           'FlipParamBit']


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


# ---------------------------------------------------------------------------
# internal faults: the divergence-sentinel drill kinds
#
# DieAtStep simulates the process failing as a unit; these simulate the
# *numerics* failing while the process lives — the faults the guard and the
# Sentinel ladder (tpusystem_torch.train.sentinel) must absorb.
# Deterministic (step-indexed, not sampled), so every drill is replayable.


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, value) for value in tree)
    return fn(tree)


@dataclass
class CorruptGrads:
    """Gradient corruption over a step window, decided on the card.

    Pass as ``build_train_step(..., fault=CorruptGrads(step=k))``: it fires
    when the step being computed (1-based, ``state.step + 1``, a tensor)
    falls in ``[step, step + steps)``, selected with ``torch.where`` so no
    host read happens. Keyed on the *step counter*, the fault refires if a
    rollback rewinds the counter into the window; use :class:`CorruptBatch`
    for data-borne corruption that a skip-window escapes.

    Modes: ``'nan'`` / ``'inf'`` poison every gradient leaf; ``'spike'``
    scales the gradients by ``scale`` — finite, so only the EMA z-score
    detector catches it.
    """

    step: int
    steps: int = 1
    mode: str = 'nan'     # 'nan' | 'inf' | 'spike'
    scale: float = 1e4

    def __call__(self, current_step, grads, loss):
        fire = ((current_step >= self.step)
                & (current_step < self.step + self.steps))
        if self.mode == 'spike':
            corrupt = lambda leaf: leaf * self.scale
        elif self.mode in ('nan', 'inf'):
            bad = float('nan') if self.mode == 'nan' else float('inf')
            corrupt = lambda leaf: torch.full_like(leaf, bad)
        else:
            raise ValueError(f"mode must be 'nan', 'inf' or 'spike', "
                             f'got {self.mode!r}')
        return _map(lambda leaf: torch.where(fire, corrupt(leaf), leaf),
                    grads), loss


@dataclass
class CorruptBatch:
    """Host-side data corruption of a window of the batch *stream*: the
    ``batch``-th through ``batch + steps - 1``-th batches fed through this
    injector (1-based count of calls) have their floating leaves replaced
    by ``value``; integer leaves are left alone. Keyed on the data stream,
    not the step counter, so after a rollback's skip-window the poisoned
    batches are never consumed again::

        for inputs, targets in loader:
            inputs = corrupt(inputs)
            state, (_, loss) = step(state, inputs, targets)
    """

    batch: int
    steps: int = 1
    value: float = float('nan')
    fed: int = field(default=0, init=False)

    def __call__(self, batch_tree: Any) -> Any:
        self.fed += 1
        if not (self.batch <= self.fed < self.batch + self.steps):
            return batch_tree

        def poison(leaf):
            leaf = torch.as_tensor(leaf)
            if leaf.is_floating_point():
                return torch.full_like(leaf, self.value)
            return leaf
        return _map(poison, batch_tree)


@dataclass
class FlipParamBit:
    """Silent data corruption: flip bit ``bit`` (LSB-first within the
    element's bytes) of the element at flat ``index`` of parameter leaf
    ``leaf`` (its position in the state dict's order), in place, through an
    integer view of the tensor. The reference flips it on one replica of a
    mesh axis (``replica``, ``axis``); on one device the tensor is the
    replica. ``__call__(params, mesh=None)`` returns ``params``."""

    replica: int = 0
    leaf: int = 0
    index: int = 0
    bit: int = 0
    axis: str = 'data'

    @torch.no_grad()
    def __call__(self, params: Any, mesh: Any = None) -> Any:
        leaves = list(params.values()) if isinstance(params, dict) \
            else list(params)
        target = leaves[self.leaf]
        raw = target.view(-1).view(torch.uint8)
        offset = self.index * target.element_size() + self.bit // 8
        raw[offset] ^= 1 << (self.bit % 8)
        return params
