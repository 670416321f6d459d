"""Deterministic fault injection: the port of :mod:`tpusystem.parallel.chaos`.

Copied as they are from the reference:

* :class:`Faults`, :class:`ChaosTransport` and :class:`ChaosHub` — the real
  :class:`~tpusystem_torch.parallel.multihost.TcpTransport` / ``Hub`` stack
  with seeded, deterministic faults on its frames: dropped, delayed or
  truncated frames, heartbeat stalls, an abrupt socket death
  (``ChaosTransport.kill``). Every fault decision is drawn in frame order
  from one ``random.Random(seed)`` per :class:`Faults`, so the same seed
  gives the same faults;
* :class:`ChaosPick` and :func:`pick_chaos` — the seeded victim and tick
  of one fleet chaos certification
  (:func:`tpusystem_torch.serve.certify_fleet`); :class:`TenantChaosPick`
  and :func:`pick_tenant_chaos` — the same one level up, a tenant first
  (:func:`tpusystem_torch.orchestrator.certify_tenants`);
* :class:`WorkerKilled` and :class:`DieAtStep` — a scripted worker death
  at a chosen step (in-process: a raise; cross-process: ``os._exit``);
* :class:`StalledStep` — a scripted serving-step stall at a chosen tick,
  the wedge the step watchdog turns into ``EngineStalled``;
* :class:`PreemptionWave` — several kills fired together at one step;
* the divergence drills, on tensors: :class:`CorruptGrads` (the train
  step's ``fault=`` seam: NaN, Inf or a spike from a step, decided on the
  card), :class:`CorruptBatch` (a window of the batch stream) and
  :class:`FlipParamBit` (one bit of one element, in place).

The frame faults are control-plane only, by design: the data plane fails
as a unit with the process, which is exactly what :class:`DieAtStep`
simulates.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from tpusystem_torch.parallel.multihost import Hub, TcpTransport

__all__ = ['Faults', 'ChaosTransport', 'ChaosHub', 'DieAtStep', 'WorkerKilled',
           'PreemptionWave', 'StalledStep', 'CorruptGrads', 'CorruptBatch',
           'FlipParamBit', 'ChaosPick', 'pick_chaos', 'TenantChaosPick',
           'pick_tenant_chaos']


@dataclass
class Faults:
    """Seeded fault plan consulted once per frame, in send order.

    Args:
        seed: the determinism anchor — same seed, same decisions.
        drop: probability a matching frame is silently discarded.
        delay: probability a matching frame is held for ``delay_seconds``.
        delay_seconds: hold time for delayed frames.
        truncate: probability a matching ``blob`` chunk frame is sent with
            half its payload cut off — the torn-transfer signature the
            receiver's whole-blob digest must catch (non-blob frames treat
            a truncate verdict as a pass; the pickle framing would turn a
            torn control frame into a socket death, which ``kill()``
            already scripts precisely).
        kinds: frame kinds eligible for faults (None: every kind not in
            ``spare``). Transport frame kinds: ``event``, ``reduce``,
            ``gather``, ``hb``, plus the blob plane's ``blob`` /
            ``blob-req`` / ``blob-nak``; hub fanout kinds add ``result``,
            ``lost``, ``joined``.
        spare: kinds never faulted. By default: handshake/teardown frames
            (drop those and a scenario tests the dialer's retry loop,
            usually not what it meant); ``result`` (dropping a collective's
            result fanout wedges every waiting rank into its full timeout
            — target it explicitly via ``kinds`` when a scenario wants
            that); and ``hb``: heartbeats ride their own thread, so
            probabilistic faults on them would interleave RNG draws
            scheduler-dependently and break the same-seed-same-faults
            contract — fault heartbeats with the *scripted*
            :meth:`stall_heartbeats` instead.
    """

    seed: int = 0
    drop: float = 0.0
    delay: float = 0.0
    delay_seconds: float = 0.02
    truncate: float = 0.0
    kinds: tuple[str, ...] | None = None
    spare: tuple[str, ...] = ('hello', 'bye', 'peer', 'standby', 'rejected',
                              'result', 'hb')

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._stall_until = 0.0
        self.dropped: list[str] = []    # observability for assertions
        self.delayed: list[str] = []
        self.truncated: list[str] = []

    def verdict(self, kind: str) -> str:
        """One decision: ``'drop'`` | ``'delay'`` | ``'truncate'`` |
        ``'pass'``.

        An explicit ``kinds`` list overrides ``spare`` — naming a kind is
        the opt-in for faulting even default-spared traffic (``result``,
        ``hb``). Draws are taken for every eligible frame whether or not a
        fault fires, so the decision stream depends only on the frame
        sequence — not on which probabilities are enabled."""
        if self.kinds is not None:
            if kind not in self.kinds:
                return 'pass'
        elif kind in self.spare:
            return 'pass'
        with self._lock:
            roll = self._rng.random()
            if roll < self.drop:
                self.dropped.append(kind)
                return 'drop'
            if roll < self.drop + self.delay:
                self.delayed.append(kind)
                return 'delay'
            if roll < self.drop + self.delay + self.truncate:
                self.truncated.append(kind)
                return 'truncate'
        return 'pass'

    def decide(self, kind: str) -> float | None:
        """Verdict as the legacy drop/delay encoding: None = drop the
        frame, 0.0 = pass, >0 = delay. (A ``truncate`` verdict on a
        non-blob path reads as pass — only :class:`ChaosTransport`'s blob
        frames can act on it.)"""
        verdict = self.verdict(kind)
        if verdict == 'drop':
            return None
        if verdict == 'delay':
            return self.delay_seconds
        return 0.0

    def stall_heartbeats(self, seconds: float) -> None:
        """Swallow outbound heartbeats for ``seconds`` — a host that is
        alive but unresponsive (GC pause, hung NFS, overloaded NIC), the
        scenario the hub's liveness timeout must classify as lost."""
        with self._lock:
            self._stall_until = time.monotonic() + seconds

    @property
    def heartbeats_stalled(self) -> bool:
        with self._lock:
            return time.monotonic() < self._stall_until


class ChaosTransport(TcpTransport):
    """A :class:`TcpTransport` whose outbound frames pass through a
    :class:`Faults` plan. The wire protocol, hub, and recovery machinery
    are the real ones — only the network misbehaves."""

    def __init__(self, address, rank: int, size: int, *,
                 faults: Faults | None = None, **kwargs: Any):
        self.faults = faults if faults is not None else Faults()
        super().__init__(address, rank, size, **kwargs)

    def _send(self, frame: tuple, op_key: tuple | None = None) -> None:
        kind = frame[0]
        if kind == 'hb' and self.faults.heartbeats_stalled:
            return                       # the beat never leaves the host
        verdict = self.faults.verdict(kind)
        if verdict == 'drop':
            return                       # dropped on the (virtual) wire
        if verdict == 'delay':
            time.sleep(self.faults.delay_seconds)
        if verdict == 'truncate' and kind == 'blob':
            # half the chunk's bytes never make it: the reassembled blob
            # fails its whole-blob digest at the receiver
            chunk = frame[-1]
            frame = frame[:-1] + (chunk[:len(chunk) // 2],)
        super()._send(frame, op_key)

    def kill(self) -> None:
        """Abrupt socket death — the crashed-host signature the hub must
        classify as a loss (EOF with no 'bye'), usable mid-collective.

        Unlike :meth:`close`, nothing is flushed and no teardown runs: the
        transport object stays around exactly like the OS socket of a
        SIGKILLed process would."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class ChaosHub(Hub):
    """A :class:`Hub` whose fanout passes through a :class:`Faults` plan —
    faults on the router's side of the star (results and loss broadcasts
    included, when ``kinds`` says so)."""

    def __init__(self, size: int, *, faults: Faults | None = None,
                 **kwargs: Any):
        self.faults = faults if faults is not None else Faults()
        super().__init__(size, **kwargs)

    def _fanout(self, frame: tuple, exclude: int | None = None,
                live_only: bool = False) -> None:
        verdict = self.faults.decide(frame[0])
        if verdict is None:
            return
        if verdict > 0:
            time.sleep(verdict)
        super()._fanout(frame, exclude=exclude, live_only=live_only)


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
    same discipline as :class:`Faults`.
    """
    if not components:
        raise ValueError('need at least one component to pick from')
    if lo < 0 or hi < lo:
        raise ValueError(f'need 0 <= lo <= hi, got [{lo}, {hi}]')
    rng = random.Random(seed)
    component = components[rng.randrange(len(components))]
    return ChaosPick(component=component, step=rng.randint(lo, hi))


@dataclass(frozen=True)
class TenantChaosPick:
    """One drawn multi-tenant chaos scenario: inside ``tenant``, kill
    ``component`` after orchestrator tick ``step`` (see
    :func:`pick_tenant_chaos`)."""

    tenant: str
    component: str
    step: int


def pick_tenant_chaos(seed: int, tenants: tuple[str, ...] | list[str],
                      components: tuple[str, ...] | list[str], *,
                      lo: int = 1, hi: int = 8) -> TenantChaosPick:
    """Draw the victim for one multi-tenant chaos-certification run —
    :func:`pick_chaos` lifted one level: a uniformly-chosen tenant, then
    a uniformly-chosen component inside it, then a uniformly-chosen
    kill tick in ``[lo, hi]``. All three draws come from one
    ``random.Random(seed)`` in that fixed order, so a seed IS the
    scenario and a red cross-tenant drill replays exactly from it."""
    if not tenants:
        raise ValueError('need at least one tenant to pick from')
    if not components:
        raise ValueError('need at least one component to pick from')
    if lo < 0 or hi < lo:
        raise ValueError(f'need 0 <= lo <= hi, got [{lo}, {hi}]')
    rng = random.Random(seed)
    tenant = tenants[rng.randrange(len(tenants))]
    component = components[rng.randrange(len(components))]
    return TenantChaosPick(tenant=tenant, component=component,
                           step=rng.randint(lo, hi))


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
    ``leaf`` (its position in the params dict's order) on ONE replica of a
    mesh axis: the rank at coordinate ``replica`` on ``axis`` and 0 on
    every other axis flips it in its own piece of the leaf (its local
    shard), in place, through an integer view; every other rank keeps the
    original. One device, one element, one bit, as the reference's
    (``chaos.py:490``). Every rank calls it; on a one-device mesh (or with
    no mesh) the tensor is the replica. Returns ``params``."""

    replica: int = 0
    leaf: int = 0
    index: int = 0
    bit: int = 0
    axis: str = 'data'

    @torch.no_grad()
    def __call__(self, params: Any, mesh: Any = None) -> Any:
        if mesh is not None and getattr(mesh, 'distributed', False):
            victim = mesh.ranks[tuple(
                self.replica if name == self.axis else 0
                for name in mesh.axis_names)]
            if mesh.rank != int(victim):
                return params
        leaves = list(params.values()) if isinstance(params, dict) \
            else list(params)
        target = leaves[self.leaf]
        if hasattr(target, 'to_local'):
            target = target.to_local()
        raw = target.view(-1).view(torch.uint8)
        offset = self.index * target.element_size() + self.bit // 8
        raw[offset] ^= 1 << (self.bit % 8)
        return params
