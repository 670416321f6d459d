"""Serving survives the chaos drill: the port of
:mod:`tpusystem.serve.failover` (journal, replay, watchdog, shedding).

The training side has a complete survival story — chaos-tested control
plane, divergence sentinel, supervised hot restore, elastic resize — but
until now a SIGKILL'd serving engine lost every queued and in-flight
request, a hung decode step wedged forever, and overload was handled
only by ``Saturated`` at submit. This module is the serving replica's
survival layer, built on the machinery that already exists:

* **Request journal** (:class:`RequestJournal`) — every submission
  records ``(request, waited)`` and every tick appends each active row's
  emitted-token delta. Tokens only: the journal is tiny (ints, not KV
  state), so it can be pushed **out of the worker process** at a
  configurable cadence — to the supervisor's in-memory store over the
  existing :class:`~tpusystem.checkpoint.memstore.MemStoreClient` wire,
  under the new identity namespace ``journal:{identity}``
  (:func:`journal_identity`). The supervisor's buddy replication then
  mirrors it cross-host over ``send_blob``/``fetch_blob`` exactly like
  hot training state — the MemStore/buddy discipline, inherited for
  free. Every packed journal carries its own digest
  (:meth:`RequestJournal.pack`), so a torn copy reads as absent
  (:exc:`JournalCorrupt`), never as requests.
* **Replay** (:func:`replay`) — a relaunched engine rebuilds its batch
  by re-queueing each journaled request with its emitted prefix; the
  scheduler re-prefills ``prompt + prefix`` and resumes decode. Greedy
  and seeded sampled decode are both deterministic (counter-based
  sampling: token at stream position ``p`` is a pure function of the
  request's seed and ``p``), so the final completion (prefix + resumed
  tokens) is **token-exact** against an uninterrupted reference — the
  headline drill of ``tests/test_serve_failover.py`` and the SIGKILL
  stage of ``__graft_entry__.dryrun_multichip``. A row the journal only
  knew as queued re-submits cold (full re-prefill) — still token-exact,
  just more work; an unrecoverable journal degrades to serving new
  traffic, never a crash.
* **Step watchdog** (:class:`StepWatchdog`) — a hung or anomalously slow
  decode step becomes a typed :exc:`EngineStalled` instead of a silent
  wedge: restart-and-replay is the remedy, the same relaunch path a kill
  takes. For a step that never returns at all, :meth:`StepWatchdog.guard`
  arms a deadman timer that exits the worker with the restart contract's
  worker-lost code so the :class:`~tpusystem.parallel.Supervisor`
  relaunches it (the 42/43/1 exit table — docs/multihost.md).
* **Load shedding** (:class:`Watermarks`) — admission control grows
  high/low queue watermarks: past ``high`` the scheduler sheds queued
  requests down to ``low``, picking victims by **deadline slack** (the
  request that will expire anyway goes first; an active, almost-done row
  is never shed), narrated as typed ``LoadShed`` + ``Backpressure``
  events instead of silent unbounded backlog.

:class:`ServingReplica` ties it together for one replica: a supervised
serving loop that journals every tick, watches the step clock, and on a
stall — or at construction, when a journal is recoverable (the
relaunched-worker path) — rebuilds the engine and replays. Everything is
narrated on the bus (``RequestReplayed`` / ``EngineRestarted`` /
``LoadShed``) and charted by the TensorBoard consumer
(``serve/recovery_seconds|replayed|shed``).

Determinism: replay is token-exact for greedy AND seeded sampled
decode. The sampling counter is a pure function of ``(seed, position)``
(:func:`tpusystem_torch.train.generate.sampling_key`), so no RNG state needs
journaling beyond what the journal already holds — the emitted prefix IS
the position. A pre-sampling packed journal (no ``sampling`` field on
its requests) unpacks as greedy (:meth:`RequestJournal.unpack`).

The port copies the reference. ``client=`` takes the port's in-process
:class:`~tpusystem_torch.checkpoint.MemStore` or the supervisor's
:class:`~tpusystem_torch.checkpoint.MemStoreClient`; ``recorder=`` takes
an :class:`~tpusystem_torch.observe.FlightRecorder`. A pickled journal row names its request's
class by module, so the port's packed journals differ in bytes (and
digest) from the reference's for the same rows.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import threading
import time
from typing import Any, Callable

# the shared digest primitive, imported exactly the way memstore.py
# imports it: the PUBLIC wrapper (checkpoint.memstore.blob_digest) lives
# behind the orbax-taxed checkpoint package import, which a client-less
# serving replica must not pay — all three digest call sites (transport
# blob frames, memstore slots, journal packs) deliberately share this one
# underscore seam so "verified" can never mean two different things
from tpusystem_torch.parallel.multihost import _blob_digest
from tpusystem_torch.parallel.recovery import LOST_WORKER_EXIT

logger = logging.getLogger('tpusystem_torch.serve.failover')

__all__ = ['EngineStalled', 'JournalCorrupt', 'journal_identity',
           'JournalRow', 'RequestJournal', 'recover_journal', 'replay',
           'ReplayReport', 'StepWatchdog', 'Watermarks', 'ServingReplica',
           'router_identity', 'RouterJournal', 'recover_router_journal']


class EngineStalled(RuntimeError):
    """A decode step hung or ran anomalously slow — the serving
    equivalent of a lost worker. The remedy is the relaunch path a kill
    takes: rebuild the engine, replay the journal. Supervised workers map
    it to the restart contract's worker-lost exit (42) so the
    :class:`~tpusystem.parallel.Supervisor` relaunches them."""

    def __init__(self, seconds: float, threshold: float, kind: str):
        super().__init__(
            f'decode step took {seconds:.3f}s against a {threshold:.3f}s '
            f'{kind} threshold — treating the engine as stalled; restart '
            f'and replay the request journal')
        self.seconds = seconds
        self.threshold = threshold
        self.kind = kind                  # 'stall' | 'slow'


class JournalCorrupt(ValueError):
    """Packed journal bytes failed their digest or shape check — the
    copy reads as absent (recovery falls to the next replica or to cold),
    never as requests."""


def journal_identity(identity: str) -> str:
    """The memstore identity a replica's journal travels under. A
    distinct namespace (``journal:{identity}``) keeps journal pushes from
    ever colliding with the same identity's hot *training-state* slots,
    while riding the identical push/replicate/pull machinery — the
    supervisor's buddy replication and replaced-host pull work on it
    unchanged (the ``replica:``/``hot:``/``own:`` key discipline of
    :mod:`tpusystem.parallel.supervisor`)."""
    return f'journal:{identity}'


# ---------------------------------------------------------------------------
# the journal


@dataclasses.dataclass
class JournalRow:
    """One request's survival record: the request itself, when it was
    submitted (scheduler clock; packed as *waited seconds* so the record
    stays meaningful across a process boundary — monotonic clocks do not
    compare between processes), and every token emitted so far. There is
    deliberately no seated flag: a row with emitted tokens was seated by
    construction (admission emits the first token), so the derived fact
    ``bool(emitted)`` is the one source of truth."""

    request: Any
    submitted: float
    emitted: list = dataclasses.field(default_factory=list)


class RequestJournal:
    """In-memory request journal with out-of-process replication.

    The scheduler drives it through five hooks (``record`` at submit,
    ``seated`` + ``append`` as tokens emit, ``finished`` at any terminal
    transition, ``restored`` when replay re-queues a row) and calls
    :meth:`observe_tick` once per scheduler step — which packs and pushes
    the journal to ``client`` every ``cadence`` ticks. ``cadence`` is the
    durability window: a kill can lose at most the last ``cadence - 1``
    ticks of token deltas, and replay simply re-decodes them (greedy
    and seeded sampled decode are deterministic, so the outcome is
    unchanged — only the recovery does more work).

    ``client`` is anything with the memstore read/write surface: a
    :class:`~tpusystem.checkpoint.memstore.MemStoreClient` (the
    supervised worker's wire), a bare
    :class:`~tpusystem_torch.checkpoint.memstore.MemStore` (the in-process
    drills), or None (journaling off — the scheduler runs exactly as
    before). Push failures degrade and log once — the journal is a
    recovery accelerator, never allowed to take serving down.
    """

    def __init__(self, identity: str = 'serve', *, client: Any = None,
                 cadence: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if cadence < 1:
            raise ValueError(f'cadence must be >= 1 ticks, got {cadence}')
        self.identity = identity
        self.client = client
        self.cadence = cadence
        self.rows: dict[str, JournalRow] = {}
        self.tick = 0                 # monotonic across relaunches (seeded
        self.pushes = 0               # from the recovered journal's tick)
        self._clock = clock
        self._push_failed = False

    # ---------------------------------------------------------- hooks

    def record(self, request: Any, submitted: float) -> None:
        self.rows[request.id] = JournalRow(request, submitted)

    def restored(self, request: Any, submitted: float,
                 emitted: list) -> None:
        """Replay re-queued a journaled row: pre-seed its emitted prefix
        so the next ``seated``/``append`` hooks extend it instead of
        restarting the record."""
        self.rows[request.id] = JournalRow(request, submitted,
                                           emitted=list(emitted))

    def append(self, request_id: str, token: int) -> None:
        row = self.rows.get(request_id)
        if row is not None:
            row.emitted.append(int(token))

    # the admission-token hook: same record as a decode emission (a row
    # with any emitted token is seated by construction), named so the
    # scheduler's call sites read as the lifecycle they witness
    seated = append

    def finished(self, request_id: str) -> None:
        self.rows.pop(request_id, None)

    # ---------------------------------------------------- pack / wire

    def pack(self) -> bytes:
        """The journal as digest-prefixed bytes. Rows pack in FIFO
        submission order with ``submitted`` converted to waited-seconds
        (clock-portable across a relaunch)."""
        now = self._clock()
        rows = [(row.request, now - row.submitted, list(row.emitted))
                for row in self.rows.values()]
        payload = pickle.dumps((self.tick, rows),
                               protocol=pickle.HIGHEST_PROTOCOL)
        return _blob_digest(payload).encode('ascii') + b':' + payload

    @staticmethod
    def unpack(data: bytes) -> tuple[int, list]:
        """``(tick, [(request, waited, emitted), ...])`` from
        :meth:`pack` bytes; raises :exc:`JournalCorrupt` when the digest
        or shape does not verify. A journal packed before sampling
        existed carries requests with no ``sampling`` attribute in their
        pickled ``__dict__`` — those normalize to ``sampling = None``
        (greedy), so an upgrade mid-incident replays an old journal
        token-exactly instead of crashing on the missing field."""
        digest, sep, payload = bytes(data).partition(b':')
        if not sep or _blob_digest(payload).encode('ascii') != digest:
            raise JournalCorrupt(
                'journal bytes failed their digest check — torn or '
                'corrupted copy; treating as absent')
        try:
            tick, rows = pickle.loads(payload)
            rows = [(request, float(waited), list(emitted))
                    for request, waited, emitted in rows]
            for request, _, _ in rows:
                # instance __dict__, not hasattr: the dataclass default
                # is a class attribute, so hasattr is always True
                if 'sampling' not in vars(request):
                    request.sampling = None       # pre-sampling journal
        except Exception as error:
            raise JournalCorrupt(
                f'journal payload does not decode ({error}); treating as '
                f'absent') from error
        return int(tick), rows

    def observe_tick(self) -> None:
        """One scheduler step elapsed: advance the tick and replicate at
        the cadence. The tick is journal-owned (NOT the scheduler's step
        counter, which restarts at relaunch) so pushes stay monotonic
        across relaunches — the memstore slot discipline requires it."""
        self.tick += 1
        if self.client is None or self.tick % self.cadence:
            return
        self.replicate()

    def replicate(self) -> bool:
        """Push the packed journal now (also called directly for an
        off-cadence flush, e.g. right before a planned drain)."""
        if self.client is None:
            return False
        packed = self.pack()
        why = 'push not acknowledged'
        try:
            push = getattr(self.client, 'push', None)
            if push is not None:
                ok = bool(push(journal_identity(self.identity), self.tick,
                               packed))
            else:             # bare MemStore (in-process drills, bench)
                self.client.put(journal_identity(self.identity), self.tick,
                                packed)
                ok = True
        except (OSError, ValueError) as error:
            ok, why = False, str(error)
        if ok:
            self.pushes += 1
            if self._push_failed:    # the store healed (e.g. the client
                # redialed a restarted supervisor): say so once, so an
                # incident's log shows WHERE the durability window closed
                logger.info('journal replication for %r recovered at tick '
                            '%d', self.identity, self.tick)
            self._push_failed = False
        else:
            if not self._push_failed:
                logger.warning(
                    'journal replication for %r failed at tick %d (%s); '
                    'serving continues — a kill now replays from the last '
                    'verified copy', self.identity, self.tick, why)
            self._push_failed = True
        return ok


def recover_journal(identity: str, clients: Any) -> tuple[int, list] | None:
    """Fetch and verify the newest journal for ``identity`` from the
    first client that has an intact copy — ``clients`` in preference
    order (local supervisor first, then explicit fallbacks; the
    supervisor's own buddy pull already hides behind the first fetch on a
    replaced host). Returns :meth:`RequestJournal.unpack`'s
    ``(tick, rows)`` or None — a corrupt copy logs and falls through to
    the next client, never restores."""
    for client in clients:
        if client is None:
            continue
        try:
            entry = client.fetch(journal_identity(identity))
        except OSError as error:
            logger.warning('journal fetch for %r failed (%s); trying the '
                           'next replica', identity, error)
            continue
        if entry is None:
            continue
        try:
            return RequestJournal.unpack(entry.blob)
        except JournalCorrupt as error:
            logger.warning('journal for %r at tick %d rejected (%s); '
                           'trying the next replica', identity,
                           getattr(entry, 'step', -1), error)
    return None


# ---------------------------------------------------------------------------
# the router journal — same framing and wire discipline as the request
# journal, different schema: the router's authoritative fleet state


def router_identity(name: str = 'router') -> str:
    """The memstore identity a router's state journal travels under —
    its own namespace (``router:{name}``) beside ``journal:{identity}``,
    riding the identical push/replicate/buddy machinery."""
    return f'router:{name}'


class RouterJournal:
    """The fleet router's crash journal: placements, orphans, in-flight
    handoffs, settled completions, brownout/cooldown flags — everything a
    relaunched (or standby-takeover) router needs to rebuild without
    asking clients to resubmit.

    The schema is the router's business (:meth:`tpusystem_torch.serve.fleet.
    Router.snapshot` builds the state dict, with timestamps converted to
    clock-portable waited-seconds at pack time); this class owns only the
    :class:`RequestJournal` disciplines — digest-framed pickle so a torn
    copy reads as absent (:exc:`JournalCorrupt`), a journal-owned
    monotonic tick so pushes never regress in the store, cadence-gated
    replication with log-once degrade (the journal is a recovery
    accelerator, never allowed to take routing down).
    """

    def __init__(self, name: str = 'router', *, client: Any = None,
                 cadence: int = 1) -> None:
        if cadence < 1:
            raise ValueError(f'cadence must be >= 1 ticks, got {cadence}')
        self.name = name
        self.identity = router_identity(name)
        self.client = client
        self.cadence = cadence
        self.tick = 0                 # monotonic across relaunches (seeded
        self.pushes = 0               # from the recovered journal's tick)
        # lease term, when the router holds one: the push step encodes
        # term * 1_000_000 + tick, so the store's monotonic-step rule
        # fences a deposed router's journal pushes exactly like its
        # lease renewals — a zombie can never overwrite the incumbent's
        # state (the payload still carries the raw tick)
        self.term = 0
        self._push_failed = False

    def pack(self, state: dict) -> bytes:
        payload = pickle.dumps((self.tick, dict(state)),
                               protocol=pickle.HIGHEST_PROTOCOL)
        return _blob_digest(payload).encode('ascii') + b':' + payload

    @staticmethod
    def unpack(data: bytes) -> tuple[int, dict]:
        """``(tick, state)`` from :meth:`pack` bytes; raises
        :exc:`JournalCorrupt` when the digest or shape does not verify."""
        digest, sep, payload = bytes(data).partition(b':')
        if not sep or _blob_digest(payload).encode('ascii') != digest:
            raise JournalCorrupt(
                'router journal bytes failed their digest check — torn or '
                'corrupted copy; treating as absent')
        try:
            tick, state = pickle.loads(payload)
            if not isinstance(state, dict):
                raise TypeError(f'state is {type(state).__name__}, not dict')
        except Exception as error:
            raise JournalCorrupt(
                f'router journal payload does not decode ({error}); '
                f'treating as absent') from error
        return int(tick), state

    def observe_tick(self, state: Callable[[], dict]) -> None:
        """One router step elapsed: advance the tick and replicate at the
        cadence. ``state`` is a thunk so off-cadence ticks never pay the
        snapshot cost."""
        self.tick += 1
        if self.client is None or self.tick % self.cadence:
            return
        self.replicate(state())

    def replicate(self, state: dict) -> bool:
        """Push the packed state now (also called directly for an
        off-cadence flush, e.g. right before a planned handover)."""
        if self.client is None:
            return False
        packed = self.pack(state)
        step = self.term * 1_000_000 + self.tick
        why = 'push not acknowledged'
        try:
            push = getattr(self.client, 'push', None)
            if push is not None:
                ok = bool(push(self.identity, step, packed))
            else:             # bare MemStore (in-process drills, bench)
                self.client.put(self.identity, step, packed)
                ok = True
        except (OSError, ValueError) as error:
            ok, why = False, str(error)
        if ok:
            self.pushes += 1
            if self._push_failed:
                logger.info('router journal for %r recovered at tick %d',
                            self.name, self.tick)
            self._push_failed = False
        else:
            if not self._push_failed:
                logger.warning(
                    'router journal for %r failed at tick %d (%s); routing '
                    'continues — a takeover now rebuilds from the last '
                    'verified copy plus a health sweep', self.name,
                    self.tick, why)
            self._push_failed = True
        return ok


def recover_router_journal(name: str, clients: Any) -> tuple[int, dict] | None:
    """Fetch and verify the newest router journal for ``name`` from the
    first client with an intact copy — ``clients`` in preference order,
    :func:`recover_journal`'s contract: a corrupt copy logs and falls
    through to the next client, never restores."""
    for client in clients:
        if client is None:
            continue
        try:
            entry = client.fetch(router_identity(name))
        except OSError as error:
            logger.warning('router journal fetch for %r failed (%s); '
                           'trying the next replica', name, error)
            continue
        if entry is None:
            continue
        try:
            return RouterJournal.unpack(entry.blob)
        except JournalCorrupt as error:
            logger.warning('router journal for %r at tick %d rejected (%s); '
                           'trying the next replica', name,
                           getattr(entry, 'step', -1), error)
    return None


# ---------------------------------------------------------------------------
# replay


@dataclasses.dataclass
class ReplayReport:
    """What a relaunch recovered: ``replayed`` rows re-prefill
    ``prompt + emitted`` and resume mid-stream ('hot'); ``resubmitted``
    rows were only ever queued and re-enter cold. Either way the final
    completion is token-exact — greedy and seeded sampled alike."""

    replayed: list = dataclasses.field(default_factory=list)
    resubmitted: list = dataclasses.field(default_factory=list)


def replay(scheduler: Any, rows: list, *,
           producer: Any = None) -> ReplayReport:
    """Re-queue journaled rows onto a fresh scheduler, FIFO order
    preserved (the journal packs in submission order). Each row re-enters
    through :meth:`~tpusystem_torch.serve.Scheduler.restore` — original
    deadline accounting kept via the journaled waited-seconds — and is
    narrated as a ``RequestReplayed`` event. A row whose deadline already
    passed during the outage is still queued; the scheduler's ordinary
    expiry retires it with the truthful ``'expired'`` verdict on the next
    step (replay never silently drops). A decode-carrying row replayed
    onto a prefill-only scheduler is a wiring bug, not a recoverable
    fault: the typed :exc:`~tpusystem_torch.serve.disagg.RoleMismatch`
    re-raises, narrated as a ``RoleMismatched`` event first so the
    dashboard's ``serve/role_mismatch`` counter sees it."""
    from tpusystem_torch.observe.events import RequestReplayed, RoleMismatched
    from tpusystem_torch.serve.disagg import RoleMismatch
    result = ReplayReport()
    for request, waited, emitted in rows:
        try:
            scheduler.restore(request, waited=waited, prefix=emitted)
        except RoleMismatch:
            if producer is not None:
                producer.dispatch(RoleMismatched(
                    id=request.id, replica=scheduler.journal.identity
                    if getattr(scheduler, 'journal', None) is not None
                    else 'replay', prefix=len(emitted)))
            raise
        where = 'hot' if emitted else 'cold'
        (result.replayed if emitted else result.resubmitted).append(
            request.id)
        if producer is not None:
            producer.dispatch(RequestReplayed(
                id=request.id, prefix=len(emitted), where=where,
                waited=waited))
    return result


# ---------------------------------------------------------------------------
# the step watchdog


class StepWatchdog:
    """Turn a hung or anomalously slow serving step into a typed verdict.

    Two rungs, both optional:

    * ``stall_after`` — an absolute wall-second bound; any observed step
      at or past it raises :exc:`EngineStalled` (kind ``'stall'``).
    * ``slow_factor`` — an anomaly multiple of the healthy-step EMA
      (bias toward the common case: warmup-gated, and an anomalous step
      is **not** folded into the EMA that detected it — the sentinel's
      discipline). A step at or past ``slow_factor * max(ema, floor)``
      raises kind ``'slow'``. ``floor`` keeps microsecond-scale steps
      from tripping on ordinary scheduler jitter.

    Feed ``observe`` whatever wall time the loop can measure:
    :class:`ServingReplica` feeds whole-tick seconds on its injectable
    clock (exempting the first tick after each rebuild — it pays the
    decode compile and the replay re-prefills, which must not read as
    the next stall); a custom loop can feed the engine's decode-only
    probe (``Engine.last_step_seconds``) to keep admission cost out of
    the EMA entirely.

    ``observe`` is post-hoc — it can only run when the step *returns*.
    For a step that never returns, :meth:`guard` arms a deadman timer
    around the dispatch: if it fires, ``on_stall`` runs (default:
    ``os._exit(42)`` — the restart contract's worker-lost code, so a
    supervised worker is relaunched and replays its journal; docs/
    multihost.md has the table). Tests inject ``timer`` to drive the
    deadman without real waits.
    """

    def __init__(self, *, stall_after: float | None = None,
                 slow_factor: float | None = 8.0, warmup: int = 8,
                 decay: float = 0.9, floor: float = 1e-3,
                 on_stall: Callable[[], None] | None = None,
                 timer: Callable[..., Any] = threading.Timer) -> None:
        if stall_after is None and slow_factor is None:
            raise ValueError('an unarmed watchdog watches nothing: set '
                             'stall_after and/or slow_factor')
        self.stall_after = stall_after
        self.slow_factor = slow_factor
        self.warmup = warmup
        self.decay = decay
        self.floor = floor
        self.on_stall = on_stall
        self._timer = timer
        self.observed = 0
        self.ema = 0.0

    def observe(self, seconds: float) -> None:
        """Fold one step's wall seconds; raises :exc:`EngineStalled` on a
        stall/slow verdict (the anomalous sample is not folded)."""
        if self.stall_after is not None and seconds >= self.stall_after:
            raise EngineStalled(seconds, self.stall_after, 'stall')
        if self.slow_factor is not None and self.observed >= self.warmup:
            threshold = self.slow_factor * max(self.ema, self.floor)
            if seconds >= threshold:
                raise EngineStalled(seconds, threshold, 'slow')
        self.ema = (seconds if not self.observed
                    else self.decay * self.ema + (1 - self.decay) * seconds)
        self.observed += 1

    def guard(self):
        """Deadman context manager for one dispatch: a timer fires
        ``on_stall`` after ``stall_after`` seconds unless the step
        returns first. Requires ``stall_after``."""
        if self.stall_after is None:
            raise ValueError('the deadman guard needs stall_after')
        watchdog = self

        class _Guard:
            def __enter__(self):
                default = lambda: os._exit(LOST_WORKER_EXIT)
                self.timer = watchdog._timer(
                    watchdog.stall_after, watchdog.on_stall or default)
                self.timer.daemon = True
                self.timer.start()
                return self

            def __exit__(self, *exc):
                self.timer.cancel()
                return False

        return _Guard()


# ---------------------------------------------------------------------------
# admission-control watermarks


@dataclasses.dataclass(frozen=True)
class Watermarks:
    """High/low queue-depth watermarks for typed load shedding.

    When the queue grows past ``high``, the scheduler sheds queued
    requests down to ``low`` (hysteresis: shedding every step would
    thrash at the boundary), choosing victims by **deadline slack** —
    the request that will expire anyway is shed first; requests without
    deadlines shed last, newest-first, so the oldest waiters keep their
    FIFO claim. Active rows are never shed: their prefill is sunk cost
    and they are closest to done. Each shed is a typed ``LoadShed``
    event and crossing the watermarks toggles ``Backpressure`` — the
    upstream router's signal to route elsewhere."""

    high: int
    low: int

    def __post_init__(self) -> None:
        if self.low < 0 or self.high < max(1, self.low):
            raise ValueError(
                f'watermarks need 0 <= low <= high (and high >= 1), got '
                f'high={self.high} low={self.low}')

    def excess(self, depth: int) -> int:
        """How many queued requests to shed at this depth (0 = none)."""
        return depth - self.low if depth > self.high else 0


# ---------------------------------------------------------------------------
# the supervised replica loop


class ServingReplica:
    """One serving replica under the failover discipline.

    Wraps a scheduler *factory* (``build() -> Scheduler`` — a fresh
    engine each call; params and module are closed over) with the
    journal, the watchdog, and the relaunch path:

    * at construction, a recoverable journal (this replica was killed
      and relaunched — the :class:`~tpusystem.parallel.Supervisor`
      restart contract) is replayed before any new traffic
      (``recovered`` is the witness);
    * each :meth:`step` runs one scheduler tick, feeds the watchdog, and
      replicates the journal at its cadence;
    * an :exc:`EngineStalled` verdict — from the watchdog or raised
      inside the step by a wedged engine — triggers :meth:`relaunch`:
      the old engine is abandoned, a fresh one is built, and the journal
      (which already holds this tick's tokens — hooks run inside the
      step) replays. ``EngineRestarted`` narrates cause and cost.

    ``fallbacks`` are extra journal read clients tried after ``client``
    (e.g. the buddy's store in an in-process drill; on a real pod the
    supervisor's replaced-host pull already hides behind ``client``).
    ``fault`` is the chaos seam: a callable invoked with the 1-based
    upcoming tick before each step (``DieAtStep`` / ``StalledStep``).

    ``deadman=True`` additionally arms :meth:`StepWatchdog.guard` around
    every watched tick, so a step that NEVER returns (a device hang —
    the case post-hoc ``observe`` can't see) fires ``on_stall`` (default
    ``os._exit(42)``) and the :class:`~tpusystem.parallel.Supervisor`
    relaunches the worker. Opt-in, because the default action kills the
    process: it belongs on supervised workers, not in-process embeddings
    (and the first tick after each build is exempt, like ``observe`` —
    a decode compile must not read as a hang).

    One clock rules everything: the replica, its journal, and the
    scheduler ``build()`` constructs must share ``clock`` — journaled
    waited-seconds subtract the scheduler's timestamps from the
    replica's clock, so a mismatch would backdate replays by garbage.
    Enforced at construction.
    """

    def __init__(self, build: Callable[[], Any], *, identity: str = 'serve',
                 client: Any = None, fallbacks: tuple = (),
                 cadence: int = 1, watchdog: StepWatchdog | None = None,
                 deadman: bool = False, producer: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 fault: Callable[[int], None] | None = None,
                 recorder: Any = None, role: str = 'both') -> None:
        if deadman and (watchdog is None or watchdog.stall_after is None):
            raise ValueError('deadman=True needs a watchdog with '
                             'stall_after set (the timer interval)')
        if role not in ('both', 'prefill', 'decode'):
            raise ValueError(f"role must be 'both', 'prefill' or 'decode', "
                             f'got {role!r}')
        self._build = build
        self.role = role
        # placement policy, not capability: a 'decode' replica keeps its
        # full prefill programs (recovery re-prefills journaled rows on
        # it); only 'prefill' changes the scheduler contract, and that
        # is build()'s job (Scheduler(prefill_only=True)) — enforced in
        # _boot so a mis-built replica fails at construction, not when
        # the first strip goes missing
        self.identity = identity
        self.client = client
        self.fallbacks = tuple(fallbacks)
        self.cadence = cadence
        self.watchdog = watchdog
        self.deadman = deadman
        self.producer = producer
        self._clock = clock
        self._fault = fault
        # the black box (observe.FlightRecorder | None): every tick's
        # admissions/emissions land in its write-ahead ring, so a SIGKILL
        # leaves a post-mortem whose tail matches the journal the
        # Supervisor recovers; an EngineStalled verdict dumps explicitly
        self.recorder = recorder
        self.recovered = False
        self.relaunches = 0
        self.results: dict[str, Any] = {}
        self.report: ReplayReport | None = None
        self._boot(cause=None)

    # ------------------------------------------------------------ boot

    def _boot(self, cause: str | None,
              live: RequestJournal | None = None) -> None:
        started = self._clock()
        self.scheduler = self._build()
        prefill_only = getattr(self.scheduler, 'prefill_only', False)
        if prefill_only != (self.role == 'prefill'):
            raise ValueError(
                f'replica role {self.role!r} but build() constructed a '
                f'scheduler with prefill_only={prefill_only} — the role '
                'and the scheduler contract must agree')
        scheduler_clock = getattr(self.scheduler, '_clock', self._clock)
        if scheduler_clock is not self._clock:
            raise ValueError(
                'the replica and the scheduler its build() constructs must '
                'share one clock — journaled waited-seconds subtract '
                'scheduler timestamps from the replica clock, and a '
                'mismatch backdates every replay by garbage; pass the same '
                'clock to ServingReplica(clock=) and Scheduler(clock=)')
        journal = RequestJournal(self.identity, client=self.client,
                                 cadence=self.cadence, clock=self._clock)
        recovered = None
        if live is not None:
            # in-process relaunch: the live journal survived with this
            # process and is at least as fresh as any replicated copy
            # (pushes lag it by up to cadence-1 ticks) — replay from it,
            # round-tripped through pack/unpack so the re-entry runs the
            # exact path a cross-process recovery takes. This is also
            # what makes a client-less replica (journaling only in RAM)
            # lossless across a watchdog relaunch.
            recovered = RequestJournal.unpack(live.pack())
        if recovered is None:
            recovered = recover_journal(self.identity,
                                        (self.client, *self.fallbacks))
        self.scheduler.journal = journal
        self._fresh = True            # watchdog holds off the build tick
        report = ReplayReport()
        if recovered is not None:
            tick, rows = recovered
            journal.tick = tick       # pushes stay monotonic in the store
            report = replay(self.scheduler, rows, producer=self.producer)
            self.recovered = True
        self.report = report
        if self.recorder is not None and (cause is not None
                                          or recovered is not None):
            self.recorder.note('engine-restarted', cause=cause or 'relaunch',
                               replayed=len(report.replayed),
                               resubmitted=len(report.resubmitted))
        if cause is not None or recovered is not None:
            seconds = self._clock() - started
            self._dispatch_restart(cause or 'relaunch', report, seconds)

    def _dispatch_restart(self, cause: str, report: ReplayReport,
                          seconds: float) -> None:
        logger.info(
            'serving replica %r restarted (%s): %d replayed, %d '
            'resubmitted in %.3fs', self.identity, cause,
            len(report.replayed), len(report.resubmitted), seconds)
        if self.producer is not None:
            from tpusystem_torch.observe.events import EngineRestarted
            self.producer.dispatch(EngineRestarted(
                cause=cause, replayed=len(report.replayed),
                resubmitted=len(report.resubmitted), seconds=seconds))

    # ------------------------------------------------------------ serve

    def submit(self, request: Any) -> None:
        self.scheduler.submit(request)

    def relaunch(self, cause: str) -> None:
        """Abandon the engine and rebuild from the journal — the
        in-process form of the supervised kill/relaunch cycle (one
        process, fresh device state; the subprocess form is the
        Supervisor's job and rides the same journal). The live journal
        is handed to the rebuild directly: in-process it is strictly
        fresher than any replicated copy, so a replica journaling only
        in RAM (no client) still loses nothing."""
        self.relaunches += 1
        self.results.update(self.scheduler.results)
        self._boot(cause=cause, live=self.scheduler.journal)

    def step(self):
        """One supervised tick: chaos seam, scheduler step, watchdog
        verdict, results merge. Returns the scheduler's Tick, or None
        when the step ended in a relaunch (the replayed work surfaces on
        subsequent ticks).

        The watchdog observes whole-tick wall time on the replica's own
        (injectable) clock — EXCEPT the first tick after each (re)build,
        which pays the fresh engine's decode compile and, after a
        relaunch, every replayed row's re-prefill: holding the watchdog
        off that tick keeps one genuine stall from cascading into a
        relaunch loop where every recovery tick reads as the next stall.
        Idle ticks (nothing admitted or emitted) are not folded either —
        near-zero samples would drag the EMA under real decode cost."""
        started = self._clock()
        try:
            if self._fault is not None:
                self._fault(self.scheduler.steps + 1)
            if self.deadman and not self._fresh:
                with self.watchdog.guard():    # a hang exits for restart
                    tick = self.scheduler.step()
            else:
                tick = self.scheduler.step()
            if self.watchdog is not None:
                if self._fresh:
                    self._fresh = False
                elif tick.emitted or tick.admitted:
                    self.watchdog.observe(self._clock() - started)
        except EngineStalled as stall:
            logger.warning('serving replica %r: %s', self.identity, stall)
            if self.recorder is not None:   # the watchdog verdict is a
                # post-mortem moment even though the process survives:
                # dump what the engine saw BEFORE the rebuild replaces it
                self.recorder.note('engine-stalled', kind=stall.kind,
                                   seconds=round(stall.seconds, 6),
                                   threshold=round(stall.threshold, 6))
                self.recorder.dump(reason='engine-stalled')
            self.relaunch('stalled')
            return None
        self.results.update(self.scheduler.results)
        if self.recorder is not None:
            self.recorder.note(
                'tick', step=self.scheduler.steps,
                admitted={request.id: admission.token
                          for request, admission, _ in tick.admitted},
                emitted=dict(tick.emitted),
                completed=[completion.request.id
                           for completion in tick.completed])
        return tick

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    def run_until_idle(self, max_steps: int = 10_000) -> dict:
        """Step until every queued and seated request completes; returns
        request id -> Completion (merged across relaunches)."""
        for _ in range(max_steps):
            if self.scheduler.idle:
                self.results.update(self.scheduler.results)
                return self.results
            self.step()
        raise RuntimeError(f'replica did not drain in {max_steps} steps')
