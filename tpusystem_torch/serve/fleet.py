"""Serving fleet failover: the port of :mod:`tpusystem.serve.fleet`, a
health-checked router over N replicas.

The failover layer gives ONE replica a survival story — journaled
requests, token-prefix replay, a supervised relaunch
(:mod:`tpusystem_torch.serve.failover`). This module is the tier above
it: the thing that turns a surviving *replica* into a surviving *service*
(the vLLM/DistServe router-over-replicas split). A :class:`Router` fronts N
:class:`~tpusystem_torch.serve.ServingReplica`\\ s and owns four fleet-level
robustness moves:

* **Health-checked routing** — every replica carries a router-side
  verdict (:class:`ReplicaHandle`): healthy replicas take traffic by
  least load, a replica whose step or submit dies (the in-process
  signature of SIGKILL — :exc:`ReplicaDead` /
  :class:`~tpusystem_torch.parallel.chaos.WorkerKilled` / ``OSError``) or
  whose heartbeat goes stale (externally-driven handles,
  :meth:`ReplicaHandle.beat`) is marked unhealthy, narrated as a
  ``ReplicaUnhealthy`` event, and **never routed to again** — the
  verdict is one-way; a replaced replica joins as a fresh handle
  (:meth:`Router.adopt`). Queue-depth and the scheduler's
  ``Backpressure`` flag feed the same placement decision: a
  backpressured replica is passed over whenever a calmer one exists.
* **Journal handoff** (the headline): on a replica's death the router
  recovers its :class:`~tpusystem_torch.serve.RequestJournal` through the
  existing :func:`~tpusystem_torch.serve.recover_journal` preference chain —
  the dead replica's supervisor RAM first, then the buddy's
  ``journal:{identity}`` replica slot over the blob plane — and
  **redistributes** the rows across the surviving replicas:
  seated rows re-prefill ``prompt + emitted prefix`` on a *different
  engine* and resume decode (hot handoff), queued-only rows re-submit
  cold. Greedy and seeded sampled decode are both deterministic (the
  sampling counter is a pure function of ``(seed, position)``), so the
  final completions are token-exact against an uninterrupted fleet —
  drilled by
  ``tests/test_serve_fleet.py`` with a
  :class:`~tpusystem_torch.parallel.chaos.PreemptionWave` killing replicas
  mid-stream. Rows routed after the journal's last push (the cadence
  window) are re-submitted cold from the router's own routing table, so
  **no request is ever silently dropped**, journal or not.
* **Timeout, retry, hedging** — :class:`RoutePolicy` bounds every
  request's time on one replica: past ``timeout * retry_backoff **
  attempt`` the request is cancelled there and re-routed (its partial
  tokens carry over as a hot prefix; ``max_retries`` caps the ladder),
  and an optional ``hedge_after`` fires a duplicate on a second replica
  — first completion wins, the loser is cancelled. Both reroute paths
  thread the ORIGINAL submission time through
  :meth:`~tpusystem_torch.serve.Scheduler.restore`'s ``waited=``, so TTFT and
  latency accounting never reset on a retry. Hedging is safe for greedy
  AND seeded sampled decode alike: with counter-based sampling both legs
  of a hedge emit the identical stream (token at position ``p`` is a
  pure function of ``(seed, p)``), so first-completion-wins can never
  race two different answers. The one thing that would break this — an
  *unseeded* sampled request — is refused typed
  (:exc:`~tpusystem_torch.serve.UnseededSampling`) at the front door.
* **Fleet degradation + autoscale** — fleet-scope
  :class:`~tpusystem_torch.serve.Watermarks` shed by deadline slack across
  the WHOLE fleet's queues (the globally most-doomed request goes
  first), and past the high mark the fleet **browns out**: new requests
  without a deadline are refused typed (:exc:`FleetSaturated`) at the
  front door before the backlog collapses into shedding everything.
  Sustained backpressure grows the replica set and sustained idleness
  shrinks it (:class:`AutoscalePolicy` + ``provision``/``release``
  callables — the :meth:`~tpusystem.parallel.Supervisor.resize` /
  elastic-membership seam that carves chips from training and gives
  them back), narrated as ``FleetResized`` with ``fleet/*`` TensorBoard
  charts.

Everything runs on ONE injectable ``clock`` shared with every replica
and scheduler (the failover discipline), so timeout/hedge/shed/autoscale
policy is tier-1-testable with zero real sleeps.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import pickle

from tpusystem_torch.parallel.chaos import WorkerKilled
from tpusystem_torch.parallel.multihost import _blob_digest
from tpusystem_torch.parallel.recovery import ROUTER_FENCED_EXIT
from tpusystem_torch.serve.disagg import (HandoffCorrupt, RoleMismatch,
                                    kv_namespace, pack_handoff,
                                    unpack_handoff)
from tpusystem_torch.serve.failover import (JournalCorrupt, RouterJournal,
                                      Watermarks, recover_journal,
                                      recover_router_journal)
from tpusystem_torch.serve.scheduler import QueueFull
from tpusystem_torch.serve.engine import Saturated, UnseededSampling

logger = logging.getLogger('tpusystem_torch.serve.fleet')

__all__ = ['ReplicaDead', 'NoHealthyReplica', 'FleetSaturated',
           'RouterFenced', 'RouterLease', 'RoutePolicy', 'AutoscalePolicy',
           'ReplicaHandle', 'FleetTick', 'Router']


class ReplicaDead(RuntimeError):
    """The replica behind a handle is gone — raised by the handle's own
    kill seam (the in-process stand-in for SIGKILL) and treated, like
    :class:`~tpusystem_torch.parallel.chaos.WorkerKilled` and ``OSError``,
    as a health verdict by the router: recover the journal, redistribute
    the rows, never route there again."""


class NoHealthyReplica(RuntimeError):
    """Every replica in the fleet is unhealthy — nothing can take the
    request right now. Submissions raise it; rows recovered from a dead
    replica's journal are parked in the router's orphan buffer instead
    (placed the moment a replica is adopted), so recovery itself never
    loses work to a momentary zero-healthy window."""


class FleetSaturated(RuntimeError):
    """The fleet refused the request at the front door: every healthy
    replica's backlog is full (``QueueFull`` everywhere), or the fleet
    is in brownout (global queue past the high watermark) and the
    request carries no deadline — unbounded-patience work is the first
    thing a degrading fleet stops accepting, BEFORE the backlog
    collapses into shedding requests that could still meet their
    deadlines."""


class RouterFenced(RuntimeError):
    """This router's lease term was superseded: a standby observed its
    missed renewals, fenced the term, and took over. The deposed router
    must STOP — keep placing requests against the new incumbent and the
    fleet split-brains. ``exit_code`` maps it into the supervisor
    contract (:data:`~tpusystem_torch.parallel.recovery.ROUTER_FENCED_EXIT`,
    deliberately not restartable: the standby IS the restart)."""

    exit_code = ROUTER_FENCED_EXIT

    def __init__(self, term: int, observed: int):
        super().__init__(
            f'router lease term {term} fenced by term {observed}: a '
            f'standby took over; halt (exit {ROUTER_FENCED_EXIT}) instead '
            f'of split-braining placements against the new incumbent')
        self.term = term
        self.observed = observed


class RouterLease:
    """Monotonic-term lease over the memstore plane — the split-brain
    guard of warm-standby router takeover.

    No new consensus system: the lease record is one digest-framed blob
    under ``router-lease:{name}``, pushed with the memstore step encoded
    as ``term * 1_000_000 + count`` — the store's monotonic-step rule
    (an older step never replaces a newer one) then IS the fence: once a
    standby publishes ``term + 1``, every renewal the deposed router
    pushes is too old to land. The echo discipline of
    :mod:`tpusystem.parallel.elastic` closes the loop: after every push
    the holder re-reads the record, and a higher term echoed back is the
    typed :exc:`RouterFenced` verdict (exit 47 under a supervisor).

    Two sides, one clock (injectable — the tier-1 drills run with zero
    real sleeps):

    * the **active** router calls :meth:`renew` once per fleet tick; the
      lease self-gates to ``renew_every`` seconds, so tick rate never
      hammers the store. A push that cannot reach the plane degrades
      (log-once) — the lease is a takeover accelerator, never allowed to
      take routing down on a store hiccup.
    * the **standby** calls :meth:`watch` on its own loop: renewals
      advancing reset its patience; a record silent for ``miss_after``
      seconds returns True — fence with :meth:`acquire` (term + 1),
      rebuild via :meth:`Router.recover`, and serve.
    """

    def __init__(self, name: str = 'router', *, client: Any,
                 holder: str = 'router', renew_every: float = 1.0,
                 miss_after: float = 3.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if renew_every <= 0 or miss_after <= 0:
            raise ValueError('renew_every and miss_after must be positive '
                             'seconds')
        self.name = name
        self.identity = f'router-lease:{name}'
        self.client = client
        self.holder = holder
        self.renew_every = renew_every
        self.miss_after = miss_after
        self._clock = clock
        self.term = 0
        self.count = 0
        self._last_renewed: float | None = None
        self._seen: tuple[int, int] | None = None
        self._seen_at: float | None = None
        self._push_failed = False

    # ------------------------------------------------------------- wire

    def _pack(self) -> bytes:
        payload = pickle.dumps((self.term, self.count, self.holder),
                               protocol=pickle.HIGHEST_PROTOCOL)
        return _blob_digest(payload).encode('ascii') + b':' + payload

    @staticmethod
    def _unpack(data: bytes) -> tuple[int, int, str]:
        digest, sep, payload = bytes(data).partition(b':')
        if not sep or _blob_digest(payload).encode('ascii') != digest:
            raise JournalCorrupt('lease bytes failed their digest check — '
                                 'torn copy; treating as absent')
        try:
            term, count, holder = pickle.loads(payload)
            return int(term), int(count), str(holder)
        except Exception as error:
            raise JournalCorrupt(f'lease payload does not decode ({error}); '
                                 f'treating as absent') from error

    def _push(self) -> bool:
        step = self.term * 1_000_000 + self.count
        try:
            push = getattr(self.client, 'push', None)
            if push is not None:
                ok = bool(push(self.identity, step, self._pack()))
            else:             # bare MemStore (in-process drills, bench)
                self.client.put(self.identity, step, self._pack())
                ok = True
        except (OSError, ValueError):
            # ValueError includes the store's non-monotonic-step refusal:
            # a zombie term's renewal is too old to land — the echo read
            # below turns that into the RouterFenced verdict
            ok = False
        if ok:
            self._push_failed = False
        elif not self._push_failed:
            logger.warning('lease push for %r failed at term %d; routing '
                           'continues degraded', self.name, self.term)
            self._push_failed = True
        return ok

    def observe(self) -> tuple[int, int, str] | None:
        """The newest verified lease record ``(term, count, holder)``,
        or None when the plane is unreachable or the copy is torn."""
        try:
            entry = self.client.fetch(self.identity)
        except OSError:
            return None
        if entry is None:
            return None
        try:
            return self._unpack(entry.blob)
        except JournalCorrupt:
            return None

    # ----------------------------------------------------------- holder

    def acquire(self) -> int:
        """Fence every prior term and become the incumbent: publish
        ``observed term + 1``. Raises :exc:`RouterFenced` if another
        acquirer won the race (the echo reads back a higher term)."""
        observed = self.observe()
        self.term = (observed[0] if observed is not None else 0) + 1
        self.count = 0
        self._push()
        echo = self.observe()
        if echo is not None and echo[0] > self.term:
            raise RouterFenced(self.term, echo[0])
        self._last_renewed = self._clock()
        return self.term

    def renew(self) -> None:
        """One holder heartbeat (self-gated to ``renew_every``). Raises
        :exc:`RouterFenced` the moment a higher term is observed — the
        zombie-router guard."""
        if self.term < 1:
            raise ValueError('renew() before acquire(): the lease has no '
                             'term to renew')
        now = self._clock()
        if (self._last_renewed is not None
                and now - self._last_renewed < self.renew_every):
            return
        self.count += 1
        self._last_renewed = now
        self._push()
        echo = self.observe()
        if echo is not None and echo[0] > self.term:
            raise RouterFenced(self.term, echo[0])

    # ---------------------------------------------------------- standby

    def watch(self) -> bool:
        """Standby-side staleness probe: True when the incumbent's
        record has not advanced for ``miss_after`` seconds (time to
        fence and take over). An unreachable plane never trips it — a
        store outage must not look like a router death."""
        now = self._clock()
        observed = self.observe()
        if observed is None:
            return False
        seen = (observed[0], observed[1])
        if seen != self._seen:
            self._seen = seen
            self._seen_at = now
            return False
        return now - self._seen_at >= self.miss_after


# the exception classes the router reads as "this replica is dead", as
# opposed to a routing signal (QueueFull/Saturated) or a caller error
# (ValueError): the handle's own kill seam, the chaos harness's worker
# death, and the socket deaths a remote-replica transport would surface
_DEAD = (ReplicaDead, WorkerKilled, ConnectionError, OSError)


@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """Per-request placement policy.

    ``timeout`` bounds a request's time on one replica: past
    ``timeout * retry_backoff ** attempt`` it is cancelled there and
    re-routed to another healthy replica with its partial tokens as a
    hot prefix — capped exponential patience, at most ``max_retries``
    reroutes (after that the request stays put and its own ``deadline``
    is the last word). ``hedge_after`` (None = off) duplicates a
    still-unfinished request onto a second replica after that many
    seconds; the first completion wins and the loser is cancelled.
    """

    timeout: float | None = None
    max_retries: int = 2
    retry_backoff: float = 2.0
    hedge_after: float | None = None

    def __post_init__(self) -> None:
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f'timeout must be positive seconds, got '
                             f'{self.timeout!r}')
        if self.max_retries < 0 or self.retry_backoff < 1.0:
            raise ValueError(
                f'need max_retries >= 0 and retry_backoff >= 1.0, got '
                f'{self.max_retries}/{self.retry_backoff}')
        if self.hedge_after is not None and self.hedge_after <= 0:
            raise ValueError(f'hedge_after must be positive seconds, got '
                             f'{self.hedge_after!r}')


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Traffic-driven fleet sizing.

    ``grow_after`` consecutive backpressured router ticks add a replica
    (up to ``max_replicas``) through the ``provision`` callable;
    ``shrink_after`` consecutive fully-idle ticks retire the emptiest
    one (down to ``min_replicas``) through ``release``. ``cooldown``
    ticks must pass between resizes so one burst cannot thrash the
    resize seam — the same rate-limit discipline as the elastic
    coordinator's cooldown.
    """

    min_replicas: int = 1
    max_replicas: int = 8
    grow_after: int = 3
    shrink_after: int = 50
    cooldown: int = 10

    def __post_init__(self) -> None:
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f'need 1 <= min_replicas <= max_replicas, got '
                f'{self.min_replicas}/{self.max_replicas}')
        if self.grow_after < 1 or self.shrink_after < 1 or self.cooldown < 0:
            raise ValueError('grow_after/shrink_after must be >= 1 ticks '
                             'and cooldown >= 0')


class ReplicaHandle:
    """The router's view of one replica: placement counters, the health
    verdict, and the journal recovery chain.

    ``replica`` is a :class:`~tpusystem_torch.serve.ServingReplica` or any
    object with its surface (``submit``/``step``/``results``/``idle``
    plus a ``scheduler``) — the fleet policy tests drive fakes through
    the same seam. ``journal_clients`` is the recovery preference chain
    for THIS replica's journal (dead replica's supervisor RAM first,
    then the buddy's replica slot — exactly
    :func:`~tpusystem_torch.serve.recover_journal`'s contract); it defaults
    to the replica's own ``client`` + ``fallbacks``.

    ``external=True`` marks a replica the router must NOT step — it is
    driven by its own thread or process and proves liveness by calling
    :meth:`beat`; the router's ``heartbeat_timeout`` turns a stale beat
    into the unhealthy verdict (the remote-fleet liveness signal,
    mirrored in-process).

    :meth:`kill` is the chaos seam: the in-process analogue of SIGKILL
    (every later touch raises :exc:`ReplicaDead`), while the journal's
    out-of-process store — the supervisor RAM a real kill leaves behind
    — survives in ``journal_clients``.

    ``role`` is the disaggregated-serving placement tier (defaults to
    the replica's own ``role`` attribute, else ``'both'``):
    ``'prefill'`` replicas take new submissions and export KV handoffs
    (their scheduler is ``prefill_only``); ``'decode'`` replicas seat
    shipped strips and decode. Role is *placement policy, not
    capability* — a decode replica keeps its full prefill programs, so
    journal recovery can re-prefill rows on it. ``transport``/``rank``
    give the handle a blob plane: when both ends of a handoff carry
    one, the strips travel ``send_blob``/``fetch_blob`` (chunked,
    digest-verified) instead of by direct reference.
    """

    def __init__(self, replica: Any, *, name: str | None = None,
                 journal_clients: tuple = (), external: bool = False,
                 role: str | None = None, transport: Any = None,
                 rank: int = 0) -> None:
        self.replica = replica
        self.identity = getattr(replica, 'identity', None) or name or 'serve'
        self.name = name or self.identity
        if journal_clients:
            self.journal_clients = tuple(journal_clients)
        else:
            self.journal_clients = (getattr(replica, 'client', None),
                                    *getattr(replica, 'fallbacks', ()))
        self.external = external
        self.role = role or getattr(replica, 'role', 'both')
        if self.role not in ('both', 'prefill', 'decode'):
            raise ValueError(f"role must be 'both', 'prefill' or 'decode', "
                             f'got {self.role!r}')
        self.transport = transport
        self.rank = rank
        self.strips = None           # KVStripStore, attached on first offer
        self.healthy = True
        self.cause: str | None = None
        self.placements = 0          # submits + restores routed here
        self.last_beat: float | None = None
        self._beat_pending = False
        self._killed = False

    # ------------------------------------------------------------ state

    @property
    def scheduler(self) -> Any:
        return getattr(self.replica, 'scheduler', self.replica)

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    @property
    def depth(self) -> int:
        """Load metric for least-loaded placement: queued + seated (+
        exported handoffs awaiting shipment on a prefill replica)."""
        return (self.scheduler.queue_depth + self.scheduler.active
                + len(getattr(self.scheduler, 'outbox', ())))

    @property
    def backpressure(self) -> bool:
        return bool(getattr(self.scheduler, 'backpressure', False))

    def cached_prefix(self, prompt) -> int:
        """Prefix-affinity probe: how many leading prompt tokens this
        replica's engine already holds in its radix tree (0 when the
        engine doesn't share prefixes, or for fleet-policy fakes
        without an engine). Never raises — affinity is a steering hint,
        not a correctness surface."""
        try:
            return int(self.scheduler.engine.prefix_cached_len(prompt))
        except (AttributeError, TypeError, *_DEAD):
            return 0

    @property
    def idle(self) -> bool:
        return bool(self.replica.idle)

    @property
    def results(self) -> dict:
        return self.replica.results

    # ------------------------------------------------------------ seams

    def kill(self) -> None:
        """Chaos seam: abrupt replica death (``PreemptionWave(kills=
        (handle.kill,))``). Every subsequent touch raises
        :exc:`ReplicaDead`; the journal stores outlive it."""
        self._killed = True

    def beat(self) -> None:
        """Externally-driven replicas call this from their own loop; the
        router stamps it with ITS clock at the next health check (the
        replica's thread must not race the router's time base) and
        ``heartbeat_timeout`` judges staleness."""
        self._beat_pending = True

    def _check(self) -> None:
        if self._killed:
            raise ReplicaDead(f'replica {self.name!r} was killed')

    def submit(self, request: Any) -> None:
        self._check()
        self.replica.submit(request)
        self.placements += 1

    def restore(self, request: Any, *, waited: float, prefix=()) -> None:
        """Place a rerouted/recovered row here: the scheduler re-queues
        it with its original wait and emitted prefix (and its journal —
        ``scheduler.journal`` — witnesses the restore, so a later death
        of THIS replica hands the row on again)."""
        self._check()
        self.scheduler.restore(request, waited=waited, prefix=prefix)
        self.placements += 1

    def cancel(self, request_id: str) -> str | None:
        if self._killed or not self.healthy:
            return None
        try:
            return self.scheduler.cancel(request_id)
        except _DEAD:
            return None

    def step(self) -> Any:
        self._check()
        return self.replica.step()

    # ------------------------------------------------- disaggregated seams

    def take_handoffs(self) -> list:
        """Drain a prefill replica's exported KV handoffs (empty for
        schedulers without the seam — fleet-policy fakes)."""
        self._check()
        take = getattr(self.scheduler, 'take_handoffs', None)
        return take() if take is not None else []

    def shipped(self, request_id: str) -> None:
        """Ack a delivered handoff on the prefill side (journal row
        closes, trace span ends)."""
        self._check()
        self.scheduler.shipped(request_id)

    def ingest(self, handoff: Any, *, waited: float = 0.0) -> None:
        """Queue a shipped handoff on this (decode-capable) replica."""
        self._check()
        self.scheduler.ingest(handoff, waited=waited)
        self.placements += 1

    def offer_strips(self, request_id: str, payload: bytes) -> None:
        """Publish a packed handoff on this handle's blob-request plane
        (``kv:{request}``), creating and chaining the
        :class:`~tpusystem_torch.serve.disagg.KVStripStore` on first use."""
        if self.strips is None:
            from tpusystem_torch.serve.disagg import KVStripStore
            self.strips = KVStripStore()
            if self.transport is not None:
                self.strips.attach(self.transport)
        self.strips.offer(request_id, payload)


@dataclasses.dataclass
class _Route:
    """The router's own record of where a request lives — the authority
    that guarantees no-silent-drop even past the journal's cadence
    window, and the source of the ORIGINAL submission time every
    reroute's ``waited=`` is computed from."""

    request: Any
    handle: str                      # current primary placement
    submitted: float                 # original router-clock submission
    routed_at: float                 # last (re)placement
    attempt: int = 0                 # reroutes consumed (timeout ladder)
    hedged: str | None = None        # secondary placement, when hedged


@dataclasses.dataclass
class FleetTick:
    """One router step's outcome, fleet-wide."""

    replicas: int                    # handles still healthy
    queued: int                      # global queue depth (healthy replicas)
    active: int
    completed: list                  # request ids settled this tick
    rerouted: list                   # RequestRerouted narrations this tick
    shed: list                       # fleet-watermark victims this tick
    orphans: int                     # recovered rows awaiting a replica
    handoffs: list = dataclasses.field(default_factory=list)
    # request ids whose KV strips moved prefill -> decode this tick
    emitted: dict = dataclasses.field(default_factory=dict)
    # request id -> list of tokens, merged across the replicas' ticks —
    # what the fleet delivered this step (the recovery bench watches it
    # for the first post-handoff token; speculative replicas can land
    # several tokens per request per tick)


class Router:
    """The fleet front door: health-checked, least-loaded, journal-aware.

    Args:
        handles: the initial fleet — :class:`ReplicaHandle` instances
            (bare ``ServingReplica``\\ s are wrapped automatically).
        policy: per-request :class:`RoutePolicy` (timeout/retry/hedge).
        watermarks: fleet-scope :class:`~tpusystem_torch.serve.Watermarks`
            over the GLOBAL queue depth — shed by deadline slack across
            every replica's queue, brownout past the high mark.
        heartbeat_timeout: seconds after which an ``external`` handle's
            stale :meth:`~ReplicaHandle.beat` reads as death (None =
            externally-driven replicas are never judged by heartbeat).
        autoscale / provision / release: :class:`AutoscalePolicy` plus
            the resize seam — ``provision() -> ReplicaHandle`` grows
            the fleet (a supervised replica on capacity carved from
            training: :meth:`tpusystem.parallel.Supervisor.resize` /
            the elastic membership protocol), ``release(handle)``
            gives an idle replica's chips back.
        producer: event bus for ``ReplicaUnhealthy`` /
            ``RequestRerouted`` / ``FleetResized`` + the fleet-scope
            ``LoadShed``/``Backpressure`` narration.
        journal: a :class:`~tpusystem_torch.serve.RouterJournal` — every
            ``cadence`` ticks the router's authoritative state
            (placements, orphans, in-flight handoffs, settled results,
            brownout/cooldown) replicates to the memstore plane, and a
            relaunched or standby router rebuilds it with
            :meth:`recover`. None = crash recovery falls back to the
            health sweep alone (cold rebuild).
        lease: a :class:`RouterLease` this router holds while serving —
            renewed once per tick (self-gated); a higher term observed
            raises :exc:`RouterFenced` out of :meth:`step` (exit 47
            under a supervisor: the standby has taken over).
        clock: THE fleet clock — must be the same callable every
            replica and scheduler in the fleet runs on (enforced per
            replica by ``ServingReplica``; timeouts, hedging, shedding
            and waited-accounting all subtract its timestamps).
    """

    def __init__(self, handles, *, policy: RoutePolicy | None = None,
                 watermarks: Watermarks | None = None,
                 heartbeat_timeout: float | None = None,
                 autoscale: AutoscalePolicy | None = None,
                 provision: Callable[[], ReplicaHandle] | None = None,
                 release: Callable[[ReplicaHandle], None] | None = None,
                 producer: Any = None, tracer: Any = None,
                 journal: RouterJournal | None = None,
                 lease: RouterLease | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.handles = [handle if isinstance(handle, ReplicaHandle)
                        else ReplicaHandle(handle) for handle in handles]
        names = [handle.name for handle in self.handles]
        if len(set(names)) != len(names):
            raise ValueError(f'replica names must be unique, got {names}')
        self.policy = policy or RoutePolicy()
        self.watermarks = watermarks
        self.heartbeat_timeout = heartbeat_timeout
        self.autoscale = autoscale
        if autoscale is not None and provision is None:
            raise ValueError('autoscale needs a provision() callable — the '
                             'supervisor/elastic resize seam that builds a '
                             'new replica')
        self._provision = provision
        self._release = release
        self.producer = producer
        # observe.Tracer | None: the router roots ONE trace per request
        # (request.trace then travels with the work — through every
        # replica's scheduler, the journal, and any reroute — so a
        # request's whole fleet journey is one connected trace); reroute
        # and hedge decisions mark as instants in that trace. None = no
        # tracing work on any path.
        self.tracer = tracer
        self._trace_roots: dict[str, Any] = {}
        self.journal = journal
        self.lease = lease
        self._clock = clock
        self.results: dict[str, Any] = {}
        self.brownout = False
        self.ticks = 0
        self._routes: dict[str, _Route] = {}
        self._orphans: list = []     # (request, submitted_at, prefix) rows
        self._undelivered: list = []  # (source_name, KVHandoff) retry queue
        self._reroutes_pending: list = []   # drained into the next FleetTick
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._cooldown = 0
        for handle in self.handles:
            handle.last_beat = self._clock()

    # ------------------------------------------------------------ intake

    @property
    def healthy(self) -> list[ReplicaHandle]:
        return [handle for handle in self.handles if handle.healthy]

    def _by_name(self, name: str) -> ReplicaHandle | None:
        for handle in self.handles:
            if handle.name == name:
                return handle
        return None

    @property
    def _split_roles(self) -> bool:
        """Whether the fleet runs a dedicated prefill tier (any healthy
        ``role='prefill'`` handle) — the switch that turns on role-aware
        placement and the handoff pump."""
        return any(handle.role == 'prefill' for handle in self.healthy)

    def _targets(self, *, exclude: str | None = None,
                 prompt=None, role: str | None = None) -> list[ReplicaHandle]:
        """Healthy replicas in placement order: calm before
        backpressured, then — when the request's prompt is known —
        prefix affinity (most cached leading tokens first: the replica
        whose radix tree already holds the blocks adopts them instead
        of re-prefilling), then least-loaded, fleet order as the stable
        tie-break. Affinity never outranks backpressure: a calm replica
        with a cold cache beats a backpressured one with a warm cache,
        so a hot shared prefix cannot pile the whole fleet's traffic
        onto one replica.

        ``role`` picks the tier in a split fleet: ``'prefill'`` ranks
        the prefill replicas by queue depth (prompts go where admission
        prefill will run soonest); ``'decode'`` ranks the
        decode-capable replicas (``role != 'prefill'``) by decode
        occupancy with prefix affinity preserved within the tier;
        ``None`` keeps the whole fleet (the colocated contract)."""
        ranked = [handle for handle in self.healthy
                  if handle.name != exclude]
        if role == 'prefill':
            ranked = [handle for handle in ranked
                      if handle.role == 'prefill']
        elif role == 'decode':
            ranked = [handle for handle in ranked
                      if handle.role != 'prefill']
        if prompt is not None:
            return sorted(ranked, key=lambda handle: (
                handle.backpressure, -handle.cached_prefix(prompt),
                handle.depth))
        return sorted(ranked,
                      key=lambda handle: (handle.backpressure, handle.depth))

    def submit(self, request: Any) -> str:
        """Route a request to the best healthy replica; returns the
        replica name it landed on. Raises :exc:`NoHealthyReplica` when
        the fleet is empty/dead and :exc:`FleetSaturated` when every
        healthy backlog is full — or when the fleet is in brownout and
        the request carries no deadline (degrade at the front door
        before the backlog collapses). An *unseeded* sampled request is
        refused typed (:exc:`~tpusystem_torch.serve.UnseededSampling`) before
        placement: every fleet robustness move — replay, reroute,
        hedging — relies on decode being reproducible, and unseeded
        sampling is the one configuration that is not.

        Submission is **request-id idempotent**: a client resubmitting
        after a router redial (the takeover contract) is a no-op —
        already settled returns the ``'settled'`` sentinel (read the
        result from :attr:`results`), still in flight returns its
        current placement; neither double-places."""
        if request.id in self.results:
            return 'settled'
        routed = self._routes.get(request.id)
        if routed is not None:
            return routed.handle
        sampling = getattr(request, 'sampling', None)
        if (sampling is not None and sampling.sampled
                and sampling.seed is None):
            raise UnseededSampling(
                f'request {request.id!r} refused: sampled decode '
                f'(temperature > 0) without a seed is not reproducible — '
                f'replay, reroute, and hedging all require a seeded '
                f'stream; set SamplingParams.seed')
        if self.brownout and getattr(request, 'deadline', None) is None:
            raise FleetSaturated(
                f'request {request.id!r} refused: the fleet is past its '
                f'high watermark and the request has no deadline — '
                f'brownout sheds unbounded-patience work at the front door')
        now = self._clock()
        # a split fleet admits prompts on the prefill tier (ranked by
        # queue depth — where admission prefill runs soonest); the KV
        # strip reaches a decode replica through the handoff pump
        targets = self._targets(prompt=getattr(request, 'prompt', None),
                                role='prefill' if self._split_roles else None)
        if not targets:
            raise NoHealthyReplica('no healthy replica in the fleet')
        if self.tracer is not None and request.trace is None:
            root = self.tracer.begin(f'request {request.id}', cat='request',
                                     args={'request': request.id})
            request.trace = root.context
            self._trace_roots[request.id] = root
        full = 0
        for handle in targets:
            try:
                handle.submit(request)
            except (QueueFull, Saturated):
                full += 1
                continue
            except ValueError:
                # a request that can never run (oversized prompt/budget):
                # a caller error, not a routing signal — close its trace
                # truthfully before re-raising so the root can't leak open
                if self.tracer is not None:
                    self.tracer.end(self._trace_roots.pop(request.id, None),
                                    reason='invalid')
                    request.trace = None
                raise
            except _DEAD as death:
                self._fail(handle, f'died at submit ({death})')
                continue
            self._routes[request.id] = _Route(request, handle.name, now, now)
            return handle.name
        if self.tracer is not None:      # refused: close the trace truthfully
            refused_root = self._trace_roots.pop(request.id, None)
            if refused_root is not None:
                self.tracer.end(refused_root, reason='refused')
                # a documented retry-after-FleetSaturated must root a
                # FRESH trace, not parent into this closed one
                request.trace = None
        if full:
            raise FleetSaturated(
                f'request {request.id!r} refused: every healthy replica '
                f'is at max_queued')
        raise NoHealthyReplica('every replica died during placement')

    def cancel(self, request_id: str) -> str | None:
        """Cancel a request wherever the fleet holds it (both legs of a
        hedge, AND the orphan buffer — a cancelled row must not be
        resurrected by the next adopt); returns the primary leg's
        verdict (orphans count as ``'queued'``: silently dropped, the
        scheduler's queued-cancel contract)."""
        route = self._routes.pop(request_id, None)
        if self.tracer is not None:
            self.tracer.end(self._trace_roots.pop(request_id, None),
                            reason='cancelled')
        orphaned = [entry for entry in self._orphans
                    if entry[0].id == request_id]
        for entry in orphaned:
            self._orphans.remove(entry)
        # a handoff parked between tiers dies here too: ack the prefill
        # side (clears its shipping ledger) and drop the strips
        parked = [entry for entry in self._undelivered
                  if entry[1].request.id == request_id]
        for entry in parked:
            self._undelivered.remove(entry)
            source = self._by_name(entry[0])
            if source is not None:
                source.shipped(request_id)
        orphaned = orphaned or parked
        if route is None:
            return 'queued' if orphaned else None
        where = 'queued' if orphaned else None
        for name in (route.handle, route.hedged):
            if name is None:
                continue
            handle = self._by_name(name)
            if handle is None:
                continue
            verdict = handle.cancel(request_id)
            if name == route.handle:
                where = verdict if verdict is not None else where
                completion = handle.scheduler.results.get(request_id)
                if completion is not None:
                    self.results[request_id] = completion
        return where

    # ------------------------------------------------------------ health

    def _dispatch(self, event: Any) -> None:
        if self.producer is not None:
            self.producer.dispatch(event)

    def _fail(self, handle: ReplicaHandle, cause: str) -> None:
        """The health verdict: mark the replica unhealthy (one-way),
        recover its journal through the preference chain, and hand its
        rows to the survivors — hot for seated rows, cold for queued
        ones and for anything only the router's own table remembers."""
        if not handle.healthy:
            return
        handle.healthy = False
        handle.cause = cause
        in_flight = [route for route in self._routes.values()
                     if handle.name in (route.handle, route.hedged)]
        logger.warning(
            'replica %r marked unhealthy (%s); recovering its journal and '
            're-homing %d in-flight requests', handle.name, cause,
            len(in_flight))
        from tpusystem_torch.observe.events import ReplicaUnhealthy
        self._dispatch(ReplicaUnhealthy(name=handle.name, cause=cause,
                                        routed=len(in_flight)))
        if self.tracer is not None:  # its own one-span trace: the verdict
            self.tracer.instant('replica-unhealthy', cat='fleet',
                                args={'replica': handle.name, 'cause': cause,
                                      'routed': len(in_flight)})
        recovered = recover_journal(handle.identity, handle.journal_clients)
        rows = recovered[1] if recovered is not None else []
        if recovered is None:
            logger.warning(
                'no recoverable journal for %r; its rows re-home cold from '
                'the routing table alone', handle.name)
        handled: set[str] = set()
        for request, waited, emitted in rows:
            handled.add(request.id)
            route = self._routes.get(request.id)
            if request.id in self.results:
                continue             # already settled (hedge won elsewhere)
            if route is not None:
                if route.hedged == handle.name:
                    route.hedged = None       # dead hedge leg: primary lives
                    continue
                if (route.handle != handle.name
                        and self._is_healthy(route.handle)):
                    continue         # live elsewhere (rerouted earlier)
                # prefer the router's own clock over the journal's
                # packed waited-seconds: the journal cannot count the
                # outage between its last push and this recovery
                waited = self._clock() - route.submitted
            self._place(request, waited, list(emitted), origin=handle.name,
                        cause='failover', route=route)
        # the cadence window: rows routed after the journal's last push
        # exist only in the routing table — cold re-submit, never drop
        for route in in_flight:
            request = route.request
            if request.id in handled or request.id in self.results:
                continue
            if route.hedged == handle.name:
                route.hedged = None
                continue
            if route.handle != handle.name and self._is_healthy(route.handle):
                continue
            self._place(request, self._clock() - route.submitted, [],
                        origin=handle.name, cause='failover', route=route)

    def _is_healthy(self, name: str) -> bool:
        handle = self._by_name(name)
        return handle is not None and handle.healthy

    def _place(self, request, waited: float, emitted: list, *, origin: str,
               cause: str, route: _Route | None) -> None:
        """Re-home one row on the best survivor (or the orphan buffer
        when none is healthy), narrated as ``RequestRerouted``."""
        now = self._clock()
        # affinity probes the REPLAYED prompt (original + emitted prefix)
        # — exactly the token sequence the adopting scheduler re-prefills
        prompt = getattr(request, 'prompt', None)
        replay = (list(prompt) + list(emitted)) if prompt is not None else None
        # a hot row (emitted prefix) re-prefills AND decodes — only a
        # decode-capable replica may adopt it (a prefill-only scheduler
        # raises RoleMismatch, typed precisely so it cannot be mistaken
        # for the finished-row ValueError below). A cold row re-enters
        # at the front door: the prefill tier when one exists.
        role = None
        if self._split_roles:
            role = 'decode' if emitted else 'prefill'
        targets = self._targets(exclude=origin, prompt=replay, role=role)
        if not targets and role == 'prefill':
            # no prefill replica can take it (the origin WAS the tier):
            # decode replicas keep their full prefill programs — role is
            # placement policy, not capability — so a cold row lands
            # there rather than orphaning
            targets = self._targets(exclude=origin, prompt=replay,
                                    role='decode')
        placed = None
        for handle in targets:
            try:
                handle.restore(request, waited=waited, prefix=emitted)
            except RoleMismatch:
                # the role guard fired: a decode-carrying row was offered
                # to a prefill-only scheduler (the role map and the fleet
                # disagree — should be unreachable through _targets).
                # Narrate typed and try the next target; the dashboard's
                # serve/role_mismatch counter charts the rate.
                from tpusystem_torch.observe.events import RoleMismatched
                self._dispatch(RoleMismatched(id=request.id,
                                              replica=handle.name,
                                              prefix=len(emitted)))
                continue
            except _DEAD as death:
                self._fail(handle, f'died at restore ({death})')
                continue
            except ValueError:
                # a finished row has no business being re-homed (the
                # journal copy predates its completion): settle nothing,
                # the completion already stands where it was delivered
                return
            placed = handle
            break
        if placed is None:
            self._orphans.append((request, now - waited, list(emitted)))
            logger.warning('no healthy replica can adopt %r; parked in the '
                           'orphan buffer', request.id)
            return
        if route is None:
            route = self._routes[request.id] = _Route(
                request, placed.name, now - waited, now)
        route.handle, route.routed_at = placed.name, now
        if self.tracer is not None:
            self.tracer.instant(
                'reroute', cat='fleet', trace=request.trace,
                args={'request': request.id, 'origin': origin,
                      'target': placed.name,
                      'where': 'hot' if emitted else 'cold',
                      'prefix': len(emitted), 'cause': cause})
        from tpusystem_torch.observe.events import RequestRerouted
        narration = RequestRerouted(
            id=request.id, origin=origin, target=placed.name,
            where='hot' if emitted else 'cold', prefix=len(emitted),
            cause=cause)
        self._reroutes_pending.append(narration)
        self._dispatch(narration)

    def adopt(self, handle: ReplicaHandle | Any) -> ReplicaHandle:
        """Add a replica to the fleet (a provisioned grow, or a replaced
        host rejoining as a FRESH handle — verdicts are one-way) and
        drain any orphaned rows onto it."""
        if not isinstance(handle, ReplicaHandle):
            handle = ReplicaHandle(handle)
        if self._by_name(handle.name) is not None:
            raise ValueError(f'replica name {handle.name!r} already in the '
                             f'fleet — retire the old handle first')
        handle.last_beat = self._clock()
        self.handles.append(handle)
        orphans, self._orphans = self._orphans, []
        for request, submitted_at, emitted in orphans:
            self._place(request, self._clock() - submitted_at, emitted,
                        origin='orphans', cause='failover',
                        route=self._routes.get(request.id))
        return handle

    # ----------------------------------------------------- crash recovery

    def snapshot(self) -> dict:
        """The router's authoritative state as a clock-portable dict —
        what :class:`~tpusystem_torch.serve.RouterJournal` packs every cadence
        tick. Timestamps convert to waited-seconds at snapshot time
        (monotonic clocks do not compare across processes) and parked
        handoffs carry their digest-framed payload, so a relaunched
        router can re-ship them without the prefill tier re-exporting."""
        now = self._clock()
        return {
            'term': self.lease.term if self.lease is not None else 0,
            'brownout': self.brownout,
            'cooldown': self._cooldown,
            'results': dict(self.results),
            'routes': [(route.request, now - route.submitted, route.handle,
                        route.attempt, route.hedged)
                       for route in self._routes.values()],
            'orphans': [(request, now - submitted_at, list(emitted))
                        for request, submitted_at, emitted in self._orphans],
            'undelivered': [(source_name, handoff.request, handoff.waited,
                             list(handoff.prefix), pack_handoff(handoff))
                            for source_name, handoff in self._undelivered],
        }

    def recover(self, clients: Any = ()) -> dict:
        """Rebuild the fleet's authoritative state after a router crash
        or standby takeover: read the router journal through the
        ``clients`` preference chain (default: the journal's own client),
        then health-sweep every replica. The completion-edge idempotency
        table (``results``) restores FIRST, so nothing the old router
        already settled can double-complete; journaled routes whose
        replica still holds the row live (its request journal knows the
        id) re-attach and **keep streaming**; routes on dead or unaware
        replicas re-place (hot from the replica's own recovered journal
        where possible, cold otherwise); parked ``kv:{request}``
        handoffs re-queue for delivery from their journaled payload — a
        corrupt payload re-prefills cold, never wrong. Narrated as one
        ``RouterTakeover`` event; returns its counts as a dict."""
        started = self._clock()
        if self.lease is not None and self.journal is not None:
            self.journal.term = self.lease.term
        chain = tuple(clients)
        if not chain and self.journal is not None:
            chain = (self.journal.client,)
        recovered = (recover_router_journal(self.journal.name, chain)
                     if self.journal is not None else None)
        reseated = replaced = settled = handoffs = 0
        source = 'sweep'
        requeued: set[str] = set()
        if recovered is not None:
            tick, state = recovered
            self.journal.tick = tick     # pushes stay monotonic in the store
            source = 'journal'
            self.brownout = bool(state.get('brownout', False))
            self._cooldown = int(state.get('cooldown', 0))
            for request_id, completion in state.get('results', {}).items():
                if request_id not in self.results:
                    self.results[request_id] = completion
                    settled += 1
            # in-flight handoffs first, so the route loop below can tell
            # "parked but re-shippable" from "strips lost with the router"
            for source_name, request, waited, prefix, packed in \
                    state.get('undelivered', ()):
                if request.id in self.results:
                    continue
                try:
                    handoff = unpack_handoff(packed)
                except HandoffCorrupt:
                    from tpusystem_torch.observe.events import HandoffCorrupted
                    self._dispatch(HandoffCorrupted(
                        id=request.id, origin=source_name,
                        target='(journal)'))
                    src = self._by_name(source_name)
                    if src is not None and src.healthy:
                        try:
                            src.shipped(request.id)
                        except _DEAD as death:
                            self._fail(src, f'died at takeover ({death})')
                    if request.id not in self._routes:
                        self._place(request, waited, list(prefix),
                                    origin=source_name,
                                    cause='handoff-corrupt', route=None)
                        replaced += 1
                    continue
                self._undelivered.append((source_name, handoff))
                requeued.add(request.id)
                handoffs += 1
            now = self._clock()
            for request, waited, handle_name, attempt, hedged in \
                    state.get('routes', ()):
                request_id = request.id
                if request_id in self.results or request_id in self._routes:
                    continue
                handle = self._by_name(handle_name)
                if handle is not None and handle.healthy:
                    try:
                        handle._check()
                        completion = handle.scheduler.results.get(request_id)
                        journal = getattr(handle.scheduler, 'journal', None)
                        row = (journal.rows.get(request_id)
                               if journal is not None else None)
                        shipping = request_id in getattr(
                            handle.scheduler, '_shipping', ())
                    except _DEAD as death:
                        self._fail(handle,
                                   f'died at takeover sweep ({death})')
                    else:
                        if completion is not None:
                            # finished while the router was down: settle
                            # at the completion edge, never re-place
                            self.results[request_id] = completion
                            settled += 1
                            continue
                        if row is not None and (not shipping
                                                or request_id in requeued):
                            # the seated row never stopped streaming (or
                            # its handoff re-queued above): re-attach and
                            # let it finish
                            self._routes[request_id] = _Route(
                                request, handle_name, now - waited, now,
                                attempt=int(attempt),
                                hedged=(hedged if hedged is not None
                                        and self._is_healthy(hedged)
                                        else None))
                            reseated += 1
                            continue
                        if shipping:
                            # the old router took the handoff but its
                            # strips died with it: close the prefill
                            # ledger and re-prefill on the decode tier
                            try:
                                handle.shipped(request_id)
                            except _DEAD as death:
                                self._fail(handle,
                                           f'died at takeover ({death})')
                        emitted = list(row.emitted) if row is not None else []
                        if request_id not in self._routes:
                            self._place(request, waited, emitted,
                                        origin=handle_name,
                                        cause='takeover', route=None)
                            replaced += 1
                        continue
                # dead or missing replica: _fail above (or an earlier
                # iteration) may already have re-homed it from the
                # replica's own journal — only the remainder goes cold
                if request_id in self.results:
                    settled += 1
                    continue
                if request_id in self._routes:
                    replaced += 1
                    continue
                self._place(request, waited, [], origin=handle_name,
                            cause='takeover', route=None)
                replaced += 1
            for request, waited, emitted in state.get('orphans', ()):
                if request.id in self.results or request.id in self._routes:
                    continue
                self._place(request, waited, list(emitted),
                            origin='orphans', cause='takeover', route=None)
                replaced += 1
        swept_routes, swept_settled = self._sweep(requeued)
        reseated += swept_routes
        settled += swept_settled
        seconds = self._clock() - started
        term = self.lease.term if self.lease is not None else 0
        logger.info(
            'router takeover (%s, term %d): %d reseated, %d replaced, %d '
            'settled, %d handoffs re-queued in %.3fs', source, term,
            reseated, replaced, settled, handoffs, seconds)
        from tpusystem_torch.observe.events import RouterTakeover
        report = dict(term=term, source=source, reseated=reseated,
                      replaced=replaced, settled=settled, handoffs=handoffs,
                      seconds=seconds)
        self._dispatch(RouterTakeover(**report))
        return report

    def _sweep(self, requeued: set | None = None) -> tuple[int, int]:
        """Health sweep: adopt whatever the replicas themselves still
        know — their results dicts settle into the idempotency table,
        their request journals' live rows become routes. This is the
        whole cold rebuild when no router journal survives, and the
        cadence-window backstop when one does. A live row stuck in a
        replica's shipping ledger whose handoff did NOT survive
        (``requeued``) re-prefills on the decode tier instead of
        re-attaching — the strips died with the old router."""
        requeued = requeued or set()
        reseated = settled = 0
        now = self._clock()
        for handle in list(self.handles):
            if not handle.healthy:
                continue
            try:
                handle._check()
                results = dict(handle.scheduler.results)
                journal = getattr(handle.scheduler, 'journal', None)
                rows = dict(journal.rows) if journal is not None else {}
                shipping = set(getattr(handle.scheduler, '_shipping', ()))
            except _DEAD as death:
                self._fail(handle, f'died at takeover sweep ({death})')
                continue
            for request_id, completion in results.items():
                if request_id in self.results:
                    continue
                self.results[request_id] = completion
                self._routes.pop(request_id, None)
                settled += 1
            for request_id, row in rows.items():
                if request_id in self.results or request_id in self._routes:
                    continue
                if request_id in shipping and request_id not in requeued:
                    try:
                        handle.shipped(request_id)
                    except _DEAD as death:
                        self._fail(handle,
                                   f'died at takeover sweep ({death})')
                        break
                    self._place(row.request, now - row.submitted,
                                list(row.emitted), origin=handle.name,
                                cause='takeover', route=None)
                    reseated += 1
                    continue
                self._routes[request_id] = _Route(row.request, handle.name,
                                                  row.submitted, now)
                reseated += 1
        return reseated, settled

    def _renew_lease(self) -> None:
        try:
            self.lease.renew()
        except RouterFenced as fenced:
            from tpusystem_torch.observe.events import RouterDeposed
            self._dispatch(RouterDeposed(term=fenced.term,
                                         observed=fenced.observed))
            raise

    # ------------------------------------------------------------ serving

    def step(self) -> FleetTick:
        """One fleet tick: step every healthy replica, settle
        completions (first wins under hedging), judge heartbeats, run
        the timeout/hedge ladder, shed past the fleet watermark, and
        let the autoscaler breathe. A held lease renews FIRST — a
        deposed router must stop before placing anything this tick
        (:exc:`RouterFenced` propagates; exit 47 under a supervisor) —
        and the router journal replicates LAST, after every state change
        the tick made."""
        self.ticks += 1
        if self.lease is not None:
            self._renew_lease()
        now = self._clock()
        completed: list = []
        emitted: dict = {}
        for handle in list(self.handles):
            if not handle.healthy:
                continue
            if handle.external:
                # an external replica is stepped by its own thread — the
                # router never sees its Ticks, so settle its routed
                # requests from the results dict instead (the scheduler
                # records every terminal transition there)
                self._judge_heartbeat(handle, now)
                if handle.healthy:
                    self._harvest_external(handle, completed)
                continue
            try:
                tick = handle.step()
            except _DEAD as death:
                self._fail(handle, f'died mid-step ({death})')
                continue
            handle.last_beat = self._clock()
            if tick is None:         # the replica relaunched in-process
                continue
            emitted.update(tick.emitted)
            for completion in tick.completed:
                self._settle(completion, handle, completed)
            for completion, _where in tick.expired:
                self._settle(completion, handle, completed)
            for completion, _slack in tick.shed:
                self._settle(completion, handle, completed)
        handoffs = self._pump_handoffs()
        self._retry_and_hedge()
        shed = self._fleet_shed()
        self._breathe()
        reroutes, self._reroutes_pending = self._reroutes_pending, []
        queued = sum(h.scheduler.queue_depth for h in self.healthy)
        active = sum(h.scheduler.active for h in self.healthy)
        tick = FleetTick(replicas=len(self.healthy), queued=queued,
                         active=active, completed=completed,
                         rerouted=reroutes, shed=shed,
                         orphans=len(self._orphans), handoffs=handoffs,
                         emitted=emitted)
        if self.journal is not None:
            if self.lease is not None:
                self.journal.term = self.lease.term
            self.journal.observe_tick(self.snapshot)
        return tick

    # ------------------------------------------------------------ handoff

    def _pump_handoffs(self) -> list:
        """Move every finished prefill's KV strips to a decode replica:
        drain each healthy prefill handle's outbox, deliver over the
        blob plane when both sides carry a transport (offered under
        ``kv:{request}``, fetched chunk-digest-verified, released on
        ack) or in-process otherwise, verify the end-to-end digest, and
        seat the strip through the target's ``ingest`` →
        ``admit_prefilled`` → ``adopt_prefill`` chain. Returns the
        request ids that moved this tick. A corrupt payload falls back
        to a cold re-place (the prompt re-prefills — slower, never
        wrong); no healthy decode target parks the handoff in the
        ``_undelivered`` retry queue, drained first next tick."""
        moved: list = []
        retries, self._undelivered = self._undelivered, []
        for source_name, handoff in retries:
            source = self._by_name(source_name)
            if source is None or not source.healthy:
                # the prefill replica died after export: the strips are
                # gone with it, but the prompt is not — re-place cold,
                # unless the journal recovery in _fail already re-homed
                # the row (or a hedge settled it)
                route = self._routes.get(handoff.request.id)
                if (handoff.request.id in self.results
                        or (route is not None
                            and route.handle != source_name
                            and self._is_healthy(route.handle))):
                    continue
                self._place(handoff.request, handoff.waited,
                            list(handoff.prefix),
                            origin=source_name or 'handoffs',
                            cause='failover', route=route)
                continue
            self._deliver(source, handoff, moved)
        for handle in list(self.handles):
            if not handle.healthy or handle.role != 'prefill':
                continue
            try:
                outbox = handle.take_handoffs()
            except _DEAD as death:
                self._fail(handle, f'died at handoff export ({death})')
                continue
            for handoff in outbox:
                self._deliver(handle, handoff, moved)
        return moved

    def _deliver(self, source: ReplicaHandle, handoff, moved: list) -> None:
        request = handoff.request
        if request.id in self.results:   # settled while queued (cancel/shed)
            source.shipped(request.id)
            return
        now = self._clock()
        # decode-side affinity probes prompt + replayed prefix — the
        # tokens whose blocks a warm radix tree could already hold
        prompt = getattr(request, 'prompt', None)
        replay = ((list(prompt) + list(handoff.prefix))
                  if prompt is not None else None)
        targets = self._targets(exclude=source.name, prompt=replay,
                                role='decode')
        route = self._routes.get(request.id)
        placed = None
        for target in targets:
            try:
                if (source.transport is not None
                        and target.transport is not None):
                    # the real disaggregation wire: offer on the prefill
                    # side, pull over the chunked digest-verified blob
                    # plane, release on ack — a fetch that dies mid-
                    # flight just retries, the strip is still offered
                    source.offer_strips(request.id, pack_handoff(handoff))
                    data = target.transport.fetch_blob(
                        source.rank, kv_namespace(request.id))
                    source.strips.release(request.id)
                else:
                    data = pack_handoff(handoff)
                received = unpack_handoff(data)
            except HandoffCorrupt as corrupt:
                logger.warning(
                    'KV handoff for %r failed verification (%s); '
                    're-prefilling cold on the decode tier', request.id,
                    corrupt)
                from tpusystem_torch.observe.events import HandoffCorrupted
                self._dispatch(HandoffCorrupted(id=request.id,
                                                origin=source.name,
                                                target=target.name))
                source.shipped(request.id)
                self._place(request, handoff.waited, list(handoff.prefix),
                            origin=source.name, cause='handoff-corrupt',
                            route=route)
                return
            except _DEAD as death:
                self._fail(target, f'died at handoff ingest ({death})')
                continue
            try:
                waited = (now - route.submitted if route is not None
                          else handoff.waited)
                target.ingest(received, waited=waited)
            except _DEAD as death:
                self._fail(target, f'died at handoff ingest ({death})')
                continue
            placed = target
            break
        if placed is None:
            self._undelivered.append((source.name, handoff))
            logger.warning('no healthy decode replica can seat %r; handoff '
                           'parked for retry', request.id)
            return
        if route is None:
            route = self._routes[request.id] = _Route(
                request, placed.name, now - handoff.waited, now)
        route.handle, route.routed_at = placed.name, now
        source.shipped(request.id)
        moved.append(request.id)
        size = sum(getattr(strip, 'nbytes', 0)
                   for strip in handoff.kv.values())
        tokens = (len(prompt) if prompt is not None else 0) \
            + len(handoff.prefix)
        if self.tracer is not None:
            self.tracer.instant(
                'kv-handoff', cat='fleet', trace=request.trace,
                args={'request': request.id, 'origin': source.name,
                      'target': placed.name, 'tokens': tokens,
                      'bytes': size})
        from tpusystem_torch.observe.events import PrefillHandoff
        self._dispatch(PrefillHandoff(
            id=request.id, origin=source.name, target=placed.name,
            tokens=tokens, bytes=size))

    def _harvest_external(self, handle: ReplicaHandle,
                          completed: list) -> None:
        """Settle routed requests an externally-driven replica finished
        on its own loop. A route the router itself cancelled is already
        popped before the cancel lands, so anything still routed here
        with a terminal result is a genuine completion."""
        for route in list(self._routes.values()):
            if handle.name not in (route.handle, route.hedged):
                continue
            completion = handle.results.get(route.request.id)
            if completion is not None:
                self._settle(completion, handle, completed)

    def _judge_heartbeat(self, handle: ReplicaHandle, now: float) -> None:
        if getattr(handle, '_beat_pending', False):
            handle._beat_pending = False
            handle.last_beat = now
        if (self.heartbeat_timeout is not None
                and handle.last_beat is not None
                and now - handle.last_beat >= self.heartbeat_timeout):
            self._fail(handle, f'heartbeat stale ({self.heartbeat_timeout}s)')

    def _settle(self, completion: Any, handle: ReplicaHandle,
                completed: list) -> None:
        """First terminal verdict wins: record the completion, drop the
        route, and cancel the losing hedge leg."""
        request_id = completion.request.id
        if request_id in self.results:
            return                   # a hedge already won elsewhere
        self.results[request_id] = completion
        completed.append(request_id)
        if self.tracer is not None:
            self.tracer.end(self._trace_roots.pop(request_id, None),
                            reason=completion.reason, replica=handle.name,
                            produced=len(completion.tokens))
        route = self._routes.pop(request_id, None)
        if route is None:
            return
        for name in (route.handle, route.hedged):
            if name is not None and name != handle.name:
                loser = self._by_name(name)
                if loser is not None:
                    loser.cancel(request_id)

    def _retry_and_hedge(self) -> None:
        if self.policy.timeout is None and self.policy.hedge_after is None:
            return
        now = self._clock()
        for route in list(self._routes.values()):
            if route.request.id in self.results:
                continue
            elapsed = now - route.routed_at
            if (self.policy.timeout is not None
                    and route.attempt < self.policy.max_retries
                    and elapsed >= self.policy.timeout
                    * self.policy.retry_backoff ** route.attempt):
                self._reroute_timeout(route)
                continue
            if (self.policy.hedge_after is not None and route.hedged is None
                    and elapsed >= self.policy.hedge_after):
                self._hedge(route)

    def _reroute_timeout(self, route: _Route) -> None:
        """The request overstayed its per-replica patience: cancel it
        there (keeping its partial tokens as the new placement's hot
        prefix) and re-place it elsewhere, original submission time
        intact — a retry reports latency from the FIRST submission."""
        handle = self._by_name(route.handle)
        prefix: list = []
        if handle is not None:
            verdict = handle.cancel(route.request.id)
            if verdict == 'active':
                partial = handle.scheduler.results.get(route.request.id)
                if partial is not None:
                    prefix = list(partial.tokens)
        route.attempt += 1
        self._place(route.request, self._clock() - route.submitted, prefix,
                    origin=route.handle, cause='timeout', route=route)

    def _hedge(self, route: _Route) -> None:
        # a hedge leg runs the request end to end — prefill-only
        # replicas cannot host it, so a split fleet hedges on the
        # decode tier (which colocated replicas also belong to)
        targets = self._targets(
            exclude=route.handle,
            role='decode' if self._split_roles else None)
        if not targets:
            return                   # nowhere to hedge
        target = targets[0]
        try:
            target.restore(route.request,
                           waited=self._clock() - route.submitted, prefix=())
        except _DEAD as death:
            self._fail(target, f'died at hedge ({death})')
            return
        except ValueError:
            return
        route.hedged = target.name
        if self.tracer is not None:
            self.tracer.instant(
                'hedge', cat='fleet', trace=route.request.trace,
                args={'request': route.request.id, 'origin': route.handle,
                      'target': target.name})
        from tpusystem_torch.observe.events import RequestRerouted
        narration = RequestRerouted(
            id=route.request.id, origin=route.handle, target=target.name,
            where='cold', prefix=0, cause='hedge')
        self._reroutes_pending.append(narration)
        self._dispatch(narration)

    # ------------------------------------------------------ degradation

    def _fleet_shed(self) -> list:
        """Past the fleet high watermark, shed down to the low one by
        deadline slack across EVERY healthy replica's queue — the
        globally most-doomed request goes first, no-deadline requests
        last newest-first (each replica's own ordering contract, lifted
        to the fleet). Maintains the brownout flag and narrates
        fleet-scope ``LoadShed``/``Backpressure``."""
        if self.watermarks is None:
            return []
        depth = sum(h.scheduler.queue_depth for h in self.healthy)
        excess = self.watermarks.excess(depth)
        if not excess:
            if self.brownout and depth <= self.watermarks.low:
                self.brownout = False
                self._narrate_backpressure(depth)
            return []
        engaged_now = not self.brownout
        self.brownout = True
        candidates = []
        for handle in self.healthy:
            for request_id, slack, waited in \
                    handle.scheduler.shed_candidates():
                key = ((0, slack) if slack is not None else (1, waited))
                candidates.append((key, request_id, slack, handle))
        candidates.sort(key=lambda item: item[0])
        shed = []
        from tpusystem_torch.observe.events import LoadShed
        for _key, request_id, slack, handle in candidates[:excess]:
            completion = handle.scheduler.shed(request_id)
            if completion is None:
                continue
            self.results[request_id] = completion
            if self.tracer is not None:
                self.tracer.end(self._trace_roots.pop(request_id, None),
                                reason='shed')
            self._routes.pop(request_id, None)
            shed.append((completion, slack))
            self._dispatch(LoadShed(id=request_id,
                                    produced=len(completion.tokens),
                                    queue_depth=depth, slack=slack))
        if engaged_now:
            self._narrate_backpressure(depth)
        return shed

    def _narrate_backpressure(self, depth: int) -> None:
        from tpusystem_torch.observe.events import Backpressure
        self._dispatch(Backpressure(engaged=self.brownout,
                                    queue_depth=depth))

    # -------------------------------------------------------- autoscale

    def _pressured_role(self) -> str:
        """Which tier of a split fleet needs the next replica: compare
        prefill vs decode by (replicas backpressured, total queue
        depth); undelivered handoffs count against the decode tier —
        they are literally work with no decode seat. This is how the
        autoscaler rebalances the prefill:decode ratio instead of
        blindly growing whichever role ``provision`` defaults to."""
        score = {'prefill': [0, 0], 'decode': [0, 0]}
        for handle in self.healthy:
            tier = 'prefill' if handle.role == 'prefill' else 'decode'
            score[tier][0] += int(handle.backpressure)
            score[tier][1] += handle.depth
        score['decode'][1] += len(self._undelivered)
        return max(('decode', 'prefill'),
                   key=lambda tier: tuple(score[tier]))

    def _breathe(self) -> None:
        """Traffic-driven sizing: sustained backpressure (or orphaned
        rows, or undeliverable KV handoffs) grows the fleet through
        ``provision``; sustained full idleness retires the emptiest
        replica through ``release``. A split fleet grows the MORE
        pressured tier (``provision(role=...)``, falling back to a
        role-less ``provision()`` for legacy callables) and never
        shrinks a tier to zero."""
        if self.autoscale is None:
            return
        pressured = (self.brownout or bool(self._orphans)
                     or bool(self._undelivered)
                     or any(handle.backpressure for handle in self.healthy))
        busy = bool(self._routes) or not all(
            handle.idle for handle in self.healthy)
        self._pressure_ticks = self._pressure_ticks + 1 if pressured else 0
        self._idle_ticks = 0 if (pressured or busy) else self._idle_ticks + 1
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        from tpusystem_torch.observe.events import FleetResized
        if (pressured and self._pressure_ticks >= self.autoscale.grow_after
                and len(self.healthy) < self.autoscale.max_replicas):
            if self._split_roles:
                role = self._pressured_role()
                try:
                    replica = self._provision(role=role)
                except TypeError:    # a role-blind provision callable
                    replica = self._provision()
            else:
                replica = self._provision()
            handle = self.adopt(replica)
            self._pressure_ticks = 0
            self._cooldown = self.autoscale.cooldown
            logger.info('fleet grew to %d replicas (+%r): sustained '
                        'backpressure', len(self.healthy), handle.name)
            self._dispatch(FleetResized(action='grow',
                                        replicas=len(self.healthy),
                                        cause='backpressure',
                                        name=handle.name))
            return
        if (self._idle_ticks >= self.autoscale.shrink_after
                and len(self.healthy) > self.autoscale.min_replicas):
            idle = [handle for handle in self.healthy if handle.idle]
            if self._split_roles:
                # never shrink a tier to zero: a fleet with prompts but
                # no prefill replica (or strips but no decode replica)
                # deadlocks until the next grow
                tiers: dict[str, int] = {}
                for handle in self.healthy:
                    tier = 'prefill' if handle.role == 'prefill' else 'decode'
                    tiers[tier] = tiers.get(tier, 0) + 1
                idle = [handle for handle in idle if tiers.get(
                    'prefill' if handle.role == 'prefill' else 'decode',
                    0) > 1]
            if not idle:
                return               # never retire a replica holding work
            victim = idle[-1]        # newest-added idle replica goes back
            self.handles.remove(victim)
            self._idle_ticks = 0
            self._cooldown = self.autoscale.cooldown
            logger.info('fleet shrank to %d replicas (-%r): traffic ebbed',
                        len(self.healthy), victim.name)
            self._dispatch(FleetResized(action='shrink',
                                        replicas=len(self.healthy),
                                        cause='idle', name=victim.name))
            if self._release is not None:
                self._release(victim)

    # ------------------------------------------------------------- drain

    @property
    def idle(self) -> bool:
        return (not self._routes and not self._orphans
                and not self._undelivered
                and all(handle.idle for handle in self.healthy))

    def run_until_idle(self, max_steps: int = 10_000) -> dict:
        """Step until every routed request settles; returns request id
        -> Completion across the whole fleet."""
        for _ in range(max_steps):
            if self.idle:
                return self.results
            self.step()
        raise RuntimeError(
            f'fleet did not drain in {max_steps} steps '
            f'({len(self._routes)} in flight, {len(self._orphans)} '
            f'orphaned, {len(self.healthy)} healthy replicas)')
