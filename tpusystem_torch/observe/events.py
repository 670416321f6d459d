"""Canonical training events: the port of :mod:`tpusystem.observe.events`.

The reference defines these in the application layer
(``examples/tinysys/tinysys/services/training.py:50-63``); they are the
ubiquitous language of every consumer, so the framework ships them. Payloads
carry the *aggregate* (host-side object with ``id``/``epoch``/``phase``) and
already-materialized metric floats — never device tensors.

Every dataclass is the reference's, field for field: the event ledger
(:mod:`tpusystem_torch.observe.ledger`) hashes type and field names, so one
event stream gives one digest in both packages. The elastic protocol
(:mod:`tpusystem_torch.parallel.elastic`) and the orchestrator
(:mod:`tpusystem_torch.orchestrator`) dispatch their events here too.
"""

from __future__ import annotations

from typing import Any

from tpusystem_torch.services.prodcon import event


@event
class Trained:
    """A training phase completed for the epoch."""
    model: Any
    metrics: dict[str, float]


@event
class Validated:
    """An evaluation phase completed for the epoch."""
    model: Any
    metrics: dict[str, float]


@event
class Iterated:
    """A full epoch (train + validate) completed."""
    model: Any
    loaders: Any = None


@event
class StepTimed:
    """Wall-clock timing of a span of steps (profiling consumer food)."""
    model: Any
    phase: str
    steps: int
    seconds: float

    @property
    def steps_per_second(self) -> float:
        return self.steps / self.seconds if self.seconds else 0.0


@event
class RecsysEvaluated:
    """The streaming recommender evaluator finished a phase-cadence pass
    over its held-out loader (:class:`tpusystem_torch.recsys.RecsysEvaluator`
    via ``evaluation_consumer``); ``metrics`` carries materialized
    floats — ``auc``/``loss`` for click models, ``recall@k`` for
    retrieval models."""
    model: Any
    metrics: dict[str, float]


# --------------------------------------------------------------------------
# sentinel events — every rung of the divergence-escalation ladder
# (tpusystem.train.sentinel) is a domain event, so the hash-chain ledger
# and TensorBoard witness each transition exactly like any other
# occurrence. ``model`` is the host-side aggregate or the identity string.


@event
class AnomalyDetected:
    """A step's update was suppressed in-graph (non-finite loss/grads, or a
    grad-norm spike past the guard's z-score threshold)."""
    model: Any
    step: int
    kind: str          # 'nonfinite' | 'spike'
    loss: float
    gnorm: float
    zscore: float


@event
class BackoffApplied:
    """The sentinel changed the update scale (level 0 / scale 1.0 is the
    recovery back to full rate after a healthy streak)."""
    model: Any
    step: int
    level: int
    scale: float


@event
class RolledBack:
    """The sentinel rolled the state back to a committed checkpoint and
    skipped the offending cursor window (PaLM-style skip-batches)."""
    model: Any
    step: int
    to_step: int
    window: Any        # {'from': cursor, 'to': cursor} — the skipped range


@event
class ReplicaDiverged:
    """The cross-replica parity check flagged silently corrupted replicas
    (SDC) before they reached a checkpoint."""
    model: Any
    step: int | None
    replicas: list
    leaves: list


# --------------------------------------------------------------------------
# serving events — the continuous-batching engine's request lifecycle
# (tpusystem.serve): every admission, eviction and completion is a domain
# event on the bus, so the ledger orders a serving incident and
# TensorBoard charts queue depth / time-to-first-token / tokens-per-sec
# without the engine knowing its observers.


@event
class RequestAdmitted:
    """A queued request was prefilled and seated in an engine row;
    ``ttft`` is submit -> first token (time-to-first-token), seconds."""
    id: str
    row: int
    prompt_tokens: int
    ttft: float
    queue_depth: int


@event
class RequestEvicted:
    """A request left its row before finishing (``reason`` =
    ``'cancelled'``); ``produced`` tokens were emitted by then."""
    id: str
    produced: int
    reason: str


@event
class RequestCompleted:
    """A request finished (``reason`` = ``'length'`` | ``'stop'``) and
    its row/blocks returned to the free lists."""
    id: str
    produced: int
    reason: str
    seconds: float


@event
class RequestExpired:
    """A request's ``deadline`` passed before it finished; ``where`` says
    whether it was still ``'queued'`` (never seated — the starvation
    case under saturation) or ``'active'`` (evicted mid-decode);
    ``produced`` tokens were emitted by then."""
    id: str
    where: str
    produced: int
    waited: float


@event
class ServeStepped:
    """One scheduler iteration: current batch occupancy and queue depth,
    plus the sliding tokens-per-second the engine is sustaining.
    ``sampled`` is how many seated rows decode with ``temperature > 0``
    (the sampled-traffic gauge; 0 = all-greedy)."""
    step: int
    active: int
    queue_depth: int
    emitted: int
    tokens_per_sec: float
    sampled: int = 0


@event
class TokenStreamed:
    """One token delivered incrementally to a streaming consumer
    (:meth:`tpusystem.serve.InferenceService.submit` with ``on_token``):
    ``index`` is the token's position in the request's stream (0 = the
    first token, whose latency IS the admission's ``ttft``). Fires per
    token of streaming requests only — non-streaming traffic keeps its
    per-step ``ServeStepped.emitted`` aggregate."""
    id: str
    index: int
    token: int


@event
class LoadShed:
    """Admission control shed a queued request past the high watermark
    (:class:`tpusystem.serve.Watermarks`): ``slack`` is the seconds it
    had left before its deadline when shed (negative = already past,
    None = no deadline — shed last, newest first). Active rows are never
    shed."""
    id: str
    produced: int
    queue_depth: int
    slack: float | None


@event
class Backpressure:
    """The scheduler crossed its queue watermarks: ``engaged`` True past
    the high mark (upstream should route elsewhere), False once the
    backlog drained back to the low mark."""
    engaged: bool
    queue_depth: int


@event
class RequestReplayed:
    """An engine relaunch re-queued a journaled request: ``prefix`` is
    how many already-emitted tokens replay re-prefills (``where='hot'``)
    before decode resumes; 0 / ``where='cold'`` is the re-submit of a
    request the journal only knew as queued. Greedy and seeded sampled
    decode are both deterministic (the sampling counter is a pure
    function of ``(seed, position)``), so either way the final
    completion is token-exact against an uninterrupted run."""
    id: str
    prefix: int
    where: str                       # 'hot' | 'cold'
    waited: float


@event
class ReplicaUnhealthy:
    """The fleet router's health verdict on one replica: its step or
    submit died (the SIGKILL signature), or its heartbeat went stale.
    The verdict is one-way — the router never routes there again;
    ``routed`` is how many in-flight requests must re-home onto the
    survivors (:mod:`tpusystem.serve.fleet`)."""
    name: str
    cause: str
    routed: int


@event
class RequestRerouted:
    """The router moved a request to a different replica: ``cause`` is
    ``'failover'`` (its replica died — journal handoff), ``'timeout'``
    (it overstayed the per-replica patience ladder) or ``'hedge'`` (a
    duplicate racing the straggler; first completion wins). ``where`` /
    ``prefix`` follow ``RequestReplayed``'s convention: a hot move
    re-prefills ``prefix`` already-emitted tokens on the target engine
    and resumes; greedy and seeded sampled decode alike keep the final
    completion token-exact across the move (hedged sampled duplicates
    emit the identical stream on both legs)."""
    id: str
    origin: str
    target: str
    where: str                       # 'hot' | 'cold'
    prefix: int
    cause: str                       # 'failover' | 'timeout' | 'hedge'


@event
class PrefillHandoff:
    """A disaggregated fleet moved one finished prefill's KV strips
    from the prefill tier to a decode replica: exported through
    ``Engine.export_prefill``, shipped over the blob plane under
    ``kv:{request}`` (digest-verified end to end), and seated through
    ``admit_prefilled``/``adopt_prefill``. ``tokens`` is the strip's
    coverage (prompt + any replayed prefix), ``bytes`` the payload's
    KV weight (:mod:`tpusystem.serve.disagg`)."""
    id: str
    origin: str                      # prefill replica
    target: str                      # decode replica
    tokens: int
    bytes: int


@event
class HandoffCorrupted:
    """A ``kv:{request}`` handoff failed its digest frame between the
    prefill tier and a decode seat (:class:`tpusystem.serve.disagg.
    HandoffCorrupt`): the payload is dropped and the router re-places
    the request cold (re-prefill from the journaled prompt+prefix), so
    the corruption costs latency, never tokens. Charted as the
    ``serve/handoff_corrupt`` counter — a silently-re-placing fleet is
    visible on the dashboard."""
    id: str
    origin: str                      # prefill replica that exported it
    target: str                      # decode replica that refused it


@event
class RoleMismatched:
    """A decode-carrying request (non-empty emitted prefix) was offered
    to a prefill-only replica (:class:`tpusystem.serve.disagg.
    RoleMismatch`): the placement is refused and retried on the decode
    tier. Charted as the ``serve/role_mismatch`` counter; a nonzero
    rate means the router's role map and the fleet disagree."""
    id: str
    replica: str
    prefix: int


@event
class RouterTakeover:
    """A (re)started router rebuilt the fleet's authoritative state:
    ``source`` says where it came back from — ``'journal'`` (the
    router journal on the memstore plane was readable: hot rebuild) or
    ``'sweep'`` (journal absent/corrupt: cold rebuild from a health
    sweep of the replicas' own journals). ``reseated`` routes kept
    streaming on the replica that already held them, ``replaced`` were
    re-placed (hot or cold), ``settled`` completions were recovered
    into the idempotency table (nothing double-completes), ``handoffs``
    in-flight KV payloads were re-queued for delivery."""
    term: int
    source: str                      # 'journal' | 'sweep'
    reseated: int
    replaced: int
    settled: int
    handoffs: int
    seconds: float


@event
class RouterDeposed:
    """A router observed a lease term higher than its own: a standby
    fenced it and took over. The deposed router must halt (exit
    ``ROUTER_FENCED_EXIT`` = 47, deliberately NOT restartable) rather
    than keep placing requests against the new term — the split-brain
    guard of the takeover protocol."""
    term: int
    observed: int


@event
class FleetResized:
    """The traffic-driven autoscaler changed the replica set: sustained
    backpressure ``'grow'``\\ s it through the provision seam (capacity
    carved from training via the supervisor/elastic resize path),
    sustained idleness ``'shrink'``\\ s it back. ``replicas`` is the
    healthy fleet size AFTER the change."""
    action: str                      # 'grow' | 'shrink'
    replicas: int
    cause: str
    name: str                        # the replica added / retired


@event
class EngineRestarted:
    """A serving replica rebuilt its engine and replayed its journal —
    ``cause`` is ``'relaunch'`` (a fresh process found a recoverable
    journal: the supervised-relaunch path) or ``'stalled'`` (the step
    watchdog fired in-process); ``seconds`` is rebuild + replay."""
    cause: str
    replayed: int
    resubmitted: int
    seconds: float


# --------------------------------------------------------------------------
# supervisor events — the recovery control loop
# (tpusystem_torch.parallel.supervisor) narrates every worker exit, relaunch and
# recovery through the bus, so the ledger orders a whole incident and
# TensorBoard charts MTTR without any trainer code.


@event
class WorkerExited:
    """The supervised worker process ended; ``action`` is the contract
    verdict (``relaunch`` / ``done`` / ``halt`` / ``crash-loop`` /
    ``drain`` for a forwarded preemption), ``reason`` the human-readable
    cause (exit-code name or signal). ``postmortem`` is what the worker
    saw: the parsed flight-recorder dump
    (:class:`~tpusystem.observe.FlightRecorder`) the supervisor read
    back after the exit — its last entries are the worker's final ticks
    — or None when flight recording is off or the worker died before
    its first dump."""
    rank: int
    code: int
    action: str
    uptime: float
    reason: str | None = None
    postmortem: Any = None


@event
class WorkerRelaunched:
    """The supervisor is restarting the worker after a restartable exit
    (``backoff`` seconds of capped exponential backoff + jitter already
    slept)."""
    rank: int
    attempt: int
    restarts: int
    backoff: float


@event
class RecoveryTimeline:
    """One full recovery, detect → first-step: ``stages`` maps each
    breadcrumb (``relaunch``, ``restore``, ``first-step``, plus anything
    the worker marked) to seconds since detection, ``seconds`` is the
    whole MTTR, ``source`` where the state came back from
    (``hot``/``disk``)."""
    rank: int
    step: int | None
    source: str | None
    seconds: float
    stages: dict


# --------------------------------------------------------------------------
# elastic events — the membership-epoch protocol
# (tpusystem_torch.parallel.elastic): every proposed and committed world resize
# is a domain event, so the ledger orders a preemption-wave incident and
# TensorBoard charts the world size and resize latency over time.


@event
class WorldResizeProposed:
    """A supervisor's settle window closed and it broadcast a membership
    proposal; ``cause`` is what opened the wave (``'loss'`` / ``'join'``
    / ``'both'``)."""
    rank: int
    epoch: int
    members: list
    cause: str


@event
class WorldResized:
    """The membership epoch committed: every proposed member echoed the
    same (epoch, members) proposal; workers restart under the new world
    spec. ``seconds`` is wave-open → commit."""
    epoch: int
    members: list
    size: int
    seconds: float


@event
class ElasticTimeline:
    """One full elastic resize, wave-open → training resumed at the new
    size: ``stages`` maps each breadcrumb (``propose``, ``commit``,
    ``restore``, plus anything the resuming side marked) to seconds
    since the wave opened; ``source`` is where the state came back from
    (``hot-reshard``/``disk``)."""
    epoch: int
    size: int
    step: int | None
    source: str | None
    seconds: float
    stages: dict


# --------------------------------------------------------------------------
# orchestrator events — the multi-tenant gang narrative
# (tpusystem_torch.orchestrator): admissions, halts, and capacity arbitration
# between tenants sharing one physical mesh. Orchestrator dispatches ride
# the SHARED producer deliberately — they are fleet-of-jobs facts, not
# one tenant's business — while each event's ``job`` field names the
# tenant it concerns (and a tenant's own bus stamps `.tenant` on events
# it emits; tpusystem_torch.orchestrator.namespace has the scoping rules).


@event
class JobAdmitted:
    """The orchestrator seated a job on its submesh: ``chips`` devices
    carved from the pool, under ``priority`` (larger wins capacity)."""
    job: str
    kind: str
    priority: int
    chips: int


@event
class JobPreempted:
    """Capacity arbitration shrank ``job`` by ``chips`` devices in
    favor of higher-priority tenant ``to`` — the
    ``Supervisor.resize()`` / exit-46 path, so the shrunk job resumes
    token-exact on its smaller submesh and the move is a recorded debt
    the ebb pays back."""
    job: str
    chips: int
    to: str


@event
class JobHalted:
    """A tenant exited outside ``RESTART_EXITS`` and was halted —
    devices freed, nothing else touched (the blast-radius contract).
    ``reason`` is the typed verdict for ``code``
    (docs/multihost.md#restart-exit-code-table)."""
    job: str
    code: int
    reason: str


@event
class CapacityArbitrated:
    """One completed (two-phase-journaled) arbitration: a ``'grant'``
    moved ``chips`` devices toward ``requester`` (from the free pool
    and/or ``donor``), a ``'release'`` paid them back on ebb.
    ``seconds`` is decide → both sides re-ganged."""
    kind: str
    requester: str
    donor: str | None
    chips: int
    seconds: float
