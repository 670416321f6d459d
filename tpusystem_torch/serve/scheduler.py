"""Iteration-level scheduler: the port of :mod:`tpusystem.serve.scheduler`,
prefill/decode phase packing over the engine.

Orca-style continuous batching as host policy over
:class:`tpusystem_torch.serve.Engine`: each :meth:`Scheduler.step` first
**admits** queued requests into free rows — FIFO, within a prefill token
budget so a burst of long prompts cannot starve the decode phase — then
runs **one decode step** for every seated row, then maps the engine's
retirements back to requests. A request the free-list cannot seat stays
queued (never crashes — the ``Saturated`` contract), and drains in as
rows and blocks free up.

Overload is bounded and typed: ``max_queued`` rejects at submit with
:exc:`QueueFull` once the backlog is full (unbounded by default — the
pre-existing contract), and :class:`~tpusystem_torch.serve.failover.Watermarks`
sheds queued requests by deadline slack past the high watermark (the
request that will expire anyway goes first; active rows are never shed).
Wall time enters ONLY through the injectable ``clock`` — deadline
expiry, shedding slack, and every Completion's latency run on a fake
clock in tier-1 with zero real sleeps (the ``Supervisor``
injectable-clock discipline).

The engine keeps the serving levers (``stream_dtype`` weight streaming);
:func:`serve_levers` names the defaults. ``tracer=`` takes an
:class:`~tpusystem_torch.observe.Tracer`: one connected trace per request
(submit, queued, decode, the verdict). An attached
:class:`~tpusystem_torch.serve.failover.RequestJournal` (``scheduler.journal``)
witnesses every lifecycle transition for the kill/replay drill —
docs/serving.md "Surviving engine failure".
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

from tpusystem_torch.serve.engine import Engine, SamplingParams  # noqa: F401
from tpusystem_torch.serve.failover import RequestJournal, Watermarks  # noqa: F401


def serve_levers() -> dict:
    """The default engine levers for serving: ``stream_dtype='auto'`` on
    every device. The reference picks int8 weight streaming on a TPU,
    where decode is bound by streaming the weights; on an H100 80GB HBM3
    at 700 W GPT-2 125M's decode step is bound by the host (the card busy
    10.6–12.9 % of a step at int8 and fp8, ``chip_smoke.py`` phase 6), and
    the bf16, int8 and fp8 runs fall within each other's spread, so no
    narrow default is earned yet. ``'auto'`` keeps the
    module's own dtype (float32 on the CPU keeps the engine token-exact
    against the float32 reference). ``decode_impl='auto'``,
    ``share_prefix=True`` and ``draft_module=`` compose with it."""
    return {'stream_dtype': 'auto'}


class QueueFull(RuntimeError):
    """The backlog is at ``max_queued`` — a typed rejection the caller
    (or a fronting router) handles by retrying elsewhere or later.
    Distinct from ``ValueError`` (a request that could never run) and
    from silent queueing (unbounded RAM under sustained overload)."""


@dataclasses.dataclass
class Request:
    """One user request: a prompt and a generation budget.

    ``sampling`` (a :class:`~tpusystem_torch.serve.engine.SamplingParams`,
    None = greedy) selects seeded temperature/top-k/top-p sampling and
    the grammar ``mask_fn`` hook — deterministic by construction (each
    token's RNG key is a pure function of ``(seed, position)``), so
    journal replay, reroute, and hedging stay token-exact for sampled
    requests too; a ``temperature > 0`` request without a seed is
    refused typed (:class:`~tpusystem_torch.serve.engine.UnseededSampling`)
    at submit. ``stop_token`` ends the request early, with the stop
    token included in the output. ``deadline`` (seconds from
    submission, None = forever) bounds the request's whole life: a
    queued request that cannot be seated before it — the starvation
    case under saturation — or an active one still decoding past it
    expires with a typed ``RequestExpired`` event and reason
    ``'expired'`` instead of waiting silently forever."""
    id: str
    prompt: object                   # int sequence
    max_new: int
    stop_token: int | None = None
    deadline: float | None = None
    sampling: SamplingParams | None = None
    trace: object = None
    # the request's causal identity (a tracer's TraceContext),
    # assigned by the first traced component that sees it (router or
    # scheduler) and carried THROUGH the journal's pack/unpack — so a
    # row replayed or rerouted onto a different engine still parents its
    # spans to the original submission's trace. None when tracing is off.


@dataclasses.dataclass
class _Pending:
    request: Request
    submitted: float
    # tokens already emitted before an engine relaunch (the journal
    # replay path): the engine re-prefills prompt + prefix and the final
    # Completion is prefix + resumed tokens — token-exact for greedy AND
    # seeded sampled decode (the prefix length restarts the sampling
    # position counter exactly where the stream left off)
    prefix: list = dataclasses.field(default_factory=list)
    # a KVHandoff when the prefill already ran on ANOTHER replica
    # (disaggregated ingest): admission adopts the shipped strips via
    # Engine.admit_prefilled instead of running a prefill program
    handoff: object = None


@dataclasses.dataclass
class Completion:
    request: Request
    tokens: list
    reason: str          # 'length' | 'stop' | 'cancelled' | 'expired' | 'shed'
    seconds: float                   # submit -> completion


@dataclasses.dataclass
class Tick:
    """One scheduler step's outcome."""
    admitted: list                   # [(Request, Admission, ttft_s), ...]
    emitted: dict                    # request id -> list of tokens emitted
    # this step (one for the plain engine step, up to speculate+1 when
    # the engine runs speculative rows)
    completed: list                  # [Completion, ...]
    queue_depth: int
    active: int
    expired: list = dataclasses.field(default_factory=list)
    # [(Completion, 'queued' | 'active'), ...] — deadline expiries this step
    shed: list = dataclasses.field(default_factory=list)
    # [(Completion, slack_seconds | None), ...] — watermark sheds this step
    shed_depth: int | None = None
    # the queue depth that TRIGGERED the shed (pre-shed, post-expiry) —
    # the final queue_depth is post-admission and would misreport the
    # overload the LoadShed/Backpressure events narrate


class Scheduler:
    """FIFO continuous-batching scheduler over one engine.

    Args:
        engine: the :class:`~tpusystem_torch.serve.Engine` to pack.
        prefill_budget: max prompt tokens (bucket-padded) prefilled per
            step. At least one admission always proceeds when capacity
            exists, so a prompt wider than the whole budget cannot
            starve. With prefix sharing the budget counts only the
            UNCACHED suffix (``Engine.admit_cost``) — cached prefix
            tokens are adopted, not recomputed, so they shouldn't spend
            prefill budget. ``admit_cost`` floors at one bucket even
            for a fully-cached prompt, so admissions always charge a
            nonzero cost and the one-admission rule cannot degenerate
            into an unbounded zero-cost admission spin.
        clock: wall-time source (``time.monotonic``). Injectable so
            deadline-expiry, shedding and watchdog tests run on a fake
            clock with zero real sleeps.
        max_queued: backlog bound — submissions past it raise
            :exc:`QueueFull`. None (default) keeps the pre-existing
            unbounded behavior.
        watermarks: a :class:`~tpusystem_torch.serve.failover.Watermarks`
            high/low pair for deadline-slack load shedding, or None
            (default: never shed).
        prefill_only: the disaggregated prefill role — admission runs
            :meth:`~tpusystem_torch.serve.Engine.export_prefill` instead of
            seating rows, finished strips land in :attr:`outbox` as
            :class:`~tpusystem_torch.serve.disagg.KVHandoff`\\ s (the router
            ships them to a decode replica and acks with
            :meth:`shipped`), and the decode phase never runs here.
    """

    def __init__(self, engine: Engine, *, prefill_budget: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 max_queued: int | None = None,
                 watermarks: Watermarks | None = None,
                 tracer=None, prefill_only: bool = False) -> None:
        if max_queued is not None and max_queued < 1:
            raise ValueError(f'max_queued must be >= 1 (or None for '
                             f'unbounded), got {max_queued}')
        self.engine = engine
        self.prefill_budget = prefill_budget
        self.max_queued = max_queued
        self.watermarks = watermarks
        self.prefill_only = prefill_only
        self.journal: RequestJournal | None = None
        self.backpressure = False
        self.tracer = tracer         # observe.Tracer | None (None = zero
        self._clock = clock          # tracing work on every path below)
        self._queue: deque[_Pending] = deque()
        self._seated: dict[int, _Pending] = {}      # row -> pending
        self.outbox: deque = deque()  # KVHandoffs awaiting shipment
        self._shipping: dict[str, Request] = {}     # shipped, not yet acked
        self.results: dict[str, Completion] = {}
        self.steps = 0
        self._trace_open: dict[str, object] = {}    # request id -> Span
        self._trace_roots: dict[str, object] = {}   # roots THIS end owns

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return len(self._seated)

    @property
    def idle(self) -> bool:
        # a prefill replica with exported-but-unshipped strips is NOT
        # idle, or the autoscaler could shrink it mid-handoff
        return (not self._queue and not self._seated and not self.outbox
                and not self._shipping)

    def submit(self, request: Request) -> None:
        """Queue a request. Requests that could NEVER fit (prompt +
        max_new over the cache capacity) are refused immediately with a
        ``ValueError`` instead of clogging the queue forever; a full
        backlog (``max_queued``) refuses with :exc:`QueueFull`."""
        prompt_len = len(request.prompt)
        if prompt_len < 1 or request.max_new < 1:
            raise ValueError('a request needs a non-empty prompt and '
                             'max_new >= 1')
        if request.deadline is not None and request.deadline <= 0:
            raise ValueError(
                f'request {request.id!r}: deadline must be positive seconds '
                f'from submission, got {request.deadline!r}')
        # refuse non-reproducible sampling at the door (UnseededSampling,
        # a ValueError): once queued, every downstream guarantee —
        # journal replay, reroute, hedging — would silently break
        self.engine._validate_sampling(getattr(request, 'sampling', None))
        if prompt_len + request.max_new > self.engine.max_seq:
            raise ValueError(
                f'request {request.id!r}: prompt ({prompt_len}) + max_new '
                f'({request.max_new}) exceeds the engine capacity '
                f'max_seq={self.engine.max_seq}')
        needed = self.engine.pool.blocks_for(prompt_len + request.max_new)
        if needed > self.engine.pool.blocks - 1:
            # even a fully drained pool could not back it — refusing now
            # beats queueing it forever behind requests that CAN run
            raise ValueError(
                f'request {request.id!r} needs {needed} blocks but the '
                f'pool has {self.engine.pool.blocks - 1} allocatable')
        if (self.max_queued is not None
                and len(self._queue) >= self.max_queued):
            raise QueueFull(
                f'request {request.id!r} rejected: backlog is at '
                f'max_queued={self.max_queued} — retry later or on '
                f'another replica')
        pending = _Pending(request, self._clock())
        self._queue.append(pending)
        if self.journal is not None:
            self.journal.record(request, pending.submitted)
        if self.tracer is not None:
            self._trace_enqueue(request)

    def restore(self, request: Request, *, waited: float = 0.0,
                prefix=()) -> None:
        """Re-queue a journaled request after an engine relaunch (the
        :func:`tpusystem_torch.serve.failover.replay` entry): ``prefix`` is the
        tokens already emitted before the failure — admission re-prefills
        ``prompt + prefix`` and decodes the remaining budget, and the
        final Completion is ``prefix + resumed tokens`` (token-exact for
        greedy and seeded sampled decode alike — the sampling counter is
        a pure function of position, and the prefix IS the position).
        ``waited`` backdates the submission so
        deadline and latency accounting stay truthful across the
        relaunch (outage time between the last journal push and the
        relaunch is not counted — the journal packs waited-seconds)."""
        prefix = [int(token) for token in prefix]
        if len(prefix) >= request.max_new:
            raise ValueError(
                f'request {request.id!r} already emitted {len(prefix)} of '
                f'max_new={request.max_new} tokens — a finished request '
                f'has no business in the journal')
        if self.prefill_only and prefix:
            from tpusystem_torch.serve.disagg import RoleMismatch
            raise RoleMismatch(
                f'request {request.id!r} carries a {len(prefix)}-token '
                'decode prefix but this scheduler is prefill-only — a hot '
                'restore needs a decode-capable replica (the router '
                'places by role; this raise is the safety net, not a '
                'silent drop)')
        pending = _Pending(request, self._clock() - waited, prefix)
        self._queue.append(pending)
        if self.journal is not None:
            self.journal.restored(request, pending.submitted, prefix)
        if self.tracer is not None:
            self._trace_enqueue(request, prefix=len(prefix))

    # ------------------------------------------------ disaggregated roles

    def take_handoffs(self) -> list:
        """Drain the prefill outbox — every
        :class:`~tpusystem_torch.serve.disagg.KVHandoff` exported since the
        last call, in FIFO order. The caller (router or test harness)
        ships each to a decode replica and acks with :meth:`shipped`;
        until the ack the request counts as in flight here (journal row
        live, :attr:`idle` false), so a crash between export and ack
        recovers it."""
        handoffs = list(self.outbox)
        self.outbox.clear()
        for handoff in handoffs:
            self._shipping[handoff.request.id] = handoff.request
        return handoffs

    def shipped(self, request_id: str) -> None:
        """Ack one handoff: the decode replica seated (or journaled) it,
        so ownership transferred — this side's journal row closes and
        its trace spans end with reason ``'handoff'``. Unknown ids are
        ignored (the ack can race a local crash-recovery resubmit)."""
        request = self._shipping.pop(request_id, None)
        if self.journal is not None:
            self.journal.finished(request_id)
        if self.tracer is not None and request is not None:
            self._trace_finish(request, 'handoff', 0)

    def ingest(self, handoff, *, waited: float = 0.0) -> None:
        """Decode-side entry: queue a request whose prefill ran on a
        prefill-role replica. Admission seats it through
        ``Engine.admit_prefilled`` (adopt-only — no prefill program
        runs here). ``waited`` backdates the submission by the time the
        request already spent on the prefill side, so deadlines and
        latency accounting span the whole disaggregated path."""
        request = handoff.request
        prefix = [int(token) for token in handoff.prefix]
        pending = _Pending(request, self._clock() - waited, prefix,
                           handoff=handoff)
        self._queue.append(pending)
        if self.journal is not None:
            if prefix:
                self.journal.restored(request, pending.submitted, prefix)
            else:
                self.journal.record(request, pending.submitted)
        if self.tracer is not None:
            self._trace_enqueue(request,
                                prefix=len(prefix) if prefix else None)

    # ------------------------------------------------------------ tracing
    # (every call below is guarded by `self.tracer is not None` at the
    # call site — tracing off means NO extra work on the serving path)

    def _trace_enqueue(self, request: Request, prefix: int | None = None):
        """Open the request's 'queued' span. The FIRST traced component
        that sees a request roots its trace (a fronting Router usually
        did already — then ``request.trace`` carries its context and the
        spans here parent into it, which is exactly how a replayed row
        on a different engine stays in the original trace)."""
        if request.trace is None:
            root = self.tracer.begin(f'request {request.id}', cat='request',
                                     args={'request': request.id})
            request.trace = root.context
            self._trace_roots[request.id] = root
        args = {'request': request.id}
        if prefix is not None:       # a journal replay / reroute re-entry
            args['prefix'] = prefix
            args['replayed'] = True
        self._trace_open[request.id] = self.tracer.begin(
            'queued', cat='serve', trace=request.trace, args=args)

    def _trace_seated(self, request: Request, row: int) -> None:
        self.tracer.end(self._trace_open.pop(request.id, None))
        self._trace_open[request.id] = self.tracer.begin(
            'decode', cat='serve', trace=request.trace,
            args={'request': request.id, 'row': row})

    def _trace_exported(self, request: Request) -> None:
        """Close 'queued', open 'handoff' — ended by :meth:`shipped`'s
        ack. Parented into ``request.trace`` like every serve span, so
        the decode replica's spans and these share one trace."""
        self.tracer.end(self._trace_open.pop(request.id, None))
        self._trace_open[request.id] = self.tracer.begin(
            'handoff', cat='serve', trace=request.trace,
            args={'request': request.id})

    def _trace_finish(self, request: Request, reason: str,
                      produced: int) -> None:
        self.tracer.end(self._trace_open.pop(request.id, None),
                        reason=reason, produced=produced)
        root = self._trace_roots.pop(request.id, None)
        if root is not None:         # this scheduler rooted the trace
            self.tracer.end(root, reason=reason, produced=produced)

    def cancel(self, request_id: str) -> str | None:
        """Cancel a request wherever it is: ``'queued'`` (silently
        dropped), ``'active'`` (evicted mid-decode; partial tokens land
        in :attr:`results` with reason ``'cancelled'``), or ``None``
        when unknown/already completed."""
        for pending in list(self._queue):
            if pending.request.id == request_id:
                self._queue.remove(pending)
                if self.journal is not None:
                    self.journal.finished(request_id)
                if self.tracer is not None:
                    self._trace_finish(pending.request, 'cancelled', 0)
                return 'queued'
        for row, pending in list(self._seated.items()):
            if pending.request.id == request_id:
                state = self.engine.evict(row)
                del self._seated[row]
                self._complete(pending, list(state.tokens), 'cancelled')
                return 'active'
        for handoff in list(self.outbox):
            if handoff.request.id == request_id:
                self.outbox.remove(handoff)
                if self.journal is not None:
                    self.journal.finished(request_id)
                if self.tracer is not None:
                    self._trace_finish(handoff.request, 'cancelled', 0)
                return 'queued'
        return None

    def _expire(self) -> list:
        """Retire every request whose deadline passed: queued ones are
        dropped (never seated — saturation starvation made visible);
        active ones are evicted mid-decode, partial tokens kept. Returns
        ``[(Completion, where), ...]`` for the tick."""
        now = self._clock()
        expired = []
        for pending in list(self._queue):
            deadline = pending.request.deadline
            if deadline is not None and now - pending.submitted >= deadline:
                self._queue.remove(pending)
                expired.append((self._complete(pending, [], 'expired'),
                                'queued'))
        for row, pending in list(self._seated.items()):
            deadline = pending.request.deadline
            if deadline is not None and now - pending.submitted >= deadline:
                state = self.engine.evict(row)
                del self._seated[row]
                expired.append((self._complete(pending, list(state.tokens),
                                               'expired'), 'active'))
        return expired

    def _slack(self, pending: _Pending, now: float) -> float | None:
        """Seconds until the request's deadline (negative = already
        past); None when it has no deadline."""
        deadline = pending.request.deadline
        if deadline is None:
            return None
        return deadline - (now - pending.submitted)

    def shed_candidates(self) -> list:
        """Every queued request as ``(request_id, slack_seconds | None,
        waited_seconds)`` — the shed-ordering input, exposed so a fleet
        router can rank victims GLOBALLY across many replicas' queues
        with the same contract the local shed uses: ascending slack
        first (the request that will expire anyway), then no-deadline
        requests newest-first (ascending waited). Active rows never
        appear — they are never shed."""
        now = self._clock()
        return [(pending.request.id, self._slack(pending, now),
                 now - pending.submitted) for pending in self._queue]

    def shed(self, request_id: str) -> Completion | None:
        """Shed ONE queued request by id (reason ``'shed'``; the victim
        lands in :attr:`results` like any completion) — the fleet
        router's victim hook. Returns None when the id is not queued
        here (already admitted, completed, or somebody else's)."""
        for pending in self._queue:
            if pending.request.id == request_id:
                self._queue.remove(pending)
                return self._complete(pending, [], 'shed')
        return None

    def _shed(self) -> list:
        """Past the high watermark, shed queued requests down to the low
        one by deadline slack — the request that will expire anyway goes
        first; no-deadline requests shed last, newest-first, so the
        oldest waiters keep their FIFO claim. Active rows are never shed
        (sunk prefill, closest to done). Returns
        ``[(Completion, slack), ...]`` and maintains the backpressure
        flag (engaged past high, released at/below low)."""
        if self.watermarks is None:
            return []
        depth = len(self._queue)
        excess = self.watermarks.excess(depth)
        if not excess:
            if self.backpressure and depth <= self.watermarks.low:
                self.backpressure = False
            return []
        self.backpressure = True
        now = self._clock()
        # same ordering contract as shed_candidates() documents — kept
        # over the pending objects directly so the overload path removes
        # each victim once instead of rescanning the queue per shed
        order = sorted(
            self._queue,
            key=lambda pending: (
                (0, self._slack(pending, now))
                if pending.request.deadline is not None
                else (1, now - pending.submitted)))
        shed = []
        for pending in order[:excess]:
            self._queue.remove(pending)
            shed.append((self._complete(pending, [], 'shed'),
                         self._slack(pending, now)))
        return shed

    def step(self) -> Tick:
        """One serving iteration: expire past-deadline requests, shed
        past the watermark, admit within the prefill budget, then decode
        every seated row once."""
        self.steps += 1
        expired = self._expire()
        depth_at_shed = len(self._queue)
        shed = self._shed()
        admitted, completed = [], []
        budget = self.prefill_budget
        while self._queue:
            pending = self._queue[0]
            request = pending.request
            prompt = list(request.prompt) + pending.prefix
            remaining = request.max_new - len(pending.prefix)
            if pending.handoff is not None:
                # adopt-only admission: the prefill already ran on the
                # prefill-role replica — charge the floor, not the
                # prompt bucket (the whole point of the split)
                cost = self.engine.bucket(1)
            else:
                cost = self.engine.admit_cost(prompt)
            if cost > budget and budget < self.prefill_budget:
                break                    # budget spent this step
            if self.prefill_only:
                self._queue.popleft()
                first, kv = self.engine.export_prefill(
                    prompt, sampling=getattr(request, 'sampling', None),
                    emitted=pending.prefix)
                budget -= cost
                from tpusystem_torch.serve.disagg import KVHandoff
                self.outbox.append(KVHandoff(
                    request=request, first=first, kv=kv,
                    prefix=list(pending.prefix),
                    waited=self._clock() - pending.submitted))
                if self.tracer is not None:
                    self._trace_exported(request)
                continue
            if not self.engine.can_admit(len(prompt), remaining,
                                         prompt=prompt):
                break                    # FIFO: wait for rows/blocks
            self._queue.popleft()
            sampling = getattr(request, 'sampling', None)
            if pending.handoff is not None:
                handoff, pending.handoff = pending.handoff, None
                admission = self.engine.admit_prefilled(
                    prompt, remaining, handoff.first, handoff.kv,
                    stop_token=request.stop_token, tag=request.id,
                    sampling=sampling, emitted=pending.prefix)
            else:
                admission = self.engine.admit(
                    prompt, remaining,
                    stop_token=request.stop_token, tag=request.id,
                    sampling=sampling, emitted=pending.prefix)
            budget -= cost
            ttft = self._clock() - pending.submitted
            admitted.append((request, admission, ttft))
            if self.journal is not None:
                self.journal.seated(request.id, admission.token)
            if self.tracer is not None:
                self._trace_seated(request, admission.row)
            if admission.finished:
                completed.append(self._complete(
                    pending, [admission.token], admission.reason))
            else:
                self._seated[admission.row] = pending

        report = self.engine.step()
        emitted = {}
        for row, tokens in report.emitted.items():
            if row in self._seated:
                request_id = self._seated[row].request.id
                emitted[request_id] = list(tokens)
                if self.journal is not None:
                    for token in tokens:
                        self.journal.append(request_id, token)
        for row, reason, tokens in report.finished:
            # rows admitted directly on the engine (not through this
            # scheduler) retire without a seat here — their caller got
            # the tokens via the engine's StepReport
            pending = self._seated.pop(row, None)
            if pending is not None:
                completed.append(self._complete(pending, list(tokens),
                                                reason))
        if self.journal is not None:
            self.journal.observe_tick()
        return Tick(admitted, emitted, completed, len(self._queue),
                    len(self._seated), expired, shed,
                    depth_at_shed if shed else None)

    def _complete(self, pending: _Pending, tokens: list,
                  reason: str) -> Completion:
        completion = Completion(pending.request, pending.prefix + list(tokens),
                                reason, self._clock() - pending.submitted)
        self.results[pending.request.id] = completion
        if self.journal is not None:
            self.journal.finished(pending.request.id)
        if self.tracer is not None:
            self._trace_finish(pending.request, reason,
                               len(completion.tokens))
        return completion

    def run(self, max_steps: int = 10_000) -> dict:
        """Step until every queued and seated request completes; returns
        :attr:`results` (request id -> :class:`Completion`)."""
        for _ in range(max_steps):
            if self.idle:
                return self.results
            self.step()
        raise RuntimeError(f'scheduler did not drain in {max_steps} steps '
                           f'(queue {self.queue_depth}, active '
                           f'{self.active})')
