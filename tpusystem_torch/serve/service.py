"""The request bus front-end: the port of :mod:`tpusystem.serve.service`,
serving as a message-driven service.

Requests fan in as commands over the TorchSystem-style service layer
(:class:`tpusystem_torch.services.Service` — ``'submit'`` / ``'cancel'`` by
name, so a CLI, REST surface, or the multihost control plane can drive
the engine without importing it), and the request lifecycle fans out as
domain events on a :class:`tpusystem_torch.services.Producer`:
``RequestAdmitted`` / ``RequestEvicted`` / ``RequestCompleted`` /
``ServeStepped`` / ``TokenStreamed`` (:mod:`tpusystem_torch.observe.events`).
Streaming requests (``submit(..., on_token=)``) additionally get every
token delivered incrementally the step it materializes. The TensorBoard
consumer charts queue depth, time-to-first-token, and tokens/sec off
those events with zero engine code — the observability discipline every
other subsystem in this framework follows.

Hot-path rule: every event payload is an already-materialized host value
(ints, floats, token lists) — consumers never see device arrays.

:class:`FleetClient` is the fleet-level front door for callers that must
survive the *router* dying (the no-single-point-of-failure contract): it resolves "which router is serving right now" per call,
redials the dead-router signatures with capped exponential backoff +
jitter, and resubmits by request-id — idempotent, because
:meth:`~tpusystem_torch.serve.fleet.Router.submit` treats a known id as a
no-op and the router journal carries settled results across a takeover.
"""

from __future__ import annotations

import random
import time

from tpusystem_torch.observe.events import (Backpressure, LoadShed,
                                      RequestAdmitted, RequestCompleted,
                                      RequestEvicted, RequestExpired,
                                      ServeStepped, TokenStreamed)
from tpusystem_torch.serve.engine import Engine
from tpusystem_torch.serve.fleet import RouterFenced
from tpusystem_torch.serve.scheduler import Request, Scheduler, serve_levers
from tpusystem_torch.services.prodcon import Producer
from tpusystem_torch.services.service import Service


class InferenceService:
    """Continuous-batching inference behind a command/event bus.

    Composes an :class:`~tpusystem_torch.serve.Engine` (built with
    :func:`~tpusystem_torch.serve.serve_levers` defaults; ``levers`` reach
    the engine, ``device='cpu'`` among them, and without it the engine
    serves on the card) under a :class:`~tpusystem_torch.serve.Scheduler`, and
    narrates every lifecycle transition on ``producer``. Drive it
    directly (:meth:`submit` / :meth:`step` / :meth:`run_until_idle`) or
    by name through :attr:`service` (``handle('submit', request)``).
    """

    def __init__(self, module, params, *, producer: Producer | None = None,
                 rows: int = 4, block_size: int = 16,
                 blocks: int | None = None, prefill_budget: int = 512,
                 clock=time.monotonic, max_queued: int | None = None,
                 watermarks=None, tracer=None, **levers) -> None:
        knobs = {**serve_levers(), **levers}
        self.engine = Engine(module, params, rows=rows,
                             block_size=block_size, blocks=blocks, **knobs)
        self.scheduler = Scheduler(self.engine,
                                   prefill_budget=prefill_budget,
                                   clock=clock, max_queued=max_queued,
                                   watermarks=watermarks, tracer=tracer)
        self.producer = producer or Producer()
        self._clock = clock          # tok/s runs on the SAME injectable
        self._emitted = 0            # clock as the scheduler's deadlines
        self._started = None         # first-step wall clock, for tok/s
        self._backpressure = False   # last narrated watermark state
        self._streams: dict = {}     # request id -> on_token callback
        self._stream_index: dict = {}  # request id -> next stream index
        self.service = Service('serve')
        self.service.handler(self._named('submit', self.submit))
        self.service.handler(self._named('cancel', self.cancel))

    @staticmethod
    def _named(name, bound):
        # Service registers by function __name__; bound methods carry the
        # mangled method name, so wrap with the public command name
        def command(*arguments):
            return bound(*arguments)
        command.__name__ = name
        return command

    # -------------------------------------------------------------- intake

    def submit(self, request: Request, on_token=None) -> None:
        """Queue a request (command name ``'submit'``).

        ``on_token`` turns the request streaming: called as
        ``on_token(index, token)`` the step each token materializes —
        index 0 is the first token (delivered at admission, so its
        latency IS the TTFT the admission event charts), later indices
        arrive one per decode step (a burst per step under speculative
        rows). A cancel, deadline expiry, or completion ends the stream;
        tokens already delivered stay delivered (a mid-stream ``expired``
        verdict is truthful about the partial output). Each token is
        also narrated as :class:`~tpusystem_torch.observe.events.TokenStreamed`
        for streaming requests."""
        self.scheduler.submit(request)
        if on_token is not None:
            self._streams[request.id] = on_token
            self._stream_index[request.id] = 0

    def cancel(self, request_id: str) -> str | None:
        """Cancel a request (command name ``'cancel'``); an active one is
        evicted mid-decode and narrated as ``RequestEvicted``. A
        streaming request's ``on_token`` just stops being called —
        tokens delivered before the cancel landed stay delivered."""
        where = self.scheduler.cancel(request_id)
        self._close_stream(request_id)
        if where == 'active':
            completion = self.scheduler.results[request_id]
            self.producer.dispatch(RequestEvicted(
                id=request_id, produced=len(completion.tokens),
                reason='cancelled'))
        return where

    # ------------------------------------------------------------ streaming

    def _deliver(self, request_id: str, tokens) -> None:
        stream = self._streams.get(request_id)
        if stream is None:
            return
        for token in tokens:
            index = self._stream_index[request_id]
            self._stream_index[request_id] = index + 1
            stream(index, int(token))
            self.producer.dispatch(TokenStreamed(
                id=request_id, index=index, token=int(token)))

    def _close_stream(self, request_id: str) -> None:
        self._streams.pop(request_id, None)
        self._stream_index.pop(request_id, None)

    # ------------------------------------------------------------- serving

    def step(self) -> None:
        """One scheduler iteration, narrated on the bus."""
        if self._started is None:
            self._started = self._clock()
        tick = self.scheduler.step()
        # shed/backpressure narrate the depth that TRIGGERED them
        # (tick.shed_depth, pre-shed) — the final queue_depth is
        # post-admission and would under-report the overload
        for completion, slack in tick.shed:
            self._close_stream(completion.request.id)
            self.producer.dispatch(LoadShed(
                id=completion.request.id,
                produced=len(completion.tokens),
                queue_depth=tick.shed_depth, slack=slack))
        if self.scheduler.backpressure != self._backpressure:
            self._backpressure = self.scheduler.backpressure
            self.producer.dispatch(Backpressure(
                engaged=self._backpressure,
                queue_depth=(tick.shed_depth if self._backpressure
                             and tick.shed_depth is not None
                             else tick.queue_depth)))
        for completion, where in tick.expired:
            self.producer.dispatch(RequestExpired(
                id=completion.request.id, where=where,
                produced=len(completion.tokens),
                waited=completion.seconds))
        for request, admission, ttft in tick.admitted:
            self.producer.dispatch(RequestAdmitted(
                id=request.id, row=admission.row,
                prompt_tokens=len(request.prompt), ttft=ttft,
                queue_depth=tick.queue_depth))
            # stream the first token NOW — its delivery latency is the
            # ttft the admission event just charted
            self._deliver(request.id, [admission.token])
        for request_id, tokens in tick.emitted.items():
            self._deliver(request_id, tokens)
        for completion, _ in tick.expired:
            self._close_stream(completion.request.id)
        for completion in tick.completed:
            self._close_stream(completion.request.id)
            if completion.reason != 'cancelled':
                self.producer.dispatch(RequestCompleted(
                    id=completion.request.id,
                    produced=len(completion.tokens),
                    reason=completion.reason,
                    seconds=completion.seconds))
        step_tokens = sum(len(tokens) for tokens in tick.emitted.values())
        self._emitted += len(tick.admitted) + step_tokens
        elapsed = self._clock() - self._started
        self.producer.dispatch(ServeStepped(
            step=self.scheduler.steps, active=tick.active,
            queue_depth=tick.queue_depth, emitted=step_tokens,
            tokens_per_sec=self._emitted / elapsed if elapsed else 0.0,
            sampled=self.engine.sampled_rows))

    def run_until_idle(self, max_steps: int = 10_000) -> dict:
        """Step until every request completes; returns request id ->
        :class:`~tpusystem_torch.serve.Completion`."""
        for _ in range(max_steps):
            if self.scheduler.idle:
                return self.scheduler.results
            self.step()
        raise RuntimeError(f'serving did not drain in {max_steps} steps')

    @property
    def results(self) -> dict:
        return self.scheduler.results


class FleetClient:
    """A fleet client that survives router death (warm-standby redial).

    ``resolve() -> Router`` answers "who is serving right now" — after a
    takeover that is a *different* router object (or process); while the
    standby is still fencing it may raise the same dead signatures a
    direct call would. Every operation resolves fresh, and any
    dead-router signature (``ConnectionError`` / ``OSError`` — the
    socket death of a killed router — or :exc:`~tpusystem_torch.serve.fleet.
    RouterFenced` from a not-yet-deposed zombie) retries with capped
    exponential backoff + jitter (seeded, so drills replay identically
    and a herd of clients decorrelates instead of redialing in phase).

    Retrying is safe because submission is **request-id idempotent** at
    the router: a resubmit of a settled request returns ``'settled'``
    (read :meth:`result`), an in-flight one returns its current
    placement, and the router journal carries both tables across the
    takeover — a client can never double-run a request by redialing.

    ``sleep`` is injectable (the tier-1 drills run zero real sleeps);
    redials exhausted raises ``ConnectionError`` — the typed "no router
    ever came back" verdict.
    """

    _DEAD = (ConnectionError, OSError, RouterFenced)

    def __init__(self, resolve, *, max_redials: int = 8,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 jitter: float = 0.25, seed: int = 0,
                 sleep=time.sleep) -> None:
        if max_redials < 0 or backoff_base <= 0 or backoff_cap < backoff_base:
            raise ValueError('need max_redials >= 0 and 0 < backoff_base '
                             '<= backoff_cap')
        self._resolve = resolve
        self.max_redials = max_redials
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.redials = 0             # takeover-visibility counter

    def _backoff(self, attempt: int) -> float:
        delay = min(self.backoff_cap, self.backoff_base * 2 ** attempt)
        return delay * (1.0 + self.jitter * self._rng.random())

    def _call(self, op):
        last = None
        for attempt in range(self.max_redials + 1):
            if attempt:
                self.redials += 1
                self._sleep(self._backoff(attempt - 1))
            try:
                return op(self._resolve())
            except self._DEAD as error:
                last = error
        raise ConnectionError(
            f'router unreachable after {self.max_redials} redials — no '
            f'standby took over') from last

    def submit(self, request) -> str:
        """Route the request on the current router; returns its
        placement, or ``'settled'`` when a redial finds it already
        completed (read :meth:`result`)."""
        return self._call(lambda router: router.submit(request))

    def cancel(self, request_id: str):
        return self._call(lambda router: router.cancel(request_id))

    def result(self, request_id: str):
        """The request's Completion once settled, None while in flight
        — served from the idempotency table the router journal carries
        across takeovers."""
        return self._call(lambda router: router.results.get(request_id))
