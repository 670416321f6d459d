"""Request-scoped tracing: one causally-linked timeline across the fleet.
The port of :mod:`tpusystem.observe.trace`, copied (standard library only).

The event plane (:mod:`tpusystem_torch.observe.events`) narrates *that* things
happened and the metric plane (:mod:`tpusystem_torch.observe.metrics`) says *how
often and how slow* — this module is the third plane: *what happened to
THIS request / THIS recovery, in order, across processes*. After the
serving fleet PRs a single request can cross a router, a replica, a
journal replay, and a reroute onto a different engine; a recovery crosses
detect → relaunch → restore → first-step on a supervisor. No scalar chart
can show that journey; a trace can.

Design rules, inherited from the rest of the framework:

* **Injectable clock** — the :class:`~tpusystem_torch.serve.Scheduler`
  discipline: every timestamp comes from ``clock`` so tier-1 drills run
  on fake clocks with zero real sleeps.
* **Off by default, zero cost off** — every instrumented subsystem takes
  ``tracer=None`` and guards with one ``is not None`` check; a disabled
  tracer adds no per-tick host sync and no allocation (the reference's
  ``trace_overhead`` bench row pins its budget; the port has no bench yet).
* **Causal identity travels with the work** — a :class:`TraceContext`
  ``(trace_id, parent span id)`` rides the :class:`~tpusystem_torch.serve.
  Request` itself, so the journal packs it for free and a replayed or
  rerouted row on a *different* engine parents to the original
  submission's trace. One request = ONE connected trace, kills or not.
* **Chrome trace-event export** — :meth:`Tracer.export` writes the
  `Trace Event Format` JSON that Perfetto (https://ui.perfetto.dev) and
  ``chrome://tracing`` open directly: one process row per host/replica
  (``process`` label → pid), spans as complete (``"ph": "X"``) events,
  the trace/parent ids in ``args`` so tooling and tests can walk the
  causal chain.
* **Cross-host collection rides the blob plane** — :meth:`Tracer.
  send_spans` ships a packed span set over the existing
  ``send_blob``/``fetch_blob`` wire at phase cadence (key
  ``trace:{process}``); :meth:`Tracer.accept_blob` is a chainable
  receiver and :meth:`Tracer.merge` folds any packed set in, so rank 0
  exports one JSON file showing the whole fleet.

Spans are tiny host-side records (name, ids, two floats, a small args
dict) — never device tensors; recording happens at lifecycle edges
(submit/admit/complete, recovery stages), never per token.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import pickle
import threading
import time
from typing import Any, Callable, Iterator

__all__ = ['TraceContext', 'Span', 'Tracer', 'connected_traces']


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The causal identity a unit of work carries: which trace it belongs
    to and which span fathered it. Frozen and picklable on purpose — it
    rides :class:`~tpusystem_torch.serve.Request` through the journal's
    ``pack()``/``unpack()`` and across process boundaries unchanged, so
    a replayed row still knows its original submission."""

    trace_id: str
    parent: str | None = None        # span id of the parent span


@dataclasses.dataclass
class Span:
    """One named interval on one process row. ``end`` is None while the
    span is open (a request mid-decode, a recovery mid-restore); an open
    span still exports — with the tracer's *now* as its provisional end
    and ``"open": true`` in args — so a post-mortem trace shows work the
    process died holding."""

    name: str
    cat: str
    span_id: str
    trace_id: str
    parent: str | None
    process: str
    start: float
    end: float | None = None
    args: dict = dataclasses.field(default_factory=dict)
    phase: str = 'span'              # 'span' | 'instant'

    @property
    def context(self) -> TraceContext:
        """The context CHILDREN of this span should carry."""
        return TraceContext(trace_id=self.trace_id, parent=self.span_id)


class Tracer:
    """Span recorder for one process (host, replica, router, supervisor).

    Args:
        process: the process-row label in the exported trace
            (``'router'``, ``'rep0'``, ``'rank1'``...). Span and trace
            ids are namespaced by it, so merged fleets cannot collide.
        clock: wall-time source (``time.monotonic``); injectable so the
            fleet drills trace on their fake clocks. All tracers merged
            into one export must share a time base.
        sink: optional callable invoked with every *finished* span — the
            flight recorder's hook (:meth:`tpusystem_torch.observe.flight.
            FlightRecorder.watch`).

    Thread-safe: spans arrive from scheduler loops, supervisor threads
    and blob receivers; a lock guards the span list and id counter.
    """

    def __init__(self, process: str = 'proc', *,
                 clock: Callable[[], float] = time.monotonic,
                 sink: Callable[[Span], None] | None = None) -> None:
        self.process = process
        self.clock = clock
        self.sink = sink
        self._lock = threading.Lock()
        self._seq = 0
        self._spans: dict[str, Span] = {}        # span_id -> Span (ordered)

    # ------------------------------------------------------------- record

    def _next_id(self, kind: str) -> str:
        with self._lock:
            self._seq += 1
            return f'{self.process}/{kind}{self._seq}'

    def context(self) -> TraceContext:
        """A fresh root context (new trace, no parent) — for work that
        starts here."""
        return TraceContext(trace_id=self._next_id('t'))

    def begin(self, name: str, *, cat: str = 'span',
              trace: TraceContext | None = None,
              args: dict | None = None) -> Span:
        """Open a span. With ``trace=None`` it roots a new trace; pass a
        :class:`TraceContext` to parent it into an existing one. Close
        with :meth:`end` (spans here are lifecycle intervals — submit to
        admit, admit to complete — not lexical blocks; use :meth:`span`
        for the lexical case)."""
        span_id = self._next_id('s')
        if trace is None:
            trace = self.context()
        span = Span(name=name, cat=cat, span_id=span_id,
                    trace_id=trace.trace_id, parent=trace.parent,
                    process=self.process, start=self.clock(),
                    args=dict(args or {}))
        with self._lock:
            self._spans[span_id] = span
        return span

    def end(self, span: Span | None, **args: Any) -> Span | None:
        """Close a span (idempotent; extra ``args`` merge in). Tolerates
        None so call sites can ``tracer.end(open_spans.pop(id, None))``."""
        if span is None or span.end is not None:
            return span
        span.end = self.clock()
        if args:
            span.args.update(args)
        if self.sink is not None:
            self.sink(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = 'span',
             trace: TraceContext | None = None,
             args: dict | None = None) -> Iterator[Span]:
        """Lexical span: ``with tracer.span('checkpoint-save'): ...``."""
        opened = self.begin(name, cat=cat, trace=trace, args=args)
        try:
            yield opened
        finally:
            self.end(opened)

    def instant(self, name: str, *, cat: str = 'span',
                trace: TraceContext | None = None,
                args: dict | None = None) -> Span:
        """A zero-duration mark (a reroute decision, a health verdict)."""
        span = self.begin(name, cat=cat, trace=trace, args=args)
        span.end = span.start
        span.phase = 'instant'
        if self.sink is not None:
            self.sink(span)
        return span

    def record(self, name: str, start: float, end: float, *,
               cat: str = 'span', trace: TraceContext | None = None,
               args: dict | None = None) -> Span:
        """A span with explicit timestamps — how the supervisor's
        recovery timeline and the elastic coordinator's wave stages
        (already measured as clock offsets) become spans after the fact,
        subsuming the ad-hoc ``stages`` dicts of ``RecoveryTimeline`` /
        ``ElasticTimeline``."""
        span = self.begin(name, cat=cat, trace=trace, args=args)
        span.start, span.end = float(start), float(end)
        if self.sink is not None:
            self.sink(span)
        return span

    # ----------------------------------------------------------- collect

    def pack(self) -> bytes:
        """The span set as bytes for the blob plane (whole set each time
        — phase cadence, not per span; :meth:`merge` dedupes by id)."""
        with self._lock:
            spans = [dataclasses.asdict(span)
                     for span in self._spans.values()]
        return pickle.dumps((self.process, spans),
                            protocol=pickle.HIGHEST_PROTOCOL)

    def merge(self, source: 'Tracer | bytes') -> int:
        """Fold another tracer's spans (or a :meth:`pack`ed set) into
        this one; id-keyed, so re-sending at phase cadence is idempotent
        (later copies win — they may carry the closed end of a span that
        was open last push). Returns how many spans the source held."""
        if isinstance(source, Tracer):
            packed = source.pack()
        else:
            packed = bytes(source)
        _, spans = pickle.loads(packed)
        with self._lock:
            for payload in spans:
                span = Span(**payload)
                self._spans[span.span_id] = span
        return len(spans)

    def send_spans(self, transport: Any, to: int = 0) -> None:
        """Ship this process's spans to ``to``'s collector over the
        existing blob plane (``send_blob``, key ``trace:{process}``) —
        call at phase cadence, exactly like hot-state replication. The
        receiving side chains :meth:`accept_blob` into its transport's
        ``on_blob`` (the supervisor's blob receiver ignores non-
        ``replica:`` keys, so the two coexist)."""
        transport.send_blob(to, f'trace:{self.process}', self.pack())

    def accept_blob(self, sender: int, key: str, data: bytes) -> bool:
        """Blob-plane receiver: merge ``trace:*`` payloads, ignore
        everything else (returns whether the key was ours, so callers
        can chain receivers)."""
        if not key.startswith('trace:'):
            return False
        self.merge(data)
        return True

    # ------------------------------------------------------------ export

    def events(self) -> list[dict]:
        """The Chrome trace events (the ``traceEvents`` array): metadata
        rows first (one pid per process label), then every span as a
        complete (``X``) or instant (``i``) event with
        ``trace_id``/``span_id``/``parent`` in ``args``."""
        with self._lock:
            spans = list(self._spans.values())
        processes = sorted({span.process for span in spans})
        pids = {process: index + 1 for index, process in enumerate(processes)}
        now = self.clock()
        out: list[dict] = [
            {'ph': 'M', 'name': 'process_name', 'pid': pids[process],
             'tid': 0, 'args': {'name': process}}
            for process in processes]
        for span in spans:
            args = {'trace_id': span.trace_id, 'span_id': span.span_id,
                    **span.args}
            if span.parent is not None:
                args['parent'] = span.parent
            event = {'name': span.name, 'cat': span.cat,
                     'pid': pids[span.process], 'tid': 0,
                     'ts': span.start * 1e6, 'args': args}
            if span.phase == 'instant':
                event.update(ph='i', s='p')
            else:
                end = span.end
                if end is None:       # died holding it: provisional end
                    end = max(now, span.start)
                    args['open'] = True
                event.update(ph='X', dur=max(0.0, (end - span.start) * 1e6))
            out.append(event)
        return out

    def export(self, path: str | os.PathLike) -> pathlib.Path:
        """Write the Perfetto/``chrome://tracing``-openable JSON file."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {'traceEvents': self.events(), 'displayTimeUnit': 'ms'}
        tmp = path.with_name(path.name + '.tmp')
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)            # atomic: a reader never sees a torn file
        return path

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def connected_traces(events: list) -> dict:
    """Group exported span/instant events by ``trace_id`` and verify
    connectivity: every span's ``parent`` must resolve to a span in the
    SAME trace (the no-orphans invariant — a replayed or rerouted span
    whose parent was never collected would dangle here). Raises
    :exc:`ValueError` naming the orphans; returns
    ``{trace_id: [event, ...]}``. The shared validator behind the fleet
    chaos drills and the dryrun stage — and the check to run on any
    export before trusting it."""
    spans = [event for event in events if event.get('ph') in ('X', 'i')]
    by_trace: dict = {}
    for event in spans:
        by_trace.setdefault(event['args']['trace_id'], []).append(event)
    for trace_id, group in by_trace.items():
        span_ids = {event['args']['span_id'] for event in group}
        orphans = [event['args']['span_id'] for event in group
                   if event['args'].get('parent')
                   and event['args']['parent'] not in span_ids]
        if orphans:
            raise ValueError(
                f'trace {trace_id!r} has {len(orphans)} orphan span(s) '
                f'{orphans} — their parents were never collected; merge '
                f'every process\'s spans before validating')
    return by_trace
