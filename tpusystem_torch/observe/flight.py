"""Crash flight recorder: the last seconds of a process, on disk. The
port of :mod:`tpusystem.observe.flight`, copied (standard library only).

A worker that exits 42/43/44/45 — or is SIGKILLed outright — takes its
final state with it: which requests were mid-decode, what the last ticks
emitted, which span was open. The supervisor recovers the *journal*, but
nothing showed what the worker itself saw. This module is the black box:

* a **bounded ring** of recent entries (events off the bus via
  :meth:`FlightRecorder.tap`, finished spans via :meth:`watch`, manual
  :meth:`note` breadcrumbs) — small host values only, O(capacity) RAM;
* **write-ahead persistence** — every ``cadence`` entries the ring is
  dumped to ``path`` by atomic rename, so even a SIGKILL (which runs no
  handler at all) leaves the last-dumped state on disk. The acceptance
  drill SIGKILLs a serving worker and matches the post-mortem's last
  entries against the journal the Supervisor recovered;
* **dump on the restart contract** — :meth:`install` registers the
  recorder so :func:`tpusystem_torch.parallel.recovery.exit_for_restart`
  flushes it (with the exit verdict stamped) on every typed 42/43/44
  exit, and the serving watchdog path
  (:class:`~tpusystem_torch.serve.ServingReplica`) dumps on an
  ``EngineStalled`` verdict;
* the **Supervisor attaches it** — pass ``flight_path=`` to
  :class:`~tpusystem_torch.parallel.Supervisor` and the worker inherits the
  path via ``TPUSYSTEM_FLIGHT`` (:meth:`FlightRecorder.from_env`); after
  every worker exit the supervisor reads the post-mortem back and
  carries it on the ``WorkerExited`` event, so "what the worker saw"
  rides the same bus as the verdict about it.

Entries are plain dicts ``{'t': clock(), 'kind': ..., **payload}`` with
already-materialized host values — the bus discipline, applied to the
black box.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import pathlib
import threading
import time
from typing import Any, Callable

logger = logging.getLogger('tpusystem_torch.observe.flight')

__all__ = ['FlightRecorder', 'dump_installed']

ENV_FLIGHT = 'TPUSYSTEM_FLIGHT'

# recorders armed for the restart-contract dump (exit_for_restart calls
# dump_installed); module-level on purpose — the exit path cannot thread
# a recorder handle through every raise site
_installed: list['FlightRecorder'] = []


class FlightRecorder:
    """Bounded ring of recent events/spans with write-ahead dumps.

    Args:
        path: the post-mortem file. None records in RAM only (dump
            explicitly with :meth:`dump`).
        capacity: ring size — older entries fall off.
        cadence: dump every N entries (1 = write-ahead on every entry,
            the SIGKILL-proof setting; larger trades durability window
            for fewer writes, exactly the journal's cadence contract).
        process: label stamped into the file.
        clock: injectable wall-time source (the usual discipline).
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 capacity: int = 256, cadence: int = 1,
                 process: str = 'worker',
                 clock: Callable[[], float] = time.monotonic) -> None:
        if capacity < 1 or cadence < 1:
            raise ValueError(
                f'capacity and cadence must be >= 1, got {capacity}/{cadence}')
        self.path = pathlib.Path(path) if path is not None else None
        self.capacity = capacity
        self.cadence = cadence
        self.process = process
        self.clock = clock
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.notes = 0
        self._write_failed = False
        # entries arrive from scheduler loops, supervisor threads and bus
        # dispatch at once; the lock covers ring mutation AND the dump's
        # snapshot so a mid-iteration append can't crash the black box
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env: dict | None = None,
                 **kwargs: Any) -> 'FlightRecorder | None':
        """The worker-side constructor: a recorder at the path the
        supervisor exported (``TPUSYSTEM_FLIGHT``), or None when
        unsupervised / recording is off."""
        path = (env if env is not None else os.environ).get(ENV_FLIGHT)
        return None if not path else cls(path, **kwargs)

    # ------------------------------------------------------------- intake

    def note(self, kind: str, **payload: Any) -> None:
        """Append one entry and persist at the cadence. Entries are
        sanitized at intake: one non-JSON-able breadcrumb must not
        poison every later dump of the whole ring (which would silently
        void the write-ahead SIGKILL guarantee for up to ``capacity``
        entries) — it degrades to its repr, alone."""
        entry = {'t': round(self.clock(), 6), 'kind': kind, **payload}
        try:
            json.dumps(entry)
        except (TypeError, ValueError):
            entry = {'t': entry['t'], 'kind': kind,
                     'unserializable': repr(payload)[:200]}
        with self._lock:
            self.ring.append(entry)
            self.notes += 1
            due = self.path is not None and self.notes % self.cadence == 0
        if due:
            self.dump()

    def record(self, message: Any) -> None:
        """Producer tap: fold a bus event into the ring, keeping only
        its stable host-value fields (the ledger's rule — ints, strings,
        bools, floats, None; payload objects like model aggregates stay
        out of the black box)."""
        import dataclasses
        payload = {}
        if dataclasses.is_dataclass(message):
            for field in dataclasses.fields(message):
                value = getattr(message, field.name, None)
                if isinstance(value, (int, float, str, bool, type(None))):
                    payload[field.name] = value
        self.note(type(message).__name__, **payload)

    def tap(self, producer: Any) -> 'FlightRecorder':
        """Observe every dispatch on a producer (the ledger's hook)."""
        producer.taps.append(self.record)
        return self

    def watch(self, tracer: Any) -> 'FlightRecorder':
        """Fold every span the tracer finishes into the ring. An
        existing sink is chained, not replaced — watching must not
        silently disconnect another consumer."""
        previous = tracer.sink

        def on_span(span: Any) -> None:
            self.note('span', name=span.name, cat=span.cat,
                      trace_id=span.trace_id, span_id=span.span_id,
                      seconds=(None if span.end is None
                               else round(span.end - span.start, 6)))
            if previous is not None:
                previous(span)
        tracer.sink = on_span
        return self

    # -------------------------------------------------------------- dump

    def dump(self, path: str | os.PathLike | None = None,
             **stamp: Any) -> pathlib.Path | None:
        """Write the ring as JSON (atomic rename — a reader, e.g. the
        supervisor picking up a post-mortem, never sees a torn file).
        ``stamp`` adds verdict fields (``reason='preempted'``...).
        Write failures degrade and log once: the black box must never
        take the process down."""
        target = pathlib.Path(path) if path is not None else self.path
        if target is None:
            return None
        with self._lock:                 # snapshot: a concurrent note()
            entries = list(self.ring)    # must not mutate mid-iteration
        payload = {'process': self.process,
                   'dumped_at': round(self.clock(), 6),
                   'entries': entries, **stamp}
        # OSError: filesystem trouble; TypeError/ValueError: a caller's
        # non-JSON-able breadcrumb — either way degrade and log once, the
        # black box must never take the process down
        try:
            serialized = json.dumps(payload)
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(target.name + '.tmp')
            tmp.write_text(serialized)
            tmp.replace(target)
        except (OSError, TypeError, ValueError) as error:
            if not self._write_failed:
                logger.warning('flight-recorder dump to %s failed (%s); '
                               'recording continues in RAM', target, error)
            self._write_failed = True
            return None
        self._write_failed = False
        return target

    @staticmethod
    def read(path: str | os.PathLike) -> dict | None:
        """A post-mortem back from disk, or None (missing/torn — a
        worker that died before its first dump left nothing)."""
        try:
            return json.loads(pathlib.Path(path).read_text())
        except (OSError, ValueError):
            return None

    # ----------------------------------------------------- exit contract

    def install(self) -> 'FlightRecorder':
        """Arm this recorder for the restart-contract dump:
        :func:`tpusystem_torch.parallel.recovery.exit_for_restart` calls
        :func:`dump_installed` with the verdict before returning its
        ``SystemExit``, so a typed 42/43/44 exit always flushes the
        black box (a SIGKILL relies on the write-ahead cadence
        instead)."""
        if self not in _installed:
            _installed.append(self)
        return self

    def uninstall(self) -> None:
        if self in _installed:
            _installed.remove(self)


def dump_installed(**stamp: Any) -> None:
    """Flush every installed recorder (the exit-contract hook); never
    raises — the process is already on its way out."""
    for recorder in list(_installed):
        try:
            recorder.dump(**stamp)
        except Exception:                        # pragma: no cover
            logger.exception('flight-recorder exit dump failed')
