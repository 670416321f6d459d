"""Event-stream hash chain, the distributed race detector: the port of
:mod:`tpusystem.observe.ledger`.

The reference is single-threaded by construction — synchronous bus dispatch
(``torchsystem/services/prodcon.py:209-218``) means event ordering can never
race. In a job of several processes, every host runs its own bus, and SPMD
correctness silently assumes all hosts observe *the same event stream in the
same order*: a host that skips an epoch event, dispatches in a different
order, or diverges in a payload will eventually desynchronize collectives or
storage. There is no
TSAN for this; the debug-mode mechanism SURVEY.md §5 prescribes is a
**hash chain of dispatched events compared across hosts**.

Usage::

    ledger = EventLedger()
    ledger.tap(producer)                   # observe every dispatch
    ...
    ledger.verify(transport)               # epoch boundary; raises on divergence

Chain entries hash the event's *type name* and its **stable** payload fields
(ints, strings, bools, None). Floats are excluded by default — metric values
legitimately differ across hosts before the cross-host reduce, and the
detector targets *structural* divergence (ordering, missing/extra events,
shape-of-payload drift), not numeric noise. Pass ``strict=True`` to include
floats (rounded) when the stream is expected to be numerically identical.
"""

from __future__ import annotations

import dataclasses
from hashlib import sha256
from typing import Any

from tpusystem_torch.services.prodcon import Producer


class LedgerDivergence(AssertionError):
    """Hosts dispatched different event streams."""


class EventLedger:
    """Order-sensitive digest of every event dispatched on a bus."""

    def __init__(self, strict: bool = False) -> None:
        self.strict = strict
        self.digest = sha256(b'genesis').hexdigest()
        self.count = 0

    def _stable_fields(self, message: Any) -> list[tuple[str, Any]]:
        if not dataclasses.is_dataclass(message):
            return []
        stable: list[tuple[str, Any]] = []
        for field in dataclasses.fields(message):
            value = getattr(message, field.name, None)
            if isinstance(value, (int, str, bool, type(None))):
                stable.append((field.name, value))
            elif self.strict and isinstance(value, float):
                stable.append((field.name, round(value, 6)))
        return stable

    def record(self, message: Any) -> str:
        """Fold one event into the chain; returns the new chain digest."""
        entry = (type(message).__name__, self._stable_fields(message))
        self.digest = sha256((self.digest + repr(entry)).encode()).hexdigest()
        self.count += 1
        return self.digest

    def tap(self, producer: Producer) -> 'EventLedger':
        """Attach to a producer so every dispatch is recorded."""
        producer.taps.append(self.record)
        return self

    def verify(self, transport: Any) -> str:
        """Gather (count, digest) from every host and require unanimity.

        Call at a safe point (epoch boundary, checkpoint commit). Raises
        :class:`LedgerDivergence` naming the disagreeing ranks; returns the
        agreed digest otherwise. On :class:`~tpusystem_torch.parallel.
        multihost.Loopback` (the port's one-process transport) this is a
        no-op self-check.
        """
        states = sorted(transport.gather(
            (getattr(transport, 'rank', 0), self.count, self.digest)))
        if len({(count, digest) for _, count, digest in states}) > 1:
            detail = ', '.join(
                f'rank{rank}: {count} events, {digest[:12]}…'
                for rank, count, digest in states)
            raise LedgerDivergence(
                f'event streams diverged across hosts ({detail}) — a host '
                f'dispatched a different event sequence; check for '
                f'host-dependent control flow in services/consumers')
        return self.digest
