"""Domain events with exceptions-as-control-flow: the port of
:mod:`tpusystem.domain.events`.

An :class:`Events` buffer collects things that happened inside an aggregate
boundary and dispatches them on :meth:`Events.commit`. The contract mirrors
the reference (``torchsystem/domain/events.py:94-167``):

* both *instances* and *classes* may be enqueued, of plain events **and**
  exceptions;
* dispatch key is the event itself when it is a type, else its type;
* a handler taking zero parameters is called without the event, otherwise it
  receives the event;
* a handlers entry may be one callable or a sequence of callables;
* an exception with no registered handler is **raised** at commit time — this
  is the early-stopping mechanism (e.g. enqueue ``StopIteration`` and let it
  unwind the epoch loop);
* a plain event with no handler is silently dropped.

Where several processes train one model, the commit point must be reached
consistently on all of them; :func:`tpusystem_torch.parallel.multihost.agree`
is the agreement primitive that turns a local stop-exception into a
collective stop decision (one process in the port so far).
"""

from __future__ import annotations

from collections import deque
from collections.abc import Callable, Iterable, Sequence
from inspect import signature
from typing import Optional


class Event:
    """Optional base class for self-documenting domain events."""


EVENT = Event | type[Event] | Exception | type[Exception]
HANDLERS = Callable | Sequence[Callable]


def _is_exception(event: EVENT) -> bool:
    return isinstance(event, Exception) or (
        isinstance(event, type) and issubclass(event, Exception))


class Events:
    """FIFO of domain events with commit-time dispatch.

    Attributes:
        queue: pending events (instances or classes).
        handlers: mapping of event type -> callable or sequence of callables.
    """

    def __init__(self) -> None:
        self.queue: deque[EVENT] = deque()
        self.handlers: dict[type, HANDLERS] = {}

    def enqueue(self, event: EVENT) -> None:
        """Add an event (or exception) to the pending queue."""
        self.queue.append(event)

    def dequeue(self) -> Optional[EVENT]:
        """Pop the oldest pending event, or ``None`` when empty."""
        return self.queue.popleft() if self.queue else None

    def handle(self, event: EVENT) -> None:
        """Dispatch one event to its handlers.

        Raises the event when it is an unhandled exception (class or
        instance); silently ignores unhandled plain events.
        """
        key = event if isinstance(event, type) else type(event)
        registered = self.handlers.get(key)
        if registered:
            callables = registered if isinstance(registered, Iterable) else [registered]
            for handler in callables:
                if len(signature(handler).parameters) == 0:
                    handler()
                else:
                    handler(event)
        elif _is_exception(event):
            raise event

    def commit(self) -> None:
        """Drain the queue, dispatching each event in FIFO order."""
        while (event := self.dequeue()) is not None:
            self.handle(event)
