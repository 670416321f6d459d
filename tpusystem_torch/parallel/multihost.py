"""Control plane, one-process form: the port of
:mod:`tpusystem.parallel.multihost` as far as one process goes.

The reference's Producer/Consumer and Publisher/Subscriber buses are
in-process method calls (``torchsystem/services/prodcon.py:209-218``,
``torchsystem/services/pubsub.py:206-215``) — the degenerate single-host
case. Across hosts, domain events raised on one worker (metrics,
Trained/Validated, stop requests) must reach consumers anywhere, and stop
decisions must be *collectively agreed* or hosts deadlock in collectives
(SURVEY.md §7.3 "events across hosts").

The port has the one-process half of that design: the :class:`World` of
one process, the :class:`Loopback` transport whose collectives are
identities, the distributed buses over it and :func:`agree`, so training
code written against them runs unchanged when more processes arrive. The
reference's TCP control plane (``TcpTransport``, the ``Hub`` router,
``connect`` and heartbeat failure detection) is not ported: a coordinator
or more than one process raises (ROADMAP queue 1 item 9).

- :class:`DistributedProducer` / :class:`DistributedPublisher` — drop-in
  supersets of the in-process buses. Events whose types are ``wire()``-d are
  handed to the transport; consumers may be registered ``primary_only`` so
  storage/TensorBoard run exactly once per experiment (SURVEY.md §5 "only
  rank-0 runs storage/TB consumers").
- :func:`agree` — boolean all-reduce over hosts: the early-stop commit
  point. One host's ``StopTraining`` becomes everyone's.

Event payloads must be plain host values — never device tensors.
"""

from __future__ import annotations

import queue
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from tpusystem_torch.services.prodcon import Consumer, Producer, event
from tpusystem_torch.services.pubsub import Publisher, Subscriber

# ---------------------------------------------------------------------------
# world


@dataclass(frozen=True)
class World:
    """Host-level topology facts (not devices — processes)."""
    process_index: int
    process_count: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def world() -> World:
    """The job's processes: one, the only form the port has."""
    return World(0, 1)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None) -> World:
    """Join the job: a no-op for the single process the port runs.

    Raises ``NotImplementedError`` for a coordinator or more than one
    process, which the reference joins through ``jax.distributed``."""
    if coordinator_address is not None or (num_processes or 1) > 1:
        raise NotImplementedError(
            'a job of more than one process (a coordinator or '
            'num_processes > 1) is not ported to tpusystem_torch yet '
            '(ROADMAP queue 1: 9. Multi-GPU parallelism)')
    return world()


# ---------------------------------------------------------------------------
# control-plane events


@event
class WorkerLost:
    """A host left the job; consumers decide the recovery policy
    (checkpoint-restore restart, mesh re-init, abort).

    ``reason`` records *how* the loss was detected: ``'socket'`` — the
    connection died without a ``bye`` (crash/SIGKILL, seen immediately) —
    vs ``'heartbeat'`` — the host went silent past the liveness timeout
    (alive-but-wedged: GC pause, hung NFS, a stuck collective). The two
    have different MTTR profiles (a stall eats the whole timeout before
    recovery starts), so the ledger and recovery timeline distinguish
    them."""
    rank: int
    last_seen: float
    reason: str = 'socket'


@event
class WorkerJoined:
    """A host attached to the control plane."""
    rank: int


# bound on a single blob frame's payload: large transfers (hot TrainState
# replicas) are chunked so one blob cannot monopolize the control-plane
# socket — heartbeats and collective frames interleave between chunks
BLOB_CHUNK = 1 << 20


class BlobError(RuntimeError):
    """A point-to-point blob transfer failed (peer had no such blob, a
    chunk was lost/truncated in flight, or the wait timed out). Blobs are
    a best-effort sidecar of the control plane — the caller decides the
    fallback (for hot state: restore from disk)."""


_REDUCERS: dict[str, Callable[[list], Any]] = {
    'and': all,
    'or': any,
    'sum': sum,
    'min': min,
    'max': max,
}


# ---------------------------------------------------------------------------
# transports


class Loopback:
    """Single-process control plane: collectives are identities, nothing is
    forwarded. Keeps one code path from one process to many."""

    rank = 0
    size = 1

    def __init__(self) -> None:
        self._channels: dict[str, Callable[[Any], None]] = {}
        self.on_control: Callable[[tuple], None] | None = None
        self.on_blob: Callable[[int, str, bytes], None] | None = None
        self.on_blob_request: Callable[[str], bytes | None] | None = None

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        """Register the receiver for one named event channel (each bus owns
        its own channel, so several buses share one transport)."""
        self._channels[channel] = callback

    def send_event(self, channel: str, message: Any) -> None:
        pass

    def send_blob(self, to: int, key: str, data: bytes,
                  chunk_size: int = BLOB_CHUNK) -> None:
        if self.on_blob is not None:
            self.on_blob(0, key, bytes(data))

    def fetch_blob(self, peer: int, key: str, timeout: float = 30.0) -> bytes:
        data = (self.on_blob_request(key)
                if self.on_blob_request is not None else None)
        if data is None:
            raise BlobError(f'no blob {key!r} on the loopback transport')
        return bytes(data)

    def allreduce(self, value: Any, op: str = 'and') -> Any:
        return _REDUCERS[op]([value])

    def gather(self, value: Any) -> list:
        return [value]

    def barrier(self, timeout: float = 300.0) -> None:
        pass

    def heartbeat(self) -> None:
        pass

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# distributed buses


class DistributedProducer(Producer):
    """The in-process :class:`Producer`, extended across hosts.

    - ``register(consumer, primary_only=True)`` — the consumer runs only on
      rank 0 (storage, TensorBoard), all other ranks skip it silently.
    - ``wire(EventType, ...)`` — instances of these types are forwarded to
      every other host on dispatch. Unwired events stay host-local (the
      default: most events are per-host observability).
    - remote events arrive on a transport thread and are queued; call
      :meth:`drain` at a safe point in the host loop (epoch boundary) to
      dispatch them locally — keeps consumers single-threaded, matching the
      reference's synchronous bus semantics.
    """

    CHANNEL = 'producer'

    def __init__(self, transport: Loopback | None = None):
        super().__init__()
        self.transport = transport or Loopback()
        self.wired: tuple[type, ...] = ()
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self.transport.subscribe(self.CHANNEL, self._inbox.put)
        previous = self.transport.on_control

        def on_control(frame: tuple) -> None:
            if frame[0] == 'lost':
                self._inbox.put(WorkerLost(
                    rank=frame[1], last_seen=frame[2],
                    reason=frame[3] if len(frame) > 3 else 'socket'))
            elif frame[0] == 'joined':
                self._inbox.put(WorkerJoined(rank=frame[1]))
            if previous is not None:
                previous(frame)
        self.transport.on_control = on_control

    def register(self, *consumers: Consumer, primary_only: bool = False) -> None:
        if primary_only and self.transport.rank != 0:
            return
        super().register(*consumers)

    def wire(self, *event_types: type) -> None:
        self.wired = tuple(dict.fromkeys(self.wired + event_types))

    def dispatch(self, message: Any) -> None:
        super().dispatch(message)
        if isinstance(message, self.wired):
            self.transport.send_event(self.CHANNEL, message)

    def drain(self) -> int:
        """Dispatch queued remote events on the caller's thread; returns the
        number delivered. Call once per epoch/phase — never per step."""
        delivered = 0
        while True:
            try:
                message = self._inbox.get_nowait()
            except queue.Empty:
                return delivered
            super().dispatch(message)
            delivered += 1


class DistributedPublisher(Publisher):
    """Topic bus across hosts: wired topics forward ``(topic, message)``."""

    CHANNEL = 'publisher'

    def __init__(self, transport: Loopback | None = None):
        super().__init__()
        self.transport = transport or Loopback()
        self.wired: frozenset[str] = frozenset()
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self.transport.subscribe(self.CHANNEL, self._inbox.put)

    def register(self, *subscribers: Subscriber, primary_only: bool = False) -> None:
        if primary_only and self.transport.rank != 0:
            return
        super().register(*subscribers)

    def wire(self, *topics: str) -> None:
        self.wired = self.wired | frozenset(topics)

    def publish(self, message: Any, topic: str) -> None:
        super().publish(message, topic)
        if topic in self.wired:
            self.transport.send_event(self.CHANNEL, (topic, message))

    def drain(self) -> int:
        delivered = 0
        while True:
            try:
                topic, message = self._inbox.get_nowait()
            except queue.Empty:
                return delivered
            super().publish(message, topic)
            delivered += 1


# ---------------------------------------------------------------------------
# agreement — the early-stop commit point


def agree(transport: Loopback, flag: bool, op: str = 'or') -> bool:
    """Collectively agree a boolean across hosts.

    Early stopping in the reference is an exception unwinding one process
    (``torchsystem/domain/events.py:162-163``); across hosts every process
    must reach the same verdict *before* the next collective or the job
    deadlocks. Default ``op='or'``: any host wanting to stop stops all —
    call at the epoch boundary::

        stop = agree(transport, wants_stop)
        if stop: break
    """
    return bool(transport.allreduce(bool(flag), op=op))
