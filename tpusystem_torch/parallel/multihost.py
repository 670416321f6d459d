"""Multi-process control plane: the event buses, across worker processes.
The port of :mod:`tpusystem.parallel.multihost`, copied: the TCP star
(:class:`Hub`, :class:`TcpTransport`, :func:`connect`) is standard-library
sockets and threads.

The reference's Producer/Consumer and Publisher/Subscriber buses are
in-process method calls (``torchsystem/services/prodcon.py:209-218``,
``torchsystem/services/pubsub.py:206-215``) — the degenerate single-host
case. A job of many processes runs one Python process per worker; domain
events raised on one worker (metrics, Trained/Validated, stop requests)
must reach consumers anywhere, and stop decisions must be *collectively
agreed* or workers deadlock in collectives (SURVEY.md §7.3 "events across
hosts").

Two planes, by design:

- **data plane** — tensors move between devices through device
  collectives (``torch.distributed``, :mod:`tpusystem_torch.parallel.
  collectives`). This module only starts its process group.
- **control plane** (this module) — small, host-side, already-materialized
  Python values move over a TCP star: the primary process runs a
  :class:`Hub` router; every process (primary included) attaches a
  :class:`TcpTransport` client. The same API degrades to :class:`Loopback`
  in one process, so training code is identical in one process and many.

Capabilities:

- :class:`DistributedProducer` / :class:`DistributedPublisher` — drop-in
  supersets of the in-process buses. Events whose types are ``wire()``-d are
  forwarded to every other process; consumers may be registered
  ``primary_only`` so storage/TensorBoard run exactly once per experiment
  (SURVEY.md §5 "only rank-0 runs storage/TB consumers").
- :func:`agree` — boolean all-reduce over processes: the early-stop commit
  point. One process's ``StopTraining`` becomes everyone's.
- heartbeat failure detection — the hub tracks per-process liveness and
  broadcasts :class:`WorkerLost` as a *domain event* when a process goes
  silent, so recovery policy is just another consumer (SURVEY.md §5
  "failure detection").
- hub redundancy — a standby deputy :class:`Hub` promotes when the
  primary's dies; clients fail over to it.
- the blob plane — chunked, digest-verified point-to-point byte transfers
  (``send_blob``/``fetch_blob``) that hot-state replication rides.

:func:`initialize` names the job's :class:`World` (its arguments, else
``TPUSYSTEM_PROCESS_ID`` / ``TPUSYSTEM_NUM_PROCESSES``); given a device it
joins the device plane, ``torch.distributed.init_process_group`` (NCCL on
the card, gloo on the CPU). The control plane is :func:`connect`'s
(``Runtime`` calls it).

Transport frames are length-prefixed pickles on a trusted cluster network
(the same trust model as NCCL/MPI bootstrap); event payloads must be plain
host values — never device tensors.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import pickle
import queue
import socket
import struct
import threading
import time
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from tpusystem_torch.services.prodcon import Consumer, Producer, event
from tpusystem_torch.services.pubsub import Publisher, Subscriber

logger = logging.getLogger('tpusystem_torch.multihost')

# how a process of a job of many learns its place when the caller does not
# pass it (the reference reads it from the JAX runtime)
PROCESS_ID_ENV = 'TPUSYSTEM_PROCESS_ID'
NUM_PROCESSES_ENV = 'TPUSYSTEM_NUM_PROCESSES'

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


_WORLD = World(0, 1)


def world() -> World:
    """The job's processes as :func:`initialize` last named them (one
    process until then)."""
    return _WORLD


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               backend: str | None = None) -> World:
    """Name this process's place in the job and return the :class:`World`.

    One process when neither a coordinator nor more than one process is
    given, so the same ``main()`` runs unchanged in one process. Otherwise
    ``num_processes`` and ``process_id`` come from the arguments, else from
    ``TPUSYSTEM_NUM_PROCESSES`` and ``TPUSYSTEM_PROCESS_ID``
    (``ValueError`` when either is missing or out of range).

    With a ``device`` (``'cuda'`` or ``'cpu'``) it also joins the device
    plane, the reference's ``jax.distributed.initialize``:
    ``torch.distributed.init_process_group`` over this world, its backend
    following the device (NCCL on the card, this rank's card
    ``process_id % device_count``; gloo on the CPU), its rendezvous a
    ``TCPStore`` at the coordinator's address (rank 0 serves it). A world
    of one with a coordinator joins too (a group of one rank). The
    rendezvous and every collective wait at most
    :data:`DEVICE_PLANE_TIMEOUT` seconds for a rank. ``backend``
    names another backend explicitly (``'gloo'`` over CUDA tensors: ranks
    that share one card, which NCCL refuses). Without a ``device`` it
    joins nothing: the control plane is :func:`connect`'s (``Runtime``
    calls it). :func:`shutdown` leaves the device plane.
    """
    global _WORLD
    import os
    if coordinator_address is None and (num_processes or 1) <= 1:
        _WORLD = World(0, 1)
        return _WORLD
    if num_processes is None and os.environ.get(NUM_PROCESSES_ENV):
        num_processes = int(os.environ[NUM_PROCESSES_ENV])
    if process_id is None and os.environ.get(PROCESS_ID_ENV):
        process_id = int(os.environ[PROCESS_ID_ENV])
    if num_processes is None or process_id is None:
        raise ValueError(
            f'a job of many processes needs num_processes and process_id '
            f'(or {NUM_PROCESSES_ENV} and {PROCESS_ID_ENV}): got '
            f'{num_processes!r} and {process_id!r}')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'process_id {process_id} is outside a job of '
                         f'{num_processes} processes')
    _WORLD = World(process_id, num_processes)
    if device is not None:
        _join_device_plane(coordinator_address, _WORLD, device, backend)
    return _WORLD


# the backend of each device type: the process group follows the device
BACKENDS = {'cuda': 'nccl', 'cpu': 'gloo'}

# seconds the device plane's rendezvous and collectives wait for a rank
DEVICE_PLANE_TIMEOUT = 300.0


# the device this process's device plane drives (set by initialize)
_DEVICE = None


def device_plane():
    """The device the device plane was joined for (this rank's card, or
    the CPU), or None where this process joined none."""
    return _DEVICE


def _join_device_plane(coordinator: str | None, job: World, device,
                       backend: str | None) -> None:
    import datetime

    import torch

    from tpusystem_torch.device import resolve_device
    global _DEVICE
    if coordinator is None:
        raise ValueError('the device plane needs the coordinator\'s '
                         'host:port for its rendezvous store')
    kind = resolve_device(device).type
    if kind not in BACKENDS:
        raise ValueError(f'no process-group backend for device {device!r}')
    if kind == 'cuda':
        index = job.process_index % torch.cuda.device_count()
        torch.cuda.set_device(index)
        _DEVICE = torch.device('cuda', index)
    else:
        _DEVICE = torch.device(kind)
    host, _, port = coordinator.rpartition(':')
    wait = datetime.timedelta(seconds=DEVICE_PLANE_TIMEOUT)
    store = torch.distributed.TCPStore(
        host, int(port), job.process_count, job.process_index == 0,
        timeout=wait)
    torch.distributed.init_process_group(
        backend or BACKENDS[kind], store=store, rank=job.process_index,
        world_size=job.process_count, timeout=wait)


def shutdown() -> None:
    """Leave the device plane (``destroy_process_group``), where this
    process joined one."""
    import torch
    global _DEVICE
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _DEVICE = None


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


# ---------------------------------------------------------------------------
# wire format

_LEN = struct.Struct('>Q')


def _send_frame(sock: socket.socket, payload: tuple) -> None:
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b''.join(chunks)


def _recv_frame(sock: socket.socket) -> tuple | None:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    blob = _recv_exact(sock, _LEN.unpack(header)[0])
    return None if blob is None else pickle.loads(blob)


# client-local sentinel: a 'rejected' frame resolves the waiting collective
_REJECTED = object()
# client-local sentinel: the active hub died mid-collective (failover)
_FAILED_OVER = object()
# client-local sentinels for fetch_blob: peer has no such blob / the
# reassembled bytes failed their digest (a chunk was truncated in flight) /
# the transport died or failed over with the fetch in flight
_BLOB_NAK = object()
_BLOB_CORRUPT = object()
_BLOB_DEAD = object()

# bound on a single blob frame's payload: large transfers (hot TrainState
# replicas) are chunked so one blob cannot monopolize the control-plane
# socket — heartbeats and collective frames interleave between chunks
BLOB_CHUNK = 1 << 20


def _blob_digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class BlobError(RuntimeError):
    """A point-to-point blob transfer failed (peer had no such blob, a
    chunk was lost/truncated in flight, or the wait timed out). Blobs are
    a best-effort sidecar of the control plane — the caller decides the
    fallback (for hot state: restore from disk)."""


class ControlPlaneFailover(RuntimeError):
    """The active hub died while this collective was in flight.

    The result may have reached some ranks and not others, so the op
    cannot be transparently retried — surface the failover and let the
    caller resynchronize at a safe point (epoch boundary / checkpoint
    restore). Collectives issued *after* the failover complete normally
    on the promoted deputy."""


class CollectiveTimeout(ControlPlaneFailover):
    """A host collective did not complete within its timeout.

    The usual cause is a peer that died or hung *between* sync points —
    alive enough that the hub has not excluded it, but never contributing
    its share — so the waiter would otherwise block forever. Raised typed
    (instead of the raw ``queue.Empty`` it used to surface as) so callers
    can checkpoint-fence and restart like any other control-plane loss.
    """

_REDUCERS: dict[str, Callable[[list], Any]] = {
    'and': all,
    'or': any,
    'sum': sum,
    'min': min,
    'max': max,
}


# ---------------------------------------------------------------------------
# hub (runs on the primary host)


class Hub:
    """Star-topology router for the control plane.

    Pure router: every host (the primary included) attaches a
    :class:`TcpTransport` client, so client logic is rank-uniform. The hub
    forwards ``event`` frames to every *other* client, completes collective
    ops (``reduce``/``gather``/``barrier``) once all ranks contribute, and
    monitors heartbeats.
    """

    def __init__(self, size: int, host: str = '127.0.0.1', port: int = 0,
                 heartbeat_timeout: float | None = None,
                 standby_of: tuple | None = None):
        self.size = size
        self.heartbeat_timeout = heartbeat_timeout
        self._server = socket.create_server((host, port))
        self.address = self._server.getsockname()
        self._clients: dict[int, socket.socket] = {}
        self._locks = threading.Lock()
        # one send lock per client: hub threads (client loops routing blob
        # chunks, the monitor's lost fanout, the accept loop's joined
        # fanout) write concurrently to the same sockets, and a 1 MiB blob
        # chunk's sendall can interleave mid-frame with another thread's
        # frame — a torn length-prefixed stream desyncs the client for
        # good. Small frames rode single send() calls; blobs ended that.
        self._send_locks: dict[int, threading.Lock] = {}
        self._pending: dict[tuple, list] = {}
        self._last_seen: dict[int, float] = {}
        self._lost: set[int] = set()
        # ranks out of the collective quota for good (crash, timeout, bye);
        # see _live() for why this set only grows
        self._excluded: set[int] = set()
        self._closed = threading.Event()
        # Deputy mode: while the primary hub (at ``standby_of``) is alive,
        # answer every contribution with ('standby',) so a client whose
        # *link* to the primary flaked cannot split the pod — it is told to
        # go back. When the hub-to-hub peer link dies, promote and serve.
        self._standby = threading.Event()
        self._peers: list[socket.socket] = []   # standby deputies' links
        if standby_of is not None:
            self._standby.set()
        self._threads = [threading.Thread(target=self._accept_loop, daemon=True)]
        if standby_of is not None:
            self._threads.append(threading.Thread(
                target=self._peer_monitor, args=(standby_of,), daemon=True))
        if heartbeat_timeout:
            self._threads.append(
                threading.Thread(target=self._monitor_loop, daemon=True))
        for thread in self._threads:
            thread.start()

    @property
    def is_standby(self) -> bool:
        return self._standby.is_set()

    def _peer_monitor(self, primary_address: tuple) -> None:
        """Hold a hub-to-hub link to the primary; promote when it dies.

        A broken link is confirmed by redial before promoting: a transient
        blip on the peer socket alone must not create two active hubs
        (split brain). Only when the primary is unreachable afresh does the
        deputy take over."""

        def dial(deadline: float):
            while not self._closed.is_set() and time.monotonic() < deadline:
                try:
                    sock = socket.create_connection(primary_address,
                                                    timeout=5.0)
                    sock.settimeout(None)
                    _send_frame(sock, ('peer',))
                    return sock
                except OSError:
                    time.sleep(0.1)
            return None

        # bootstrap: generous window for the primary to come up at all
        sock = dial(time.monotonic() + 60.0)
        while sock is not None and not self._closed.is_set():
            try:
                while not self._closed.is_set():
                    if _recv_frame(sock) is None:
                        break
            except OSError:
                pass
            finally:
                sock.close()
            # link died: confirm by redial (short window) before promoting
            sock = dial(time.monotonic() + 3.0)
        if not self._closed.is_set():
            # The primary's exclusion state died with it. Seed liveness for
            # every rank not yet connected here: ranks lost BEFORE the
            # failover never dial in, the heartbeat monitor marks them
            # stale, and collectives degrade to the survivors instead of
            # deadlocking on ghosts. (Without heartbeats there is no
            # failure detection at all — same contract as the primary.)
            with self._locks:
                now = time.monotonic()
                for rank in range(self.size):
                    if rank not in self._clients:
                        self._last_seen.setdefault(rank, now)
            self._standby.clear()       # promote
            self._complete_satisfied()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            try:
                frame = _recv_frame(sock)
            except OSError:
                continue
            if frame and frame[0] == 'peer':
                # a standby deputy monitoring this hub: keep the socket open
                # (its death is how the deputy learns we died); nothing to read
                with self._locks:
                    self._peers.append(sock)
                threading.Thread(target=self._peer_hold, args=(sock,),
                                 daemon=True).start()
                continue
            if not frame or frame[0] != 'hello':
                sock.close()
                continue
            rank = frame[1]
            with self._locks:
                self._clients[rank] = sock
                self._send_locks.setdefault(rank, threading.Lock())
                self._last_seen[rank] = time.monotonic()
                self._lost.discard(rank)     # a rejoining worker is alive
                # NOT removed from _excluded: see _live()
            self._fanout(('joined', rank), exclude=rank)
            threading.Thread(target=self._client_loop, args=(rank, sock),
                             daemon=True).start()

    def _peer_hold(self, sock: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                if _recv_frame(sock) is None:
                    return
        except OSError:
            pass
        finally:
            sock.close()

    def _client_loop(self, rank: int, sock: socket.socket) -> None:
        while not self._closed.is_set():
            try:
                frame = _recv_frame(sock)
            except OSError:
                frame = None
            if frame is None or frame[0] == 'bye':
                # 'bye' is a graceful detach; a dead connection (None) means
                # the worker crashed — report it as lost immediately rather
                # than waiting for the heartbeat monitor (which could never
                # fire: the rank leaves the liveness table here).
                # A STANDBY deputy never judges: clients touch it only
                # transiently (failover probing before promotion, bounced
                # flakes), and excluding them here would lock healthy ranks
                # out of the quota for the deputy's whole post-promotion life.
                standby = self._standby.is_set()
                with self._locks:
                    self._clients.pop(rank, None)
                    last_seen = self._last_seen.pop(rank, time.monotonic())
                    crashed = (not standby and frame is None
                               and rank not in self._lost
                               and not self._closed.is_set())
                    if crashed:
                        self._lost.add(rank)
                    if not standby:
                        self._excluded.add(rank)
                sock.close()
                if crashed:
                    self._fanout(('lost', rank, last_seen, 'socket'))
                # either way the rank can no longer contribute: complete
                # collectives that were only waiting on it
                self._complete_satisfied()
                return
            with self._locks:
                self._last_seen[rank] = time.monotonic()
                self._lost.discard(rank)     # any frame proves recovery
            kind = frame[0]
            if kind == 'hb':
                continue
            if self._standby.is_set() and kind in ('event', 'reduce', 'gather',
                                                   'blob', 'blob-req',
                                                   'blob-nak'):
                # not the active hub: tell the client to go back to the
                # primary (its link may have flaked while the primary lives)
                self._send_to(rank, sock, ('standby',))
                continue
            if kind == 'event':
                self._fanout(frame, exclude=rank)
            elif kind in ('blob', 'blob-req', 'blob-nak'):
                # point-to-point: route to the addressee only, rewriting the
                # 'to' slot into 'from' so the receiver can answer. Blobs are
                # best-effort (the sidecar of the control plane): an absent
                # addressee just drops the frame — the requester's timeout
                # (or the replica's previous copy) is the fallback.
                to = frame[1]
                with self._locks:
                    target = self._clients.get(to)
                if target is not None:
                    self._send_to(to, target, (kind, rank) + frame[2:])
            elif kind in ('reduce', 'gather'):
                _, op_key, value = frame
                with self._locks:
                    if rank in self._excluded:
                        # a rank outside the quota (crashed-then-revived or
                        # restarted) must not resurrect completed op_keys or
                        # skew live ranks' sequence numbers: reject it
                        # explicitly. (Its op counter restarted at 0, so its
                        # op_key can never line up with the survivors' —
                        # without the reject it would block until timeout.)
                        excluded = True
                    else:
                        excluded = False
                        values = self._pending.setdefault(op_key, {})
                        values[rank] = value
                        done = self._live() <= values.keys()
                        if done:
                            del self._pending[op_key]
                if excluded:
                    self._send_to(rank, sock, ('rejected', op_key))
                    continue
                if done:
                    self._emit_result(op_key, values)

    def _monitor_loop(self) -> None:
        while not self._closed.wait(self.heartbeat_timeout / 4):
            now = time.monotonic()
            with self._locks:
                stale = [(rank, seen) for rank, seen in self._last_seen.items()
                         if now - seen > self.heartbeat_timeout
                         and rank not in self._lost]
                if self._standby.is_set():
                    # a STANDBY deputy never judges (same guard as
                    # _client_loop): clients touch it only transiently and
                    # send no heartbeats here, so a stale entry means a
                    # flaked probe, not a dead rank — drop the socket and
                    # liveness entry instead of excluding a healthy rank
                    # from the quota for the deputy's post-promotion life
                    for rank, _ in stale:
                        sock = self._clients.pop(rank, None)
                        self._last_seen.pop(rank, None)
                        if sock is not None:
                            sock.close()
                    continue
                self._lost.update(rank for rank, _ in stale)
                self._excluded.update(rank for rank, _ in stale)
            for rank, seen in stale:
                self._fanout(('lost', rank, seen, 'heartbeat'))
            if stale:
                self._complete_satisfied()

    def _send_to(self, rank: int, sock: socket.socket, frame: tuple) -> None:
        """Serialize whole frames per client socket (see ``_send_locks``);
        a dead link is the receiver's problem, not the sender thread's."""
        with self._locks:
            lock = self._send_locks.setdefault(rank, threading.Lock())
        with lock:
            try:
                _send_frame(sock, frame)
            except OSError:
                pass

    def _live(self) -> set[int]:
        """Ranks a collective must wait for. The quota only ever shrinks:
        losing a host degrades collectives to the survivors (what lets the
        'observe' recovery policy keep agreeing stops instead of
        deadlocking), and a rank that left — crash, heartbeat timeout, or
        graceful 'bye' — never counts again for this Hub's lifetime (a
        restarted worker's op counters restart at 0, so its contributions
        cannot line up with the survivors'; full re-admission is the
        restart-resume cycle, :mod:`tpusystem_torch.parallel.recovery`). It still
        receives events and control frames, but NOT collective results: its
        own collective calls fail fast with a 'rejected' frame (silently
        consuming survivor results while its own contributions are dropped
        would let it believe it participated). Caller holds the lock."""
        return set(range(self.size)) - self._excluded

    def readmit(self, rank: int) -> None:
        """Return a previously excluded rank to the collective quota — the
        elastic grow's re-admission step (:mod:`tpusystem_torch.parallel.
        elastic`).

        The quota normally only shrinks (see :meth:`_live`): a restarted
        worker's op counters restart at 0 and can never line up with the
        survivors' mid-stream. Re-admission is therefore only sound at a
        *membership-epoch boundary*, when EVERY rank restarts its
        counters together — exactly what the resize relaunch guarantees
        (all workers re-exec under the new world spec). Call it on the
        hub when the epoch commits folding ``rank`` back in; calling it
        into a live, counting pod would desync collective keys."""
        with self._locks:
            self._excluded.discard(rank)
            self._lost.discard(rank)

    def _emit_result(self, op_key: tuple, values: dict[int, Any]) -> None:
        # include every contribution received for this op — a rank that
        # voted and then died still voted
        contributions = [values[rank] for rank in sorted(values)]
        kind_name, op, _ = op_key
        result = (_REDUCERS[op](contributions) if kind_name == 'reduce'
                  else contributions)
        # live_only: an excluded-but-connected rank (heartbeat stall whose op
        # counter still lines up) must not race a 'result' against its
        # 'rejected' — its collectives deterministically fail fast
        self._fanout(('result', op_key, result), live_only=True)

    def _complete_satisfied(self) -> None:
        """After a loss, pending collectives that were only waiting on the
        departed rank complete with the contributions already received."""
        with self._locks:
            live = self._live()
            ready = [(op_key, values)
                     for op_key, values in self._pending.items()
                     if live <= values.keys()]
            for op_key, _ in ready:
                del self._pending[op_key]
        for op_key, values in ready:
            self._emit_result(op_key, values)

    def _fanout(self, frame: tuple, exclude: int | None = None,
                live_only: bool = False) -> None:
        with self._locks:
            targets = [(rank, sock) for rank, sock in self._clients.items()
                       if rank != exclude
                       and not (live_only and rank in self._excluded)]
        for rank, sock in targets:
            self._send_to(rank, sock, frame)

    def close(self) -> None:
        self._closed.set()
        self._server.close()
        with self._locks:
            # shutdown before close: close() alone does not send FIN while
            # another thread blocks in recv on the same fd, so clients (and
            # standby deputies) would never learn this hub died
            for sock in list(self._clients.values()) + self._peers:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                sock.close()
            self._clients.clear()
            self._peers.clear()


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


class TcpTransport:
    """Per-host client of the :class:`Hub`.

    ``send_event`` forwards a pickled message to every other host (delivered
    to their ``on_event``); ``allreduce``/``gather``/``barrier`` are
    collective over all hosts and must be called in the same order on every
    rank (SPMD control flow — the same discipline device collectives require).
    """

    def __init__(self, address, rank: int, size: int,
                 heartbeat_interval: float | None = None,
                 connect_timeout: float = 60.0):
        self.rank = rank
        self.size = size
        # one address, or an ordered [primary, deputy, ...] failover list
        self._addresses = ([tuple(a) for a in address]
                           if isinstance(address, list) else [tuple(address)])
        self._active = 0
        self._channels: dict[str, Callable[[Any], None]] = {}
        self.on_control: Callable[[tuple], None] | None = None
        self._send_lock = threading.Lock()
        self._results: dict[tuple, queue.Queue] = {}
        self._results_lock = threading.Lock()
        # unanswered collective frames, replayed after a 'standby' redirect
        # (the deputy deterministically dropped them); abandoned with
        # _FAILED_OVER when the active hub died (delivery state unknown)
        self._pending_sends: dict[tuple, tuple] = {}
        self._counter = itertools.count()
        # point-to-point blob plane (chunked, digest-verified): in-flight
        # reassemblies, completed unclaimed blobs, and fetch_blob waiters
        self.blob_chunk = BLOB_CHUNK   # per-frame payload bound
        self._blob_lock = threading.Lock()
        self._blob_parts: dict[tuple, dict] = {}
        self._blob_ready: dict[str, tuple[int, bytes]] = {}
        # fetch waiters are keyed by blob key but pinned to the peer the
        # request went to: a same-key blob arriving from anyone else (e.g.
        # the buddy's own concurrent push) must not satisfy the fetch.
        # The request frame rides along so a standby bounce / redial can
        # replay it (a deputy deterministically drops blob-reqs).
        self._blob_waiters: dict[str, tuple[int, queue.Queue, tuple]] = {}
        self.on_blob: Callable[[int, str, bytes], None] | None = None
        self.on_blob_request: Callable[[str], bytes | None] | None = None
        self._closed = threading.Event()
        self._reconnected = threading.Event()
        self._dead = False       # set when every failover avenue is spent
        self._sock = self._dial(self._addresses[0], connect_timeout)
        self._reconnected.set()
        self._threads = [threading.Thread(target=self._recv_loop, daemon=True)]
        if heartbeat_interval:
            self._threads.append(threading.Thread(
                target=self._heartbeat_loop, args=(heartbeat_interval,),
                daemon=True))
        for thread in self._threads:
            thread.start()

    def _dial(self, address: tuple, connect_timeout: float) -> socket.socket:
        # Hosts of a pod start concurrently; the hub may not be listening
        # yet when a non-primary dials in — bounded retry with backoff.
        deadline = time.monotonic() + connect_timeout
        delay = 0.05
        while True:
            try:
                sock = socket.create_connection(address, timeout=5.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
        sock.settimeout(None)
        _send_frame(sock, ('hello', self.rank))
        return sock

    def _send(self, frame: tuple, op_key: tuple | None = None) -> None:
        # a send racing a failover retries while the recv loop replaces
        # self._sock in the background — EXCEPT when the op it belongs to
        # was abandoned by that failover: delivering a pre-failover
        # collective frame to the promoted deputy would plant an op_key no
        # other rank will ever complete
        deadline = time.monotonic() + 60.0
        while True:
            try:
                with self._send_lock:
                    if op_key is not None:
                        with self._results_lock:
                            abandoned = op_key not in self._pending_sends
                        if abandoned:
                            raise ControlPlaneFailover(
                                f'rank {self.rank}: collective abandoned '
                                f'by a control-plane failover before send')
                    _send_frame(self._sock, frame)
                return
            except OSError:
                if (self._closed.is_set() or self._dead
                        or time.monotonic() >= deadline):
                    raise
                self._reconnected.wait(timeout=0.5)
                if self._dead:
                    raise

    def _recv_loop(self) -> None:
        while not self._closed.is_set():
            try:
                frame = _recv_frame(self._sock)
            except OSError:
                frame = None
            if frame is None:
                if self._closed.is_set():
                    # the transport was closed with collectives still in
                    # flight (pod teardown races a waiting thread): fail
                    # them typed and fast, never leave a waiter to ride
                    # out its full collective timeout into a raw
                    # queue.Empty (regression: test_chaos.py::TestClose)
                    self._abandon()
                    return
                if not self._failover():
                    self._abandon()
                    return
                continue
            if frame[0] == 'standby':
                # we dialed a standby deputy while the primary lives (our
                # link flaked, not the primary): go back to the primary and
                # replay the frames the deputy deterministically dropped
                if self._redial(0, replay=True, connect_timeout=5.0):
                    continue
                # primary unreachable after all: the deputy will promote —
                # return to it (the 0.2s same-index pause gives it time)
                if self._redial(self._active, replay=True):
                    continue
                self._abandon()
                return
            kind = frame[0]
            if kind == 'event':
                callback = self._channels.get(frame[1])
                if callback is not None:
                    callback(frame[2])
            elif kind == 'result':
                _, op_key, result = frame
                # deliver only to a registered box (always present for own
                # ops — registered before send); a result landing after the
                # waiter timed out (CollectiveTimeout popped its box) must
                # not leak a fresh never-read queue into _results
                with self._results_lock:
                    box = self._results.get(op_key)
                if box is not None:
                    box.put(result)
            elif kind == 'rejected':
                # the hub excluded this rank from the quota; fail the
                # waiting call fast instead of letting it hit its timeout.
                # Deliver only to a registered box (always present for own
                # ops — registered before send); a stray late frame must
                # not leak a fresh queue into _results.
                with self._results_lock:
                    box = self._results.get(frame[1])
                if box is not None:
                    box.put(_REJECTED)
            elif kind == 'blob':
                _, sender, key, index, total, digest, chunk = frame
                self._blob_accept(sender, key, index, total, digest, chunk)
            elif kind == 'blob-req':
                _, sender, key = frame
                self._answer_blob_request(sender, key)
            elif kind == 'blob-nak':
                with self._blob_lock:
                    waiter = self._blob_waiters.get(frame[2])
                if waiter is not None and waiter[0] == frame[1]:
                    waiter[1].put(_BLOB_NAK)
            elif kind in ('lost', 'joined'):
                if self.on_control is not None:
                    self.on_control(frame)

    def _failover(self) -> bool:
        """The active hub died: fail in-flight collectives (their delivery
        state is unknowable — see :class:`ControlPlaneFailover`) and switch
        to the next address in the failover list."""
        with self._results_lock:
            self._pending_sends.clear()
            boxes = list(self._results.values())
        for box in boxes:
            box.put(_FAILED_OVER)
        self._fail_blob_waiters()
        if len(self._addresses) == 1:
            return False
        return self._redial((self._active + 1) % len(self._addresses),
                            replay=False)

    def _abandon(self) -> None:
        """Every failover avenue is spent: fail anything waiting (typed —
        callers see ControlPlaneFailover, not a raw timeout) and make
        future sends raise immediately instead of retrying a dead link."""
        self._dead = True
        with self._results_lock:
            self._pending_sends.clear()
            boxes = list(self._results.values())
        for box in boxes:
            box.put(_FAILED_OVER)
        self._fail_blob_waiters()

    def _fail_blob_waiters(self) -> None:
        """Fail in-flight blob fetches typed and fast when the transport
        dies or fails over — the same no-hang-to-timeout discipline the
        collective waiters get (their delivery state is unknowable)."""
        with self._blob_lock:
            waiters = list(self._blob_waiters.values())
        for waiter in waiters:
            waiter[1].put(_BLOB_DEAD)

    def _redial(self, index: int, *, replay: bool,
                connect_timeout: float = 30.0) -> bool:
        self._reconnected.clear()
        try:
            self._sock.close()
        except OSError:
            pass
        if index == self._active:     # redialing the same address: brief
            time.sleep(0.2)           # pause so a dead hub cannot hot-loop
        try:
            sock = self._dial(self._addresses[index],
                              connect_timeout=connect_timeout)
        except OSError:
            return False
        with self._send_lock:
            self._sock = sock
        self._active = index
        self._reconnected.set()
        if replay:
            with self._results_lock:
                pending = list(self._pending_sends.values())
            # in-flight blob requests too: a standby deputy deterministically
            # dropped them, and without a replay the fetch would ride out
            # its full timeout against a healthy primary
            with self._blob_lock:
                pending += [waiter[2] for waiter in self._blob_waiters.values()]
            for frame in pending:
                try:
                    self._send(frame)
                except OSError:
                    return False
        return True

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._closed.wait(interval):
            try:
                self._send(('hb',))
            except OSError:
                continue   # a failover may be in progress; retry next beat

    def _collective(self, kind: str, op: str, value: Any, timeout: float) -> Any:
        # Same call order on every rank => the same per-kind sequence number
        # identifies the same collective everywhere.
        op_key = (kind, op, next(self._counter))
        frame = (kind, op_key, value)
        with self._results_lock:
            box = self._results.setdefault(op_key, queue.Queue())
            self._pending_sends[op_key] = frame
        try:
            self._send(frame, op_key=op_key)
            try:
                result = box.get(timeout=timeout)
            except queue.Empty:
                raise CollectiveTimeout(
                    f'rank {self.rank}: {kind} collective timed out after '
                    f'{timeout:.0f}s — a peer likely died or stalled between '
                    f'sync points; checkpoint-fence and restart, or '
                    f'resynchronize at a safe point') from None
        finally:
            # timeouts and send failures must not leak the box or leave a
            # stale frame eligible for a later redial replay
            with self._results_lock:
                self._results.pop(op_key, None)
                self._pending_sends.pop(op_key, None)
        if result is _FAILED_OVER:
            if self._closed.is_set():
                raise ControlPlaneFailover(
                    f'rank {self.rank}: transport closed while this '
                    f'collective was in flight')
            raise ControlPlaneFailover(
                f'rank {self.rank}: the active hub died while this '
                f'collective was in flight; resynchronize at a safe point '
                f'(collectives after the failover complete on the deputy)')
        if result is _REJECTED:
            raise RuntimeError(
                f'rank {self.rank} is excluded from collectives (it crashed, '
                'timed out, or restarted); re-admission is the restart-resume '
                'cycle — see tpusystem_torch.parallel.recovery')
        return result

    # ------------------------------------------------------------------
    # blob plane: chunked, digest-verified point-to-point byte transfers.
    # The control plane's collectives and events carry small host values;
    # blobs carry the occasional BIG one — a serialized hot TrainState
    # replica shipped between supervisors (tpusystem_torch.parallel.supervisor),
    # or a serving replica's request journal ('journal:{identity}' —
    # tpusystem_torch.serve.failover) that the fleet router pulls back through
    # the buddy chain to re-home a dead replica's rows onto survivors
    # (tpusystem_torch.serve.fleet). Bounded frames (BLOB_CHUNK) keep
    # heartbeats and collective traffic interleaving with a transfer; the
    # whole-blob digest makes any lost, truncated, or
    # reordered-into-oblivion chunk a *detected* failure.

    def send_blob(self, to: int, key: str, data: bytes,
                  chunk_size: int | None = None) -> None:
        """Ship ``data`` to rank ``to`` under ``key`` (fire-and-forget).

        The receiver reassembles and digest-verifies; a corrupt or
        incomplete transfer is discarded there (logged), never delivered —
        best-effort by design: the replication rider keeps its previous
        copy, a fetcher times out and falls back. ``chunk_size`` defaults
        to the transport's ``blob_chunk`` bound.
        """
        chunk_size = chunk_size or self.blob_chunk
        data = bytes(data)
        digest = _blob_digest(data)
        total = max(1, -(-len(data) // chunk_size))
        for index in range(total):
            chunk = data[index * chunk_size:(index + 1) * chunk_size]
            self._send(('blob', to, key, index, total, digest, chunk))

    def fetch_blob(self, peer: int, key: str, timeout: float = 30.0) -> bytes:
        """Request blob ``key`` from rank ``peer`` and wait for it.

        The peer answers from its ``on_blob_request`` hook (or NAKs when
        it has nothing). Raises :class:`BlobError` on NAK, digest
        mismatch, or timeout — callers treat all three as "no hot copy"
        and fall back (for checkpoints: to disk).
        """
        with self._blob_lock:
            ready = self._blob_ready.pop(key, None)
            if ready is not None and ready[0] != peer:
                # a same-key blob someone ELSE pushed is not this answer
                self._blob_ready[key] = ready
                ready = None
            if ready is None:
                if key in self._blob_waiters:
                    # one waiter registration per key: a second concurrent
                    # fetch would clobber the first's (and its finally
                    # would then strand the second) — refuse typed instead
                    raise BlobError(
                        f'rank {self.rank}: a fetch for blob {key!r} is '
                        f'already in flight on this transport')
                box = queue.Queue()
                self._blob_waiters[key] = (peer, box,
                                           ('blob-req', peer, key))
        if ready is not None:
            return ready[1]
        try:
            try:
                self._send(('blob-req', peer, key))
            except OSError as error:
                raise BlobError(
                    f'rank {self.rank}: could not request blob {key!r} '
                    f'from rank {peer}: {error}') from error
            try:
                result = box.get(timeout=timeout)
            except queue.Empty:
                raise BlobError(
                    f'rank {self.rank}: blob {key!r} from rank {peer} did '
                    f'not arrive within {timeout:.0f}s (dropped chunk, dead '
                    f'peer, or nothing to send)') from None
        finally:
            with self._blob_lock:
                self._blob_waiters.pop(key, None)
        if result is _BLOB_NAK:
            raise BlobError(f'rank {peer} has no blob {key!r}')
        if result is _BLOB_CORRUPT:
            raise BlobError(
                f'blob {key!r} from rank {peer} failed its digest check '
                f'(truncated or corrupted chunk)')
        if result is _BLOB_DEAD:
            raise BlobError(
                f'rank {self.rank}: transport closed or failed over while '
                f'fetching blob {key!r}; delivery state unknown')
        return result[1]

    def _answer_blob_request(self, sender: int, key: str) -> None:
        data = None
        if self.on_blob_request is not None:
            try:
                data = self.on_blob_request(key)
            except Exception:
                logger.exception('on_blob_request(%r) failed; NAKing', key)
        try:
            if data is None:
                self._send(('blob-nak', sender, key))
            else:
                self.send_blob(sender, key, data)
        except OSError:
            # best-effort reply: the link (or this transport) died while
            # answering — the requester's own timeout is the fallback
            pass

    def _blob_accept(self, sender: int, key: str, index: int, total: int,
                     digest: str, chunk: bytes) -> None:
        slot = (sender, key, digest)
        now = time.monotonic()
        with self._blob_lock:
            entry = self._blob_parts.setdefault(slot, {'chunks': {},
                                                       'touched': now})
            entry['chunks'][index] = chunk
            entry['touched'] = now
            parts = entry['chunks']
            if len(parts) < total:
                # bound abandoned reassemblies: a transfer whose chunk was
                # dropped in flight never completes, and without eviction
                # each partial (potentially a multi-GB hot TrainState)
                # would hold its bytes forever. Only *stale* slots (no
                # chunk for 120s) are evicted — a big transfer that merely
                # started first is still live — and the sweep runs on
                # every arrival, not past some count: even ONE abandoned
                # partial is a leak worth collecting.
                for stale, held in list(self._blob_parts.items()):
                    if stale != slot and now - held['touched'] > 120.0:
                        del self._blob_parts[stale]
                        logger.warning(
                            'evicted stale blob reassembly %r from '
                            'rank %d', stale[1], stale[0])
                return
            del self._blob_parts[slot]
        data = b''.join(parts[i] for i in sorted(parts))
        if _blob_digest(data) != digest:
            logger.warning('blob %r from rank %d failed its digest check; '
                           'discarded', key, sender)
            self._blob_deliver(key, sender, _BLOB_CORRUPT)
            return
        self._blob_deliver(key, sender, data)

    def _blob_deliver(self, key: str, sender: int, payload: Any) -> None:
        with self._blob_lock:
            waiter = self._blob_waiters.get(key)
            if waiter is not None and waiter[0] != sender:
                waiter = None            # not the peer this fetch asked
            if waiter is None and isinstance(payload, bytes):
                if self.on_blob is None:
                    self._blob_ready[key] = (sender, payload)
                    return
        if waiter is not None:
            marker = payload is _BLOB_NAK or payload is _BLOB_CORRUPT
            waiter[1].put(payload if marker else (sender, payload))
        elif isinstance(payload, bytes) and self.on_blob is not None:
            self.on_blob(sender, key, payload)

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        """Register the receiver for one named event channel."""
        self._channels[channel] = callback

    def send_event(self, channel: str, message: Any) -> None:
        """Fire-and-forget. Delivery is at-most-once across a control-plane
        failover window (no event ack protocol, by design — events are
        observability; collectives are the agreement primitive)."""
        self._send(('event', channel, message))

    def allreduce(self, value: Any, op: str = 'and', timeout: float = 300.0) -> Any:
        return self._collective('reduce', op, value, timeout)

    def gather(self, value: Any, timeout: float = 300.0) -> list:
        return self._collective('gather', 'sum', value, timeout)

    def barrier(self, timeout: float = 300.0) -> None:
        self._collective('reduce', 'and', True, timeout)

    def heartbeat(self) -> None:
        self._send(('hb',))

    def close(self) -> None:
        self._closed.set()
        try:
            self._send(('bye',))
        except OSError:
            pass
        self._sock.close()
        # collectives other threads still have in flight can never
        # complete now — fail them typed (ControlPlaneFailover) instead of
        # leaving them to their full timeout; the recv loop does the same,
        # but it may itself be gone already
        self._abandon()


def connect(address: tuple, world: World,
            heartbeat_interval: float | None = None,
            heartbeat_timeout: float | None = None,
            deputy_address: tuple | None = None) -> tuple[TcpTransport, Hub | None]:
    """Attach this host to the control plane; the primary also hosts the Hub.

    Returns ``(transport, hub)`` — ``hub`` is the primary Hub on rank 0,
    the standby deputy Hub on rank 1 when ``deputy_address`` is given
    (a concrete ``(host, port)`` every rank can compute), else None.
    With a deputy, transports dial ``[address, deputy_address]`` and
    survive primary-hub loss: the deputy promotes when its hub-to-hub
    link to the primary dies, clients fail over, and only collectives
    that were in flight at the instant of the loss fail (with
    :class:`ControlPlaneFailover`).
    """
    hub = None
    if world.is_primary:
        hub = Hub(world.process_count, host=address[0], port=address[1],
                  heartbeat_timeout=heartbeat_timeout)
        address = hub.address
    if deputy_address is not None and world.process_count > 1:
        if world.process_index == 1:
            hub = Hub(world.process_count, host=deputy_address[0],
                      port=deputy_address[1],
                      heartbeat_timeout=heartbeat_timeout,
                      standby_of=tuple(address))
        dial = [tuple(address), tuple(deputy_address)]
    else:
        dial = tuple(address)
    transport = TcpTransport(dial, world.process_index, world.process_count,
                             heartbeat_interval=heartbeat_interval)
    return transport, hub


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

    def __init__(self, transport: Loopback | TcpTransport | None = None):
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

    def __init__(self, transport: Loopback | TcpTransport | None = None):
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


def agree(transport: Loopback | TcpTransport, flag: bool, op: str = 'or') -> bool:
    """Collectively agree a boolean across hosts.

    Early stopping in the reference is an exception unwinding one process
    (``torchsystem/domain/events.py:162-163``); on a pod every host must
    reach the same verdict *before* the next collective or the job
    deadlocks. Default ``op='or'``: any host wanting to stop stops all —
    call at the epoch boundary::

        stop = agree(transport, wants_stop)
        if stop: break
    """
    return bool(transport.allreduce(bool(flag), op=op))
