"""Hot in-memory checkpoints: state that survives a worker's death. The port
of :mod:`tpusystem.checkpoint.memstore`, one host's pieces.

* :func:`serialize_state` / :func:`deserialize_state` — a train state ⇄ one
  bytes blob of CPU snapshots of its tensors (numpy arrays where numpy has
  the dtype) and its host values (the threefry key). The round trip is bit for bit; a deserialize writes into
  the target's own tensors in place, on their device, and refuses a leaf
  whose count, shape or dtype differs (``ValueError``, nothing written).
* :class:`ShardedLeaf` — a placed leaf's piece keyed by its global slice
  (a plain tensor: one piece, the full slice); pieces of several ranks
  merge (:func:`merge_hot`) and reassemble onto other slice boundaries
  (``place(..., reshard=True)``).
* :class:`MemStore` — the supervisor-side slot table: newest hot state per
  identity, every read digest-verified (a corrupted slot reads as absent,
  never as state). It is also an in-process ``client`` with the ``fetch``
  surface (the serving journals push to it).
* :class:`MemStoreServer` / :class:`MemStoreClient` — the worker ⇄
  supervisor wire: chunked, length-prefixed frames on a local socket whose
  address the worker finds in ``TPUSYSTEM_SUPERVISOR``
  (:func:`supervisor_client`); the client also carries ``mark()``, the
  recovery timeline's breadcrumbs.
* :func:`hot_resume` — the restart decision: the supervisor's RAM (or, with
  a buddy, the peer's copy it pulls) when its step is at least the newest
  committed disk step and its digest verifies, else
  :meth:`~tpusystem_torch.checkpoint.Checkpointer.resume` from disk.

The payload is host bytes only, never device handles, so a blob is valid
across processes: supervisors replicate it to their buddies over the
control plane's blob plane
(:class:`~tpusystem_torch.parallel.multihost.TcpTransport`).
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpusystem_torch.checkpoint.checkpointer import (assign_state,
                                                     flatten_state)
from tpusystem_torch.parallel.multihost import (BLOB_CHUNK, _blob_digest,
                                                _recv_frame, _send_frame)
from tpusystem_torch.parallel.sharding import (held_slices, is_distributed,
                                               local)

logger = logging.getLogger('tpusystem_torch.memstore')

__all__ = ['MemStore', 'MemStoreServer', 'MemStoreClient', 'HotState',
           'ShardedLeaf', 'serialize_state', 'deserialize_state',
           'hot_resume', 'merge_hot', 'supervisor_client', 'SUPERVISOR_ENV',
           'blob_digest', 'pack_hot', 'unpack_hot']

# how a supervised worker finds its supervisor's memstore endpoint
SUPERVISOR_ENV = 'TPUSYSTEM_SUPERVISOR'


def blob_digest(data: bytes) -> str:
    """Integrity digest of a hot-state blob (BLAKE2b-128: fast, keyless —
    this detects corruption, it does not authenticate). The same
    primitive the transport's blob frames use, on purpose: the slot
    digest and the transfer digest must never diverge into two
    incompatible notions of "verified"."""
    return _blob_digest(data)


# ---------------------------------------------------------------------------
# state <-> bytes


def _full_key(shape: tuple) -> tuple:
    """The index key of the whole array: ``(start, stop, step)`` per dim."""
    return tuple((0, dim, 1) for dim in shape)


def _slice_key(slices: tuple) -> tuple:
    """The index key of a piece: ``(start, stop, 1)`` per dim."""
    return tuple((part.start, part.stop, 1) for part in slices)


class ShardedLeaf:
    """Host-local pieces of an array, keyed by their global slice
    (``memstore.py:81``): a placed leaf (a ``DTensor``) carries the piece
    this rank holds, a plain tensor is one piece whose key is the full
    slice. Pieces of one array merge (:meth:`merged`, :func:`merge_hot`)
    and reassemble onto any slice boundaries (:meth:`place`)."""

    def __init__(self, shape: tuple, dtype: torch.dtype, shards: dict) -> None:
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards       # {index key: CPU tensor}

    @classmethod
    def from_tensor(cls, leaf: torch.Tensor) -> 'ShardedLeaf':
        if is_distributed(leaf):
            key = _slice_key(held_slices(leaf))
            host = local(leaf).detach().to('cpu', copy=True)
            return cls(tuple(leaf.shape), leaf.dtype, {key: host})
        host = leaf.detach().to('cpu', copy=True)
        return cls(tuple(leaf.shape), leaf.dtype,
                   {_full_key(tuple(leaf.shape)): host})

    def merged(self, other: 'ShardedLeaf') -> 'ShardedLeaf':
        """Union of this leaf's pieces with another's of the same array
        (overlapping slices keep either copy)."""
        if self.shape != tuple(other.shape) or self.dtype != other.dtype:
            raise ValueError(
                f'cannot merge shards of different arrays: '
                f'{self.shape}/{self.dtype} vs {other.shape}/{other.dtype}')
        return ShardedLeaf(self.shape, self.dtype,
                           {**self.shards, **other.shards})

    def reassemble(self) -> torch.Tensor:
        """The whole array from the held pieces (``ValueError`` when they do
        not tile it)."""
        full = torch.empty(self.shape, dtype=self.dtype)
        covered = torch.zeros(self.shape, dtype=torch.bool)
        for key, data in self.shards.items():
            slices = tuple(slice(start, stop, step)
                           for start, stop, step in key)
            full[slices] = data
            covered[slices] = True
        if not bool(covered.all()):
            raise ValueError(
                f'hot shards cover only {int(covered.sum())} of '
                f'{covered.numel()} elements of a {self.shape} leaf — a '
                f"contributor's pieces are missing; restore from disk")
        return full

    def place(self, leaf: torch.Tensor, reshard: bool = False
              ) -> torch.Tensor:
        """The array laid out as ``leaf`` is, on its device (``ValueError``
        when the shape or dtype differs). A plain tensor target takes the
        reassembled array. A placed target (a ``DTensor``) takes the piece
        held under its rank's slice; when no held piece has that slice
        (the mesh changed), ``reshard=True`` reassembles the whole array
        and cuts the slice from it, else ``ValueError``."""
        if self.shape != tuple(leaf.shape) or self.dtype != leaf.dtype:
            raise ValueError(
                f'hot-state leaf mismatch: blob has {self.shape}/'
                f'{self.dtype}, target wants {tuple(leaf.shape)}/{leaf.dtype}')
        if not is_distributed(leaf):
            return self.reassemble().to(leaf.device)
        from torch.distributed.tensor import DTensor
        slices = held_slices(leaf)
        piece = self.shards.get(_slice_key(slices))
        if piece is None:
            if not reshard:
                raise ValueError(
                    'hot shards do not cover the restore layout (the mesh '
                    'changed since the push); restore from disk')
            piece = self.reassemble()[slices]
        device = local(leaf).device
        with torch.no_grad():
            return DTensor.from_local(
                piece.to(device, copy=True).contiguous(), leaf.device_mesh,
                leaf.placements, run_check=False, shape=leaf.shape,
                stride=leaf.stride())


def serialize_state(state: Any) -> bytes:
    """One bytes blob of the state's leaves (``memstore.py:188``): CPU
    copies of its tensors and its host values, in
    :func:`~tpusystem_torch.checkpoint.checkpointer.flatten_state`'s order.
    Only leaves travel; the structure is the restore target's."""
    leaves = [ShardedLeaf.from_tensor(leaf) if is_distributed(leaf)
              else _host(leaf) if isinstance(leaf, torch.Tensor) else leaf
              for _, leaf in flatten_state(state)]
    return pickle.dumps(leaves, protocol=pickle.HIGHEST_PROTOCOL)


def _host(tensor: torch.Tensor):
    """A CPU copy of ``tensor``: a numpy array where numpy has the dtype
    (it pickles as one buffer), else a CPU tensor (bfloat16)."""
    host = tensor.detach().to('cpu', copy=True)
    return host if host.dtype == torch.bfloat16 else host.numpy()


def deserialize_state(blob: bytes, target: Any) -> Any:
    """Restore :func:`serialize_state` bytes into ``target`` in place, each
    tensor onto its own device, and return it (``memstore.py:210``). A leaf
    count, shape or dtype that differs raises ``ValueError`` before anything
    is written: the caller falls back to disk, nothing is coerced."""
    paths = [path for path, _ in flatten_state(target)]
    values = pickle.loads(blob)
    if len(values) != len(paths):
        raise ValueError(
            f'hot state has {len(values)} leaves but the restore target '
            f"has {len(paths)} — the run's state shape changed since the "
            f'blob was pushed')
    values = [value.reassemble() if isinstance(value, ShardedLeaf)
              else torch.from_numpy(value) if isinstance(value, np.ndarray)
              else value for value in values]
    return assign_state(target, dict(zip(paths, values)))


@dataclass
class HotState:
    """One identity's newest hot checkpoint."""

    step: int
    digest: str
    blob: bytes
    extras: Any | None = None
    source: str = 'local'     # 'local' (own worker) | 'replica' (buddy's)


def pack_hot(entry: HotState) -> bytes:
    """Wire form of a slot for cross-host replication (rides the blob
    plane's ``send_blob``, which adds its own transfer digest)."""
    return pickle.dumps((entry.step, entry.digest, entry.extras, entry.blob),
                        protocol=pickle.HIGHEST_PROTOCOL)


def unpack_hot(data: bytes, source: str = 'replica') -> HotState:
    step, digest, extras, blob = pickle.loads(data)
    return HotState(step=int(step), digest=digest, blob=blob, extras=extras,
                    source=source)


def merge_hot(entries: list[HotState]) -> HotState:
    """Fold several hot blobs of the SAME step into one whose
    :class:`ShardedLeaf` leaves carry the union of every entry's pieces
    (``memstore.py:280``). A mixed-step merge is refused (``ValueError``);
    whole leaves keep the first entry's copy, and so do ``extras``."""
    if not entries:
        raise ValueError('nothing to merge: no hot-state contributions')
    steps = {entry.step for entry in entries}
    if len(steps) > 1:
        raise ValueError(
            f'hot-state contributions disagree on the step ({sorted(steps)});'
            f' a mixed-step merge would stitch two states — restore from '
            f'disk')
    merged_leaves: list | None = None
    for entry in entries:
        leaves = pickle.loads(entry.blob)
        if merged_leaves is None:
            merged_leaves = list(leaves)
            continue
        if len(leaves) != len(merged_leaves):
            raise ValueError(
                f'hot-state contributions disagree on the leaf count '
                f'({len(merged_leaves)} vs {len(leaves)}); restore from disk')
        for index, leaf in enumerate(leaves):
            held = merged_leaves[index]
            if isinstance(held, ShardedLeaf) and isinstance(leaf, ShardedLeaf):
                merged_leaves[index] = held.merged(leaf)
    blob = pickle.dumps(merged_leaves, protocol=pickle.HIGHEST_PROTOCOL)
    first = entries[0]
    return HotState(step=first.step, digest=blob_digest(blob), blob=blob,
                    extras=first.extras, source='merged')


class MemStore:
    """Newest hot state per identity, digest-verified on every read.

    Two namespaces: the ``local`` slots hold what this host's own worker
    pushed; the ``replica`` slots hold a buddy host's cross-replicated
    copies, served when that host is replaced and its fresh supervisor
    pulls over the control plane. A slot whose bytes no longer match
    their digest — an SDC in RAM, a torn replication — reads as *absent*
    (logged), so corruption can only ever cost the hot tier, never
    deliver bad state.

    Also a valid in-process ``client`` (it has the ``fetch`` surface of
    the reference's ``MemStoreClient``), which is how the single-process
    serving drills use it.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: dict[tuple[str, bool], HotState] = {}

    def put(self, identity: str, step: int, blob: bytes, *,
            extras: Any | None = None, digest: str | None = None,
            replica: bool = False) -> HotState:
        """Install a slot (monotonic: an older step never replaces a newer
        one). A caller-supplied ``digest`` is verified before the bytes
        are accepted — a transfer torn upstream is rejected here too."""
        actual = blob_digest(blob)
        if digest is not None and digest != actual:
            raise ValueError(
                f'hot state for {identity!r} step {step} failed its digest '
                f'check on arrival; rejected')
        entry = HotState(step=int(step), digest=actual, blob=bytes(blob),
                         extras=extras,
                         source='replica' if replica else 'local')
        with self._lock:
            held = self._slots.get((identity, replica))
            if held is not None and held.step > entry.step:
                return held
            self._slots[(identity, replica)] = entry
        return entry

    def newest(self, identity: str, *, replica: bool = False) -> HotState | None:
        """The identity's slot, or None — also when the held bytes fail
        their digest (the slot is dropped and logged: corrupt hot state
        must read as absent, never restore)."""
        with self._lock:
            entry = self._slots.get((identity, replica))
        if entry is None:
            return None
        if blob_digest(entry.blob) != entry.digest:
            logger.warning(
                'hot state for %r step %d failed its digest check in the '
                'store; dropping the slot (disk is the fallback)',
                identity, entry.step)
            with self._lock:
                if self._slots.get((identity, replica)) is entry:
                    del self._slots[(identity, replica)]
            return None
        return entry

    # the MemStoreClient-compatible read surface (in-process client)
    def fetch(self, identity: str) -> HotState | None:
        return self.newest(identity)

    def drop(self, identity: str, *, replica: bool = False) -> None:
        with self._lock:
            self._slots.pop((identity, replica), None)

    def identities(self) -> list[str]:
        with self._lock:
            return sorted({name for name, _ in self._slots})


# ---------------------------------------------------------------------------
# worker <-> supervisor wire
#
# Frames (length-prefixed pickles) on a local socket; only the worker
# initiates, so replies cannot interleave:
#   ('put', identity, step, digest, extras, total) + total x ('chunk', i, b)
#       -> ('ok', step) | ('bad', message)
#   ('get', identity)
#       -> ('hot', step, digest, extras, total) + chunks | ('none',)
#   ('mark', stage, info)            fire-and-forget timeline breadcrumb


class MemStoreServer:
    """The supervisor's memstore endpoint (one thread per connection).

    Hooks: ``on_put(identity, entry)`` fires after a verified local push
    (the supervisor's replication rider); ``on_mark(stage, info)`` carries
    the worker's timeline breadcrumbs; ``fetch_fallback(identity)`` is
    consulted when a ``get`` misses locally (the pull-from-buddy path).
    """

    def __init__(self, store: MemStore | None = None,
                 host: str = '127.0.0.1', port: int = 0,
                 on_put: Any = None, on_mark: Any = None,
                 fetch_fallback: Any = None,
                 chunk_size: int = BLOB_CHUNK) -> None:
        self.store = store if store is not None else MemStore()
        self.on_put = on_put
        self.on_mark = on_mark
        self.fetch_fallback = fetch_fallback
        self.chunk_size = chunk_size
        self._server = socket.create_server((host, port))
        self.address = self._server.getsockname()
        self._closed = threading.Event()
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept.start()

    @property
    def env(self) -> dict[str, str]:
        """The environment entry a spawned worker needs to find us."""
        return {SUPERVISOR_ENV: f'{self.address[0]}:{self.address[1]}'}

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.append(sock)
            threading.Thread(target=self._serve, args=(sock,),
                             daemon=True).start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                frame = _recv_frame(sock)
                if frame is None:
                    return
                kind = frame[0]
                if kind == 'put':
                    self._handle_put(sock, frame)
                elif kind == 'get':
                    self._handle_get(sock, frame[1])
                elif kind == 'mark':
                    if self.on_mark is not None:
                        self.on_mark(frame[1], frame[2])
        except OSError:
            pass
        finally:
            sock.close()

    def _handle_put(self, sock: socket.socket, frame: tuple) -> None:
        _, identity, step, digest, extras, total = frame
        parts: list[bytes] = []
        for _ in range(total):
            chunk = _recv_frame(sock)
            if chunk is None or chunk[0] != 'chunk':
                raise OSError('put stream ended mid-transfer')
            parts.append(chunk[2])
        blob = b''.join(parts)
        try:
            entry = self.store.put(identity, step, blob, extras=extras,
                                   digest=digest)
        except ValueError as error:
            logger.warning('rejected hot push for %r step %d: %s',
                           identity, step, error)
            _send_frame(sock, ('bad', str(error)))
            return
        _send_frame(sock, ('ok', entry.step))
        if self.on_put is not None and entry.step == int(step):
            self.on_put(identity, entry)

    def _handle_get(self, sock: socket.socket, identity: str) -> None:
        entry = self.store.newest(identity)
        if entry is None and self.fetch_fallback is not None:
            try:
                entry = self.fetch_fallback(identity)
            except Exception as error:
                logger.warning('hot-state fallback fetch for %r failed: %s',
                               identity, error)
                entry = None
        if entry is None:
            _send_frame(sock, ('none',))
            return
        _send_frame(sock, ('hot', entry.step, entry.digest, entry.extras,
                           max(1, -(-len(entry.blob) // self.chunk_size))))
        for index in range(0, len(entry.blob) or 1, self.chunk_size):
            _send_frame(sock, ('chunk', index // self.chunk_size,
                               entry.blob[index:index + self.chunk_size]))

    def close(self) -> None:
        self._closed.set()
        # shutdown before close on the listener too: a close() alone does
        # not unblock the accept thread on Linux, which then keeps the port
        # bound and a restarted supervisor cannot re-listen at its address
        try:
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._server.close()
        self._accept.join(timeout=5.0)
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for sock in conns:
            # shutdown before close: a serve thread blocked in recv on the
            # same fd would otherwise hold the connection open
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()


class MemStoreClient:
    """The worker's handle on its supervisor's memstore.

    Every method degrades instead of raising on a dead or wedged supervisor
    socket: hot state is an accelerator, never a requirement (``push``
    returns False, ``fetch`` returns None — logged once). On a failure the
    client drops the socket and **redials** on the next call, bounded
    (``redials`` attempts per outage, a fresh budget after any success) and
    backed off (``redial_backoff * 2 ** attempt`` capped at
    ``redial_cap``; calls inside the backoff window degrade, they never
    sleep). Budget exhausted: permanently degraded, logged once."""

    def __init__(self, address: tuple[str, int],
                 chunk_size: int = BLOB_CHUNK, *, redials: int = 8,
                 redial_backoff: float = 0.5, redial_cap: float = 30.0,
                 clock: Any = None) -> None:
        self.address = tuple(address)
        self.chunk_size = chunk_size
        self.redials = redials
        self.redial_backoff = redial_backoff
        self.redial_cap = redial_cap
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._down = False
        self._attempts = 0           # redials consumed this outage
        self._retry_at = 0.0         # earliest next redial (clock units)
        self._sock: socket.socket | None = socket.create_connection(
            self.address, timeout=10.0)
        self._sock.settimeout(None)

    def _lost(self, what: str, error: Any) -> None:
        """Drop the dead socket and arm the redial backoff (``_lock``
        held)."""
        if not self._down:      # log the first failure, not every step
            logger.warning('supervisor unreachable during %s (%s); hot '
                           'state degraded — disk checkpoints still stand, '
                           'redialing with backoff (%d attempts left)',
                           what, error, max(0, self.redials - self._attempts))
        self._down = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        backoff = min(self.redial_cap,
                      self.redial_backoff * 2 ** self._attempts)
        self._retry_at = self._clock() + backoff

    def _ensure(self) -> bool:
        """True when a live socket is available, redialing a restarted
        supervisor when the backoff window has passed and the budget allows
        (``_lock`` held)."""
        if self._sock is not None:
            return True
        if self._attempts >= self.redials:
            return False             # budget spent: permanently degraded
        if self._clock() < self._retry_at:
            return False             # inside the backoff window: degrade
        self._attempts += 1
        try:
            sock = socket.create_connection(self.address, timeout=10.0)
        except OSError as error:
            backoff = min(self.redial_cap,
                          self.redial_backoff * 2 ** self._attempts)
            self._retry_at = self._clock() + backoff
            if self._attempts >= self.redials:
                logger.warning(
                    'supervisor at %r still unreachable after %d redials '
                    '(%s); hot state disabled for the rest of this run',
                    self.address, self._attempts, error)
            return False
        sock.settimeout(None)
        self._sock = sock
        logger.info('supervisor at %r reachable again after %d redial(s); '
                    'hot-state pushes resume', self.address, self._attempts)
        return True

    def push(self, identity: str, step: int, state: Any, *,
             extras: Any | None = None) -> bool:
        """Ship the state's hot blob to the supervisor. True means the
        supervisor holds a digest-verified copy (a synchronous ack); False
        means only disk protects this step."""
        blob = state if isinstance(state, bytes) else serialize_state(state)
        digest = blob_digest(blob)
        total = max(1, -(-len(blob) // self.chunk_size))
        with self._lock:
            if not self._ensure():
                return False
            sock = self._sock
            try:
                _send_frame(sock, ('put', identity, int(step), digest,
                                   extras, total))
                for index in range(total):
                    _send_frame(
                        sock,
                        ('chunk', index,
                         blob[index * self.chunk_size:
                              (index + 1) * self.chunk_size]))
                reply = _recv_frame(sock)
            except OSError as error:
                self._lost(f'push of {identity!r} step {step}', error)
                return False
            if reply is None:
                self._lost(f'push of {identity!r} step {step}',
                           'connection closed')
                return False
            if reply[0] != 'ok':     # the store refused (e.g. digest): the
                # socket is healthy — a rejection is not an outage
                logger.warning('hot push of %r step %d rejected: %s',
                               identity, step, reply[1])
                return False
            self._down = False
            self._attempts = 0       # a success refills the redial budget
        return True

    def fetch(self, identity: str) -> HotState | None:
        """The supervisor's newest hot state for the identity, or None
        (missing, digest failed, or the supervisor is unreachable)."""
        with self._lock:
            if not self._ensure():
                return None
            sock = self._sock
            try:
                _send_frame(sock, ('get', identity))
                reply = _recv_frame(sock)
                if reply is None:
                    self._lost(f'fetch of {identity!r}',
                               'connection closed')
                    return None
                if reply[0] == 'none':
                    self._down = False
                    self._attempts = 0
                    return None
                _, step, digest, extras, total = reply
                parts = []
                for _ in range(total):
                    chunk = _recv_frame(sock)
                    if chunk is None:
                        self._lost(f'fetch of {identity!r}',
                                   'stream ended mid-transfer')
                        return None
                    parts.append(chunk[2])
            except OSError as error:
                self._lost(f'fetch of {identity!r}', error)
                return None
            self._down = False
            self._attempts = 0
        blob = b''.join(parts)
        if blob_digest(blob) != digest:
            logger.warning('fetched hot state for %r step %d failed its '
                           'digest check; treating as absent', identity, step)
            return None
        return HotState(step=int(step), digest=digest, blob=blob,
                        extras=extras)

    def mark(self, stage: str, **info: Any) -> None:
        """Timeline breadcrumb (``restore``, ``first-step``, ``fence``),
        fire-and-forget: the supervisor stamps its arrival time."""
        with self._lock:
            if not self._ensure():
                return
            try:
                _send_frame(self._sock, ('mark', stage, dict(info)))
            except (OSError, AttributeError) as error:
                # a dying supervisor must not take the worker with it
                self._lost(f'mark {stage!r}', error)

    def close(self) -> None:
        # lock-free on purpose: a call blocked in recv on a hung supervisor
        # holds the lock, and close() must force the socket shut under it;
        # spending the redial budget first keeps a racing redial away
        self._attempts = self.redials
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def supervisor_client(env: dict | None = None) -> MemStoreClient | None:
    """The worker-side entry: connect to the supervisor named by
    ``TPUSYSTEM_SUPERVISOR`` (host:port), or None when unsupervised or
    unreachable (the worker trains on; disk still checkpoints)."""
    spec = (env if env is not None else os.environ).get(SUPERVISOR_ENV)
    if not spec:
        return None
    host, _, port = spec.rpartition(':')
    try:
        return MemStoreClient((host, int(port)))
    except (OSError, ValueError) as error:
        logger.warning('supervisor at %r unreachable (%s); hot state '
                       'disabled for this run', spec, error)
        return None


# ---------------------------------------------------------------------------
# the restart decision


def hot_resume(checkpointer: Any, identity: str, target: Any,
               client: Any = None) -> tuple[Any, int, Any | None, str]:
    """Resume preferring hot state over disk: ``(state, step, extras,
    source)``, ``source`` ``'hot'`` or ``'disk'`` (``memstore.py:754``).

    RAM wins only when it cannot lose information or integrity: its step
    must be **at least** the newest committed disk step (a stale slot must
    not rewind training), its digest must verify (every fetch surface
    checks it) and its leaves must match the target's; anything else logs
    and falls back to :meth:`Checkpointer.resume`. Both paths write the
    same bytes into the target's tensors, so a hot restore equals the disk
    restore of the same step bit for bit. A ``client`` with ``mark``
    stamps the decision into the recovery timeline (``restore``).
    """
    hot = client.fetch(identity) if client is not None else None
    if hot is not None:
        disk_step = checkpointer.latest(identity)
        if disk_step is not None and hot.step < disk_step:
            logger.warning(
                'hot state for %r is stale (step %d < committed disk step '
                '%d); restoring from disk', identity, hot.step, disk_step)
            hot = None
    result = None
    if hot is not None:
        try:
            state = deserialize_state(hot.blob, target)
            result = (state, hot.step, hot.extras, 'hot')
        except (ValueError, pickle.UnpicklingError) as error:
            logger.warning('hot state for %r step %d failed to restore '
                           '(%s); falling back to disk', identity, hot.step,
                           error)
    if result is None:
        state, step, extras = checkpointer.resume(identity, target)
        result = (state, step, extras, 'disk')
    mark = getattr(client, 'mark', None)
    if mark is not None:
        mark('restore', source=result[3], step=result[1])
    return result
