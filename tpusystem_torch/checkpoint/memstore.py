"""Hot in-memory state that survives a worker's death: the port of
:mod:`tpusystem.checkpoint.memstore`, its in-process part.

Copied from the reference:

* :func:`blob_digest` — the slots' integrity digest, the blob plane's own
  (BLAKE2b-128);
* :class:`HotState`, :func:`pack_hot` and :func:`unpack_hot` — one
  identity's newest slot and its wire form;
* :class:`MemStore` — the slot table: newest state per identity, every
  read digest-verified (a corrupted slot reads as absent, never as state).
  It is also an in-process ``client`` with the ``fetch`` surface, which is
  how the serving replicas' request journals
  (:class:`tpusystem_torch.serve.RequestJournal`) and the router journal
  push to it and recover from it.

Not ported yet: ``ShardedLeaf``, ``merge_hot``, ``serialize_state``,
``deserialize_state`` and ``hot_resume``, which carry a train state (ROADMAP
queue 1, 8. Checkpoint, recovery, guard and Sentinel), and the supervisor's
socket wire, ``MemStoreServer``, ``MemStoreClient`` and
``supervisor_client`` (items 8 and 9. Multi-GPU parallelism).
"""

from __future__ import annotations

import logging
import pickle
import threading
from dataclasses import dataclass
from typing import Any

from tpusystem_torch.parallel.multihost import _blob_digest

logger = logging.getLogger('tpusystem_torch.memstore')

__all__ = ['MemStore', 'HotState', 'blob_digest', 'pack_hot', 'unpack_hot']


def blob_digest(data: bytes) -> str:
    """Integrity digest of a hot-state blob (BLAKE2b-128: fast, keyless —
    this detects corruption, it does not authenticate). The same
    primitive the transport's blob frames use, on purpose: the slot
    digest and the transfer digest must never diverge into two
    incompatible notions of "verified"."""
    return _blob_digest(data)



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
