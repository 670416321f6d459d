"""Async step-versioned checkpointer on a torch store: the port of
:mod:`tpusystem.checkpoint.checkpointer`, without Orbax.

The reference's contract, kept:

* **versioned by step**: one directory per identity, one step directory per
  version (``{root}/{identity}/{step}/``); :meth:`Checkpointer.latest`
  drives the create-or-resume decision;
* **async**: :meth:`Checkpointer.save` snapshots the state and a writer
  thread commits it; a failure of that thread surfaces at the next
  :meth:`~Checkpointer.save`, :meth:`~Checkpointer.newest` or
  :meth:`~Checkpointer.wait`;
* **preemption-safe**: a step directory is written under a temporary name
  and renamed into place after its commit marker, so a kill leaves no
  half-written integer directory; :meth:`~Checkpointer.verify` checks the
  marker and the payload's digest, and ``restore``, ``latest`` and
  ``resume`` fall back over a step that fails (each discard logged);
  :meth:`~Checkpointer.fence` records a monotonic commit fence;
* **extras**: JSON-able host metadata (the loader's cursor) in an
  atomically renamed sidecar, pruned with the steps' GC.

What differs, because the port's state changes in place:

* :meth:`~Checkpointer.save` **snapshots before it returns**: each tensor on
  the card is copied to pinned host memory with ``non_blocking=True`` and
  an event recorded, and the writer waits on that event before it writes.
  The very next step may then overwrite the live tensors; the file holds
  the state as it was at the save.
* a step's payload is one ``torch.save`` of a flat ``{path: tensor}`` dict
  (``state.pt``), then the commit marker (``_CHECKPOINT_METADATA``: the
  payload's BLAKE2b-128 digest and size);
* a restore writes **into the target's own tensors in place** (the same
  device and dtype; a missing or extra leaf, a shape or a dtype that
  differs is refused). A legacy checkpoint without ``health`` restores into
  an unarmed :class:`~tpusystem_torch.train.TrainState`; an armed target
  refuses it (restore unarmed, then arm).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import pathlib
import queue
import shutil
import threading
import time
from typing import Any

import torch

from tpusystem_torch.parallel.sharding import (held_slices, is_distributed,
                                               local, whole_leaf)

logger = logging.getLogger('tpusystem_torch.checkpoint')

__all__ = ['Checkpointer', 'abstract_like', 'flatten_state', 'assign_state']

# sidecar entries under {root}/{identity}; the leading dot keeps them out of
# the integer step scan
_EXTRAS_DIR = '.extras'
_FENCE_FILE = '.fence'
_MARKER = '_CHECKPOINT_METADATA'
_PAYLOAD = 'state.pt'
_TMP = '.tmp'
_DIGEST_CHUNK = 8 << 20


# ---------------------------------------------------------------------------
# the state as a flat {path: leaf} mapping


def _fields(node) -> list | None:
    """``(name, value)`` pairs of a state object (a ``TrainState`` or a
    ``HealthStats``), None for anything else."""
    from tpusystem_torch.train.state import HealthStats, TrainState
    if isinstance(node, TrainState):
        pairs = [('params', node.params), ('opt_state', node.opt_state),
                 ('rng', node.rng), ('step', node.step)]
        if node.health is not None:
            pairs.append(('health', node.health))
        return pairs
    if isinstance(node, HealthStats):
        return list(node.tensors().items())
    return None


def _host_leaf(node) -> bool:
    """A host value stored whole: a threefry key (a tuple of ints) or a
    scalar."""
    if isinstance(node, (tuple, list)):
        return bool(node) and all(isinstance(item, int) for item in node)
    return isinstance(node, (int, float, bool, str)) or node is None


def flatten_state(tree: Any) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` of a state in a fixed order: tensors and host
    values (the threefry key), at ``/``-joined paths (``params/h_0.attn.
    qkv.kernel``, ``opt_state/mu/...``, ``rng``, ``step``, ``health/last``)."""
    out: list[tuple[str, Any]] = []

    def walk(node, path):
        fields = _fields(node)
        if fields is not None:
            for name, value in fields:
                walk(value, path + (name,))
        elif isinstance(node, torch.Tensor) or _host_leaf(node):
            out.append(('/'.join(path), node))
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(value, path + (str(key),))
        elif isinstance(node, (tuple, list)):
            for index, value in enumerate(node):
                walk(value, path + (str(index),))
        else:
            raise TypeError(f'cannot checkpoint a {type(node).__name__} at '
                            f'{"/".join(path) or "the root"}')

    walk(tree, ())
    return out


def abstract_like(tree: Any) -> dict:
    """``{path: (shape, dtype, device)}`` of a state's tensors (host leaves
    map to their type): what a restore into it requires of a checkpoint."""
    return {path: ((tuple(leaf.shape), leaf.dtype, leaf.device)
                   if isinstance(leaf, torch.Tensor) else type(leaf))
            for path, leaf in flatten_state(tree)}


def _check(target: Any, values: dict) -> None:
    """Refuse a restore whose leaves do not match ``target``'s (names,
    shapes, dtypes) before anything is written."""
    paths = abstract_like(target)
    missing = [path for path in paths if path not in values]
    extra = [path for path in values if path not in paths]
    if missing or extra:
        raise ValueError(
            f'checkpoint leaves do not match the restore target: missing '
            f'{missing[:4]}{"..." if len(missing) > 4 else ""}, unexpected '
            f'{extra[:4]}{"..." if len(extra) > 4 else ""}')
    for path, spec in paths.items():
        value = values[path]
        if isinstance(spec, tuple):
            if not isinstance(value, torch.Tensor) or (
                    tuple(value.shape), value.dtype) != spec[:2]:
                got = ((tuple(value.shape), value.dtype)
                       if isinstance(value, torch.Tensor) else type(value))
                raise ValueError(f'checkpoint leaf {path!r} is {got}, the '
                                 f'target wants {spec[:2]}')
        elif isinstance(value, torch.Tensor):
            raise ValueError(f'checkpoint leaf {path!r} is a tensor, the '
                             f'target holds a {spec.__name__}')


@torch.no_grad()
def assign_state(target: Any, values: dict) -> Any:
    """Write ``values`` (``{path: leaf}``) into ``target`` in place: each
    tensor is copied into the target's own tensor (on its device; a placed
    leaf, a ``DTensor``, takes its rank's slice of the whole value), each
    host leaf replaces the target's. Validates everything first (``ValueError``
    on a mismatch, nothing written); returns ``target``."""
    _check(target, values)

    def walk(node, path):
        key = '/'.join(path)
        fields = _fields(node)
        if fields is not None:
            for name, value in fields:
                result = walk(value, path + (name,))
                if result is not value:
                    setattr(node, name, result)
            return node
        if is_distributed(node):        # a placed leaf takes its slice
            local(node).copy_(values[key][held_slices(node)])
            return node
        if isinstance(node, torch.Tensor):
            node.copy_(values[key])
            return node
        if _host_leaf(node):
            value = values[key]
            return tuple(value) if isinstance(node, tuple) else value
        if isinstance(node, dict):
            for name, value in list(node.items()):
                result = walk(value, path + (str(name),))
                if result is not value:
                    node[name] = result
            return node
        items = [walk(value, path + (str(index),))
                 for index, value in enumerate(node)]
        if isinstance(node, list):
            node[:] = items
            return node
        return type(node)(items)

    return walk(target, ())


# ---------------------------------------------------------------------------
# snapshots and the per-identity step store


class _Snapshot:
    """Host copies of a state's leaves, taken when ``save`` is called:
    tensors on the card into pinned memory by ``non_blocking`` copies
    behind one recorded event, CPU tensors cloned. A placed state's leaves
    are gathered whole first, a collective every rank of its mesh joins,
    and only the mesh's first rank (``writes``) keeps host copies."""

    def __init__(self, state: Any) -> None:
        self.values: dict = {}
        self.event = None
        leaves = flatten_state(state)
        placed = next((leaf for _, leaf in leaves if is_distributed(leaf)),
                      None)
        first = (None if placed is None
                 else int(placed.device_mesh.mesh.flatten()[0]))
        self.writes = first is None or torch.distributed.get_rank() == first
        for path, leaf in leaves:
            if is_distributed(leaf):     # gathered whole: a collective
                leaf = whole_leaf(leaf)
            if not self.writes:
                continue
            if not isinstance(leaf, torch.Tensor):
                self.values[path] = leaf
            elif leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                host.copy_(leaf.detach(), non_blocking=True)
                self.values[path] = host
                if self.event is None:
                    self.event = torch.cuda.Event()
            else:
                self.values[path] = leaf.detach().clone()
        if self.event is not None:
            self.event.record()

    @property
    def nbytes(self) -> int:
        return sum(value.numel() * value.element_size()
                   for value in self.values.values()
                   if isinstance(value, torch.Tensor))

    def ready(self) -> dict:
        """The host values, once the copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.values


def _file_digest(path: pathlib.Path) -> str:
    digest = hashlib.blake2b(digest_size=16)
    with open(path, 'rb') as handle:
        while chunk := handle.read(_DIGEST_CHUNK):
            digest.update(chunk)
    return digest.hexdigest()


def _atomic_write(path: pathlib.Path, text: str) -> None:
    """Write-then-rename so readers never see a torn file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    staging = path.with_name(path.name + '.tmp')
    staging.write_text(text)
    os.replace(staging, path)


class _StepStore:
    """One identity's step directories: the seam Orbax's
    ``CheckpointManager`` is in the reference (``save``, ``latest_step``,
    ``delete``, ``check_for_errors``, ``wait_until_finished``, ``close``).
    With ``async_save`` one writer thread commits the queued snapshots in
    order; its first failure is kept for :meth:`check_for_errors`."""

    def __init__(self, home: pathlib.Path, *, max_to_keep: int | None,
                 keep_every: int | None, async_save: bool) -> None:
        self.home = home
        self.max_to_keep = max_to_keep
        self.keep_every = keep_every
        self.async_save = async_save
        self._known: set[int] = set()      # queued or committed steps
        self._error: BaseException | None = None
        self._lock = threading.Lock()      # _known and _error: two threads
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self.timings: list[dict] = []     # per commit: seconds, bytes

    def latest_step(self) -> int | None:
        with self._lock:
            return max(self._known) if self._known else None

    def save(self, step: int, snapshot: _Snapshot) -> None:
        with self._lock:
            if (self.home / str(step)).exists() or step in self._known:
                raise ValueError(f'step {step} already exists under '
                                 f'{self.home}')
            self._known.add(step)
        if not self.async_save:
            try:
                self._commit(step, snapshot)
            except BaseException:
                with self._lock:
                    self._known.discard(step)
                raise
            return
        if self._thread is None:
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()
        self._queue.put((step, snapshot))

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                try:
                    self._commit(*item)
                except Exception as error:      # surfaced at the next call
                    logger.error('async checkpoint commit %s/%d failed: %s',
                                 self.home, item[0], error)
                    with self._lock:
                        self._known.discard(item[0])
                        if self._error is None:
                            self._error = error
            finally:
                self._queue.task_done()

    def _commit(self, step: int, snapshot: _Snapshot) -> None:
        """Payload, then marker, then one rename: the step appears whole or
        not at all."""
        start = time.perf_counter()
        values = snapshot.ready()
        staging = self.home / f'{_TMP}-{step}-{os.getpid()}'
        shutil.rmtree(staging, ignore_errors=True)
        staging.mkdir(parents=True)
        torch.save(values, staging / _PAYLOAD)
        marker = {'step': int(step), 'digest': _file_digest(
            staging / _PAYLOAD), 'bytes': (staging / _PAYLOAD).stat().st_size,
            'leaves': len(values)}
        (staging / _MARKER).write_text(json.dumps(marker))
        os.replace(staging, self.home / str(step))
        self.timings.append({'step': int(step),
                             'seconds': time.perf_counter() - start,
                             'bytes': snapshot.nbytes})
        self._collect()

    def _collect(self) -> None:
        """GC: the newest ``max_to_keep`` steps plus every ``keep_every``-th
        survive."""
        if self.max_to_keep is None:
            return
        steps = sorted(int(entry.name) for entry in self.home.iterdir()
                       if entry.is_dir() and entry.name.isdigit())
        window = set(steps[-self.max_to_keep:]) if self.max_to_keep else set()
        for step in steps:
            if step in window or (self.keep_every
                                  and step % self.keep_every == 0):
                continue
            self.delete(step)

    def delete(self, step: int) -> None:
        with self._lock:
            self._known.discard(step)
        shutil.rmtree(self.home / str(step), ignore_errors=True)

    def check_for_errors(self) -> None:
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise error

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._queue.join()
        self.check_for_errors()

    def close(self) -> None:
        if self._thread is not None:
            self._queue.join()
            self._queue.put(None)
            self._thread.join()
            self._thread = None


# ---------------------------------------------------------------------------
# the checkpointer


class Checkpointer:
    """Identity-keyed, step-versioned state store.

    Layout: ``{root}/{identity}/{step}/`` (``state.pt`` and the commit
    marker) — the identity is the registry hash of the aggregate, so every
    restart computes the same directory.
    """

    def __init__(self, root: str | pathlib.Path, *, max_to_keep: int | None = 3,
                 keep_every: int | None = None,
                 async_save: bool = True, save_retries: int = 2,
                 retry_backoff: float = 0.5, tracer: Any = None) -> None:
        """``max_to_keep`` bounds the rolling window; ``keep_every`` pins
        every Nth step in addition. ``save_retries`` bounds the retries a
        flaky filesystem gets (exponential backoff from ``retry_backoff``
        seconds). ``tracer`` (an :class:`~tpusystem_torch.observe.Tracer`,
        default None = no tracing work) wraps every save and restore in a
        span, so checkpoint cost shows on the same timeline as the
        recoveries it bounds."""
        self.root = pathlib.Path(root).absolute()
        self.max_to_keep = max_to_keep
        self.keep_every = keep_every
        self.async_save = async_save
        self.save_retries = save_retries
        self.retry_backoff = retry_backoff
        self.tracer = tracer
        self._managers: dict[str, _StepStore] = {}
        self._verified: dict[tuple[str, int], tuple] = {}

    def _manager(self, identity: str) -> _StepStore:
        if identity not in self._managers:
            home = self.root / identity
            home.mkdir(parents=True, exist_ok=True)
            self._managers[identity] = _StepStore(
                home, max_to_keep=self.max_to_keep,
                keep_every=self.keep_every, async_save=self.async_save)
        return self._managers[identity]

    def _span(self, name: str, identity: str, epoch: Any):
        """A tracing span around one checkpoint operation (nullcontext
        when tracing is off — the default costs nothing)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat='checkpoint',
                                args={'identity': identity, 'epoch': epoch})

    def save(self, identity: str, epoch: int, state: Any, *,
             extras: Any | None = None) -> None:
        """Snapshot ``state`` under (identity, epoch) and return; the
        commit follows on the writer thread (``async_save``) or before the
        return. ``epoch`` is the version (an epoch index or a global step),
        saved in increasing order. The snapshot is taken before the return,
        so the caller may change the state at once.

        ``extras`` (JSON-able host metadata) is written synchronously to an
        atomically renamed sidecar before the payload. A previous async
        commit that failed raises here; the save itself retries transient
        filesystem errors (``save_retries``, ``retry_backoff``).

        A state placed on a mesh of ranks is saved whole: every rank of the
        mesh calls ``save`` (its leaves are gathered) and the mesh's first
        rank writes; a restore lands each rank's slice of it onto any
        placement."""
        self._surface_async_errors(identity)
        with self._span('checkpoint-save', identity, epoch):
            snapshot = _Snapshot(state)
            if not snapshot.writes:
                return           # the mesh's first rank writes it
            if extras is not None:
                # sidecar BEFORE the payload commit: a kill between the two
                # must not leave a committed step with no cursor
                _atomic_write(self._extras_path(identity, epoch),
                              json.dumps(extras))
            manager = self._manager(identity)
            for attempt in range(self.save_retries + 1):
                try:
                    manager.save(int(epoch), snapshot)
                    break
                except OSError as error:
                    if attempt == self.save_retries:
                        raise
                    delay = self.retry_backoff * (2 ** attempt)
                    logger.warning(
                        'checkpoint save %s/%s/%d failed (%s); retry %d/%d '
                        'in %.1fs', self.root, identity, epoch, error,
                        attempt + 1, self.save_retries, delay)
                    time.sleep(delay)
            self._prune_extras(identity)

    def _surface_async_errors(self, identity: str) -> None:
        """Re-raise a background commit failure at the next call."""
        manager = self._managers.get(identity)
        if manager is not None:
            manager.check_for_errors()

    def _extras_path(self, identity: str, epoch: int) -> pathlib.Path:
        return self.root / identity / _EXTRAS_DIR / f'{int(epoch)}.json'

    def _prune_extras(self, identity: str) -> None:
        """Drop sidecars whose step directory GC already collected (only
        below the newest step on disk: an in-flight save's sidecar must
        survive until its commit lands)."""
        extras_dir = self.root / identity / _EXTRAS_DIR
        if not extras_dir.is_dir():
            return
        on_disk = self._disk_steps(identity)
        if not on_disk:
            return
        live = set(on_disk)
        for sidecar in extras_dir.glob('*.json'):
            if not sidecar.stem.isdigit():
                continue
            step = int(sidecar.stem)
            if step < on_disk[-1] and step not in live:
                sidecar.unlink(missing_ok=True)

    def extras(self, identity: str, epoch: int) -> Any | None:
        """Host-side resume metadata saved with (identity, epoch), or None."""
        path = self._extras_path(identity, epoch)
        if not path.is_file():
            return None
        return json.loads(path.read_text())

    # ------------------------------------------------------------------
    # integrity: verify / committed steps / fence

    def _disk_steps(self, identity: str) -> list[int]:
        """Integer-named step directories on disk, ascending — committed or
        not, read from the filesystem so a fresh process sees what a kill
        left behind."""
        home = self.root / identity
        if not home.is_dir():
            return []
        return sorted(int(entry.name) for entry in home.iterdir()
                      if entry.is_dir() and entry.name.isdigit())

    def verify(self, identity: str, epoch: int) -> bool:
        """Is (identity, epoch) a *committed* checkpoint: its commit marker
        present and its payload's size and digest the marker's? A directory
        failing either (a save torn mid-write, a truncated copy, flipped
        bytes) must be skipped by the resume path. A verified payload is
        not hashed again while its size and mtime stay the same."""
        step_dir = self.root / identity / str(int(epoch))
        marker, payload = step_dir / _MARKER, step_dir / _PAYLOAD
        if not (marker.is_file() and payload.is_file()):
            return False
        try:
            recorded = json.loads(marker.read_text())
            stat = payload.stat()
        except (OSError, ValueError):
            return False
        seen = (stat.st_size, stat.st_mtime_ns, recorded.get('digest'))
        key = (identity, int(epoch))
        if self._verified.get(key) == seen:
            return True
        if stat.st_size != recorded.get('bytes') or \
                _file_digest(payload) != recorded.get('digest'):
            return False
        self._verified[key] = seen
        return True

    def committed(self, identity: str) -> list[int]:
        """Committed (verified) steps for the identity, ascending; torn or
        corrupt step directories are skipped and logged."""
        steps = []
        for step in self._disk_steps(identity):
            if self.verify(identity, step):
                steps.append(step)
            else:
                logger.warning(
                    'checkpoint %s/%s/%d is incomplete or corrupt; skipping',
                    self.root, identity, step)
        return steps

    def fence(self, identity: str) -> int | None:
        """Commit fence: wait for in-flight saves, then record the newest
        committed step in a monotonic fence file (the durability receipt of
        the preemption path); the recorded step never decreases."""
        self.wait()
        steps = self.committed(identity)
        newest = steps[-1] if steps else None
        if newest is None:
            return self.fenced(identity)
        previous = self.fenced(identity)
        if previous is not None and previous > newest:
            return previous
        _atomic_write(self.root / identity / _FENCE_FILE,
                      json.dumps({'step': newest}))
        return newest

    def fenced(self, identity: str) -> int | None:
        """The fenced (guaranteed-durable) step, or None before any fence."""
        path = self.root / identity / _FENCE_FILE
        if not path.is_file():
            return None
        return int(json.loads(path.read_text())['step'])

    # ------------------------------------------------------------------
    # restore

    def restore(self, identity: str, target: Any,
                epoch: int | None = None) -> Any:
        """Restore (identity, epoch or the newest committed step) into
        ``target`` in place and return it.

        An explicit ``epoch`` must exist and verify — else
        :class:`FileNotFoundError` naming the committed epochs. With
        ``epoch=None`` the newest committed step is used, falling back over
        steps whose payload fails to load (each discard logged)."""
        with self._span('checkpoint-restore', identity, epoch):
            if epoch is not None:
                if not self.verify(identity, epoch):
                    available = self.committed(identity)
                    raise FileNotFoundError(
                        f'no committed checkpoint for identity {identity!r} '
                        f'at epoch {epoch} under {self.root} '
                        f'(committed epochs: {available or "none"})')
                return self._restore_step(identity, epoch, target)
            return self._restore_newest(identity, target)[0]

    def _restore_step(self, identity: str, epoch: int, target: Any) -> Any:
        path = self.root / identity / str(int(epoch)) / _PAYLOAD
        values = torch.load(path, map_location='cpu', weights_only=True)
        return assign_state(target, values)

    def _restore_newest(self, identity: str, target: Any) -> tuple[Any, int]:
        """The newest committed step restored, falling back over steps whose
        payload fails to load despite passing :meth:`verify`; the last error
        is re-raised when every step fails (a wrong target fails them all)."""
        candidates = self.committed(identity)
        errors: list[tuple[int, Exception]] = []
        for step in reversed(candidates):
            try:
                return self._restore_step(identity, step, target), step
            except Exception as error:  # torn payload that passed the probe
                errors.append((step, error))
                logger.warning(
                    'restore of %s/%s/%d failed (%s); falling back to the '
                    'previous committed step', self.root, identity, step, error)
        if errors:
            raise errors[-1][1]
        raise FileNotFoundError(
            f'no restorable checkpoint for identity {identity!r} under '
            f'{self.root}')

    def resume(self, identity: str, target: Any) -> tuple[Any, int, Any | None]:
        """One-call resume: ``(state, step, extras)`` from the newest
        committed checkpoint, restored into ``target`` in place."""
        state, step = self._restore_newest(identity, target)
        return state, step, self.extras(identity, step)

    def latest(self, identity: str) -> int | None:
        """Latest *committed* step for the identity, or ``None`` if fresh
        (torn or corrupt steps skipped and logged). To allocate the next
        version use :meth:`newest`."""
        steps = self.committed(identity)
        return steps[-1] if steps else None

    def newest(self, identity: str) -> int | None:
        """Newest *known* step — on disk (committed or torn) or still in
        flight: version allocation only, never resume. Re-raises a
        background commit failure."""
        self._surface_async_errors(identity)
        on_disk = self._disk_steps(identity)
        candidates = [step for step in (on_disk[-1] if on_disk else None,
                                        self._manager(identity).latest_step())
                      if step is not None]
        return max(candidates) if candidates else None

    def discard_after(self, identity: str, step: int) -> list[int]:
        """Drop every step directory newer than ``step`` (the rollback
        epilogue), with their sidecars, after waiting out in-flight saves;
        a fence pointing into the discarded range is lowered to ``step``.
        Returns the discarded step numbers."""
        self.wait()
        dead = [at for at in self._disk_steps(identity) if at > step]
        manager = self._manager(identity)
        for at in dead:
            manager.delete(at)
            self._extras_path(identity, at).unlink(missing_ok=True)
            logger.warning('discarded dead-branch checkpoint %s/%s/%d '
                           '(rollback to %d)', self.root, identity, at, step)
        fenced = self.fenced(identity)
        if fenced is not None and fenced > step:
            _atomic_write(self.root / identity / _FENCE_FILE,
                          json.dumps({'step': int(step)}))
        return dead

    def epochs(self, identity: str) -> list[int]:
        """All retained committed epochs for the identity, ascending."""
        return self.committed(identity)

    def wait(self) -> None:
        """Block until every in-flight async save has committed (re-raises a
        failed commit)."""
        for manager in self._managers.values():
            manager.wait_until_finished()

    def close(self) -> None:
        """Finalize pending saves and stop the writer threads."""
        for manager in self._managers.values():
            manager.close()
        managers, self._managers = self._managers, {}
        for manager in managers.values():
            manager.check_for_errors()

    def __enter__(self) -> 'Checkpointer':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
