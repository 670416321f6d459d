"""Supervising launcher: the restart contract, enforced by a process. The
port of :mod:`tpusystem.parallel.supervisor`, copied.

* **spawn + verdict** — the worker runs as a subprocess; its exit code is
  mapped per the contract (:mod:`tpusystem_torch.parallel.recovery`):
  :data:`~tpusystem_torch.parallel.recovery.RESTART_EXITS` (42, 43, 46)
  and signal deaths (a SIGKILLed worker *is* the worker-lost case) relaunch
  with capped exponential backoff and seeded jitter; 44 (diverged) and
  every unknown code halt for triage, and so do SIGINT/SIGQUIT deaths
  (operator intent).
* **crash-loop containment** — ``crash_loop_k`` consecutive restartable
  exits, each within ``crash_loop_window`` seconds of the worker's
  first-step mark (or of launch), end the loop with
  :data:`~tpusystem_torch.parallel.recovery.CRASH_LOOP_EXIT` (45).
* **clean preemption** — :meth:`Supervisor.terminate` (or the installed
  SIGTERM handler) forwards SIGTERM to the worker and waits ``grace``
  seconds before SIGKILL; the supervisor then exits with the worker's code.
* **hot state** — the supervisor owns a
  :class:`~tpusystem_torch.checkpoint.MemStore` served to the worker over a
  local socket (``TPUSYSTEM_SUPERVISOR``), so a relaunched worker restores
  from the supervisor's RAM (:func:`~tpusystem_torch.checkpoint.hot_resume`).
  With ``transport=`` and ``buddy=`` each verified push is cross-replicated
  over the supervisor pod's control plane (a
  :class:`~tpusystem_torch.parallel.multihost.TcpTransport`, or any
  transport with the blob plane ``send_blob``/``fetch_blob``), and a
  replaced host's fresh supervisor pulls its state back from the buddy.
* **recovery timeline** — every exit, relaunch and detect→first-step
  recovery is a domain event (``WorkerExited``, ``WorkerRelaunched``,
  ``RecoveryTimeline``) on the supervisor's producer.

The loop is injectable (``popen``/``clock``/``sleep``), so backoff and
crash-loop policy are tested without subprocesses or real sleeps.
``tracer=`` (an :class:`~tpusystem_torch.observe.Tracer`) turns every
recovery into a parent span with one child per stage; ``flight_path=``
exports ``TPUSYSTEM_FLIGHT`` to the worker
(:meth:`~tpusystem_torch.observe.FlightRecorder.from_env`) and attaches its
post-mortem, read back after every exit, to ``WorkerExited.postmortem``.

Typical launcher ``main()``::

    supervisor = Supervisor([sys.executable, 'train.py'], producer=bus)
    supervisor.install_signal_handler()     # SIGTERM -> forward + grace
    raise SystemExit(supervisor.run())
"""

from __future__ import annotations

import collections
import logging
import os
import random
import signal as signal_module
import subprocess
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

from tpusystem_torch.parallel.multihost import BlobError
from tpusystem_torch.parallel.recovery import (CRASH_LOOP_EXIT, DIVERGED_EXIT,
                                               FAILURE_EXIT, PREEMPTED_EXIT,
                                               RESIZED_EXIT, RESTART_EXITS,
                                               ROUTER_FENCED_EXIT)

if TYPE_CHECKING:  # deferred at runtime: the checkpoint package need not
    # tax `import tpusystem_torch.parallel` — the hot tier loads on first
    # Supervisor(...)
    from tpusystem_torch.checkpoint.memstore import MemStore, MemStoreServer

logger = logging.getLogger('tpusystem_torch.supervisor')

__all__ = ['Supervisor']

_CODE_NAMES = {0: 'completed', FAILURE_EXIT: 'failure', 42: 'worker-lost',
               43: 'preempted', 44: 'diverged', CRASH_LOOP_EXIT: 'crash-loop',
               RESIZED_EXIT: 'resized', ROUTER_FENCED_EXIT: 'router-fenced'}

# signal deaths relaunch (a SIGKILLed worker IS the worker-lost case) —
# EXCEPT these: SIGINT (^C) and SIGQUIT (^\) are *operator intent*, a
# human asking this worker to stop. Relaunching would fight the operator
# forever; halt for triage like exit 1.
_HALT_SIGNALS = frozenset({signal_module.SIGINT, signal_module.SIGQUIT})

_UNSET = object()


def _describe(code: int) -> str:
    if code < 0:
        try:
            return f'signal {signal_module.Signals(-code).name}'
        except ValueError:
            return f'signal {-code}'
    return _CODE_NAMES.get(code, f'exit {code}')


class Supervisor:
    """Seconds-scale recovery control loop around one worker process.

    Args:
        argv: the worker command line (relaunched verbatim).
        rank: this host's rank — carried in events and used to pair with
            ``buddy`` for replication.
        memstore: ``True`` (default) serves a fresh
            :class:`~tpusystem_torch.checkpoint.memstore.MemStore` to the
            worker; pass an existing store to share one, or ``False`` to
            disable the hot tier entirely (workers then restore from
            disk — the drill for the fallback path).
        transport: optional control-plane client
            (a transport with the blob plane) of the
            *supervisor* pod — the channel hot state is cross-replicated
            over. Independent of the workers' control plane: it must
            survive worker death.
        buddy: peer rank this supervisor mirrors its hot state to (and
            pulls from when its own store is empty — the replaced-host
            path). Pairing is 1:1 by convention (e.g. ``rank ^ 1``).
        producer: event bus the supervisor narrates on (``dispatch`` is
            called on the supervising thread only).
        env: extra environment entries for the worker (on top of
            ``os.environ`` and the memstore address).
        backoff_base / backoff_cap / backoff_jitter / seed: relaunch
            backoff ``min(cap, base * 2**attempt)`` scaled by
            ``1 + jitter * U[0, 1)`` from a seeded RNG — capped
            exponential with deterministic jitter, reset by a productive
            run.
        crash_loop_k / crash_loop_window: give up (exit
            :data:`~tpusystem_torch.parallel.recovery.CRASH_LOOP_EXIT`) after
            ``k`` consecutive restartable exits each within ``window``
            seconds of first-step (or launch).
        max_restarts: optional hard cap on total relaunches (``None`` =
            bounded by the crash-loop detector only).
        grace: seconds between forwarding SIGTERM and escalating to
            SIGKILL.
        popen / clock / sleep / poll_interval: injection seams — tests
            drive the whole policy with a fake clock and fake processes,
            no real sleeps in tier-1.
    """

    def __init__(self, argv: list[str], *, rank: int = 0,
                 memstore: MemStore | bool = True,
                 transport: Any = None, buddy: int | None = None,
                 producer: Any = None, tracer: Any = None,
                 flight_path: str | None = None,
                 env: dict[str, str] | None = None,
                 backoff_base: float = 1.0, backoff_cap: float = 30.0,
                 backoff_jitter: float = 0.25, seed: int = 0,
                 crash_loop_k: int = 3, crash_loop_window: float = 30.0,
                 max_restarts: int | None = None, grace: float = 15.0,
                 popen: Callable[..., Any] = subprocess.Popen,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 poll_interval: float = 0.05) -> None:
        self.argv = list(argv)
        self.rank = rank
        self.transport = transport
        self.buddy = buddy
        self.producer = producer
        # observe.Tracer | None: every detect→first-step recovery becomes
        # a parent span with one child span per stage transition — the
        # span form of RecoveryTimeline, on the same clock
        self.tracer = tracer
        # where the worker's flight recorder writes (exported to it as
        # TPUSYSTEM_FLIGHT); after every exit the supervisor reads the
        # post-mortem back and attaches it to WorkerExited
        self.flight_path = flight_path
        self.env = dict(env or {})
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_jitter = backoff_jitter
        self.crash_loop_k = crash_loop_k
        self.crash_loop_window = crash_loop_window
        self.max_restarts = max_restarts
        self.grace = grace
        self._popen = popen
        self._clock = clock
        self._sleep = sleep
        self._poll_interval = poll_interval
        self._rng = random.Random(seed)
        self._terminate = threading.Event()
        self._resize = threading.Event()
        self._resize_lock = threading.Lock()
        self._resize_env: dict[str, str] = {}
        self._resize_buddy: Any = _UNSET
        self._repl_lock = threading.Lock()
        self._repl_pending: dict[str, Any] = {}
        self._repl_wake = threading.Event()
        self._repl_stop = threading.Event()
        self._repl_thread: threading.Thread | None = None
        self._marks: collections.deque = collections.deque()
        self._timeline: dict[str, float] | None = None
        self._restore_info: dict | None = None
        self._first_step_at: float | None = None
        self.restarts = 0
        self.timelines: list[Any] = []    # emitted RecoveryTimeline events
        self.store: MemStore | None = None
        self.server: MemStoreServer | None = None
        if memstore:
            from tpusystem_torch.checkpoint.memstore import MemStore, MemStoreServer
            self.store = (memstore if isinstance(memstore, MemStore)
                          else MemStore())
            self.server = MemStoreServer(
                self.store, on_put=self._replicate, on_mark=self._on_mark,
                fetch_fallback=self._pull_from_buddy)
        if transport is not None:
            transport.on_blob = self._accept_replica
            transport.on_blob_request = self._serve_replica

    # ------------------------------------------------------------------
    # hot-state replication (buddy pair over the control plane)

    # key discipline: pushes travel as 'replica:{identity}' and pulls ask
    # for 'hot:{identity}' — distinct keys, so a replaced host's pull can
    # never be satisfied by the buddy's own concurrent push of ITS state
    # (fetch_blob additionally pins the sender, but the key split keeps
    # the two flows unmistakable on the wire). 'own:{identity}' asks for
    # the peer's OWN local slot — the elastic reshard's survivor fetch
    # (tpusystem.parallel.elastic.collect_pieces), again key-distinct.
    # The serving engine's request journal rides this machinery unchanged
    # under the identity namespace 'journal:{identity}'
    # (tpusystem.serve.failover): its pushes replicate to the buddy and a
    # replaced host's fetch pulls it back exactly like hot training state
    # — the identity prefix keeps journal slots from ever colliding with
    # the same run's TrainState slots. The fleet router's failover
    # (tpusystem.serve.fleet) is a THIRD reader of the same keys: when a
    # serving replica dies for good, the router's recovery chain asks
    # the dead host's supervisor RAM first and then the buddy for
    # 'hot:journal:{identity}' — a DIFFERENT surviving replica then
    # adopts the rows, so no new key kind and no new wire flow is needed
    # for fleet-level handoff.

    def _replicate(self, identity: str, entry: Any) -> None:
        """Queue a verified push for cross-host replication.

        Runs on the memstore serve thread — the transfer itself must NOT:
        the worker's next ``push`` ack waits behind this thread, and a
        slow buddy link would inject the whole cross-host transfer into
        the training loop. A background worker drains the queue, and
        entries coalesce per identity (only the newest matters)."""
        if self.transport is None or self.buddy is None:
            return
        with self._repl_lock:
            self._repl_pending[identity] = entry
            if self._repl_thread is None:
                self._repl_thread = threading.Thread(
                    target=self._replication_loop, daemon=True)
                self._repl_thread.start()
        self._repl_wake.set()

    def _replication_loop(self) -> None:
        from tpusystem_torch.checkpoint.memstore import pack_hot
        while not self._repl_stop.is_set():
            self._repl_wake.wait()
            self._repl_wake.clear()
            while True:
                with self._repl_lock:
                    if not self._repl_pending:
                        break
                    identity, entry = self._repl_pending.popitem()
                try:
                    self.transport.send_blob(self.buddy,
                                             f'replica:{identity}',
                                             pack_hot(entry))
                except OSError as error:
                    logger.warning('hot-state replication to buddy %d '
                                   'failed (%s); local copy and disk still '
                                   'stand', self.buddy, error)

    def _accept_replica(self, sender: int, key: str, data: bytes) -> None:
        if not key.startswith('replica:') or self.store is None:
            return
        from tpusystem_torch.checkpoint.memstore import unpack_hot
        identity = key[len('replica:'):]
        try:
            entry = unpack_hot(data)
            self.store.put(identity, entry.step, entry.blob,
                           extras=entry.extras, digest=entry.digest,
                           replica=True)
        except Exception as error:        # torn replica: keep the old copy
            logger.warning('replica of %r from rank %d rejected (%s)',
                           identity, sender, error)

    @staticmethod
    def _strip_member(rest: str) -> str:
        # elastic fetch keys may carry a member-rank segment
        # ('own:{member}:{identity}') purely to keep concurrent fetches
        # of DIFFERENT peers' pieces key-distinct on the fetching
        # transport (fetch_blob allows one in-flight fetch per key); the
        # serving side answers from its own slots either way
        prefix, sep, remainder = rest.partition(':')
        return remainder if sep and prefix.isdigit() else rest

    def _serve_replica(self, key: str) -> bytes | None:
        if self.store is None:
            return None
        from tpusystem_torch.checkpoint.memstore import pack_hot
        if key.startswith('hot:'):
            entry = self.store.newest(self._strip_member(key[4:]),
                                      replica=True)
        elif key.startswith('own:'):
            entry = self.store.newest(self._strip_member(key[4:]))
        else:
            return None
        return None if entry is None else pack_hot(entry)

    def _pull_from_buddy(self, identity: str) -> Any:
        """A local ``get`` missed (fresh supervisor on a replaced host):
        pull this identity's hot state back from the buddy's replica slot
        and cache it locally."""
        if self.transport is None or self.buddy is None:
            return None
        from tpusystem_torch.checkpoint.memstore import unpack_hot
        try:
            data = self.transport.fetch_blob(self.buddy, f'hot:{identity}',
                                             timeout=10.0)
        except BlobError as error:
            logger.warning('buddy %d has no usable hot state for %r (%s); '
                           'disk is the fallback', self.buddy, identity, error)
            return None
        entry = unpack_hot(data)
        return self.store.put(identity, entry.step, entry.blob,
                              extras=entry.extras, digest=entry.digest)

    # ------------------------------------------------------------------
    # timeline plumbing (marks arrive on server threads; everything else
    # runs on the supervising thread)

    def _on_mark(self, stage: str, info: dict) -> None:
        self._marks.append((stage, dict(info or {}), self._clock()))

    def _drain_marks(self) -> None:
        while self._marks:
            stage, info, at = self._marks.popleft()
            if stage == 'first-step':
                self._first_step_at = at
            if stage == 'restore':
                self._restore_info = info
            if self._timeline is not None:
                self._timeline.setdefault(stage, at)
                if stage == 'first-step':
                    self._emit_timeline()

    def _emit_timeline(self) -> None:
        timeline, self._timeline = self._timeline, None
        detect = timeline.pop('detect')
        stages = {stage: at - detect for stage, at in timeline.items()}
        if self.tracer is not None and timeline:
            restored = self._restore_info or {}
            done = max(timeline.values())
            root = self.tracer.record(
                f'recovery rank{self.rank}', detect, done, cat='recovery',
                args={'rank': self.rank, 'source': restored.get('source'),
                      'step': restored.get('step')})
            previous = ('detect', detect)
            for stage, at in sorted(timeline.items(), key=lambda kv: kv[1]):
                self.tracer.record(f'{previous[0]}→{stage}',
                                   previous[1], at, cat='recovery',
                                   trace=root.context)
                previous = (stage, at)
        restore = self._restore_info or {}
        seconds = stages.get('first-step', 0.0)
        logger.info('recovery complete on rank %d: %.3fs detect->first-step '
                    '(source=%s, stages=%s)', self.rank, seconds,
                    restore.get('source'), {k: round(v, 3)
                                            for k, v in stages.items()})
        from tpusystem_torch.observe.events import RecoveryTimeline
        event = RecoveryTimeline(rank=self.rank,
                                 step=restore.get('step'),
                                 source=restore.get('source'),
                                 seconds=seconds, stages=stages)
        self.timelines.append(event)
        self._dispatch(event)

    def _dispatch(self, event: Any) -> None:
        if self.producer is not None:
            self.producer.dispatch(event)

    def _postmortem(self) -> Any:
        """The worker's flight-recorder dump, read back after an exit —
        'what the worker saw' attached to the verdict about it. None
        when recording is off or the worker died before its first
        dump (the recorder's write-ahead cadence bounds that window)."""
        if self.flight_path is None:
            return None
        from tpusystem_torch.observe.flight import FlightRecorder
        return FlightRecorder.read(self.flight_path)

    def _worker_exited(self, code: int, action: str, uptime: float,
                       reason: str | None) -> None:
        from tpusystem_torch.observe.events import WorkerExited
        self._dispatch(WorkerExited(rank=self.rank, code=code, action=action,
                                    uptime=uptime, reason=reason,
                                    postmortem=self._postmortem()))

    # ------------------------------------------------------------------
    # the control loop

    def terminate(self) -> None:
        """Begin the preemption drain: forward SIGTERM to the worker, give
        it ``grace`` seconds to unwind (fence + exit 43), then SIGKILL.
        Safe from a signal handler or another thread."""
        self._terminate.set()

    def resize(self, env: dict[str, str] | None = None, *,
               buddy: int | None | object = _UNSET) -> None:
        """Restart the worker under a NEW world spec (the elastic commit
        hook — :class:`tpusystem.parallel.elastic.ElasticCoordinator`'s
        ``on_resize`` side).

        Unlike :meth:`terminate` this is not an eviction: the worker is
        SIGTERMed (same grace → SIGKILL ladder) so it drains and exits,
        and the supervisor relaunches it *immediately* — no backoff, no
        crash-loop accounting — with ``env`` merged into its environment
        (typically :meth:`~tpusystem.parallel.elastic.ResizeDecision.env`)
        and, when given, ``buddy`` re-pointed at the new pairing so hot
        replication resumes against the new rank set. Safe from another
        thread (the coordinator's poll thread calls it).
        """
        with self._resize_lock:
            if env:
                self._resize_env = {**self._resize_env, **env}
            if buddy is not _UNSET:
                self._resize_buddy = buddy
            self._resize.set()

    def _apply_resize(self) -> None:
        """Fold the pending resize spec into the relaunch environment and
        buddy pairing, clearing the request. The lock keeps a SECOND
        resize() (the coordinator's next epoch, on its own thread) from
        losing its spec between this method's read and reset."""
        with self._resize_lock:
            self._resize.clear()
            if self._resize_env:
                self.env.update(self._resize_env)
                self._resize_env = {}
            if self._resize_buddy is not _UNSET:
                self.buddy = self._resize_buddy
                self._resize_buddy = _UNSET

    def install_signal_handler(self, *signals: int) -> None:
        """Arm :meth:`terminate` on the given signals (default SIGTERM).
        Main thread only — same Python constraint as
        ``Runtime.install_preemption_handler``."""
        for signum in signals or (signal_module.SIGTERM,):
            signal_module.signal(signum, lambda *_: self.terminate())

    def run(self) -> int:
        """Supervise until the contract says stop; returns the exit code
        the *supervisor* should end with."""
        try:
            return self._supervise()
        finally:
            self.close()

    def _supervise(self) -> int:
        from tpusystem_torch.observe.events import WorkerRelaunched
        attempt = 0          # backoff ladder position (reset by progress)
        rapid = 0            # consecutive crash-loop samples
        while True:
            if self._terminate.is_set():
                # eviction arrived during the backoff sleep: relaunching
                # now would spawn a worker only to SIGTERM it (likely
                # before its preemption handler is even installed) — the
                # last worker already drained/checkpointed, so report the
                # preemption itself
                logger.info('rank %d: termination requested before '
                            'relaunch; exiting %d', self.rank,
                            PREEMPTED_EXIT)
                return PREEMPTED_EXIT
            if self._resize.is_set():
                # the resize committed while no worker was running (a
                # backoff sleep, or between exit and relaunch): fold the
                # new spec in BEFORE launching — spawning under the stale
                # world just to SIGTERM it would waste a whole worker
                # start and dial the control plane at the old size
                self._apply_resize()
            env = {**os.environ, **self.env}
            if self.server is not None:
                env.update(self.server.env)
            if self.flight_path is not None:
                from tpusystem_torch.observe.flight import ENV_FLIGHT
                env[ENV_FLIGHT] = str(self.flight_path)
                # clear the previous worker's post-mortem before launch: a
                # worker that dies before its FIRST dump must attach None,
                # not its predecessor's final ticks
                try:
                    os.unlink(self.flight_path)
                except OSError:
                    pass
            self._first_step_at = None
            self._restore_info = None
            launched = self._clock()
            if self._timeline is not None:
                self._timeline.setdefault('relaunch', launched)
            worker = self._popen(self.argv, env=env)
            logger.info('rank %d: launched worker pid %s', self.rank,
                        getattr(worker, 'pid', '?'))
            code = self._wait(worker)
            self._drain_marks()
            uptime = self._clock() - launched
            reason = _describe(code)

            if self._terminate.is_set():
                # our own eviction: the worker drained (or was killed after
                # the grace); pass its verdict through, never relaunch. A
                # signal death has no pass-through-able code — raising
                # SystemExit(-9) would surface as a meaningless 128+ shell
                # status — so it maps to the preemption code: the eviction
                # is the truth of what happened.
                if code < 0:
                    logger.warning(
                        'rank %d: worker died to %s without draining; '
                        'reporting the eviction as exit %d', self.rank,
                        reason, PREEMPTED_EXIT)
                    code = PREEMPTED_EXIT
                self._worker_exited(code, 'drain', uptime, reason)
                logger.info('rank %d: preemption drain done (%s)', self.rank,
                            reason)
                return code
            if code == 0:
                self._worker_exited(0, 'done', uptime, reason)
                return 0
            if self._resize.is_set() and (
                    code in RESTART_EXITS
                    or (code < 0 and -code not in _HALT_SIGNALS)):
                # a requested elastic resize: the exit (43 from our own
                # SIGTERM, 46 from the worker's drain, or a signal death
                # after the grace) is the handshake, not a fault — apply
                # the new world spec and relaunch NOW, outside the
                # backoff ladder and the crash-loop accounting. An
                # operator's SIGINT/SIGQUIT still halts below: a pending
                # resize does not outrank the human holding ^C.
                self._apply_resize()
                self._timeline = {'detect': self._clock()}
                self.restarts += 1
                self._worker_exited(code, 'resize', uptime, reason)
                logger.info('rank %d: worker exited %s for a world resize; '
                            'relaunching under the new spec', self.rank,
                            reason)
                continue
            restartable = code in RESTART_EXITS or (
                code < 0 and -code not in _HALT_SIGNALS)
            if not restartable:
                action = 'halt'
                self._worker_exited(code, action, uptime, reason)
                logger.error(
                    'rank %d: worker exited %d (%s) — not a restart code; '
                    'halting for triage%s', self.rank, code, reason,
                    ' (divergence: a blind relaunch would replay it)'
                    if code == DIVERGED_EXIT else
                    ' (operator signal: relaunching would fight the human)'
                    if code < 0 else '')
                # a signal death has no pass-through-able positive code
                # (SystemExit(-2) surfaces as a meaningless shell status):
                # operator-intent signals halt like the generic failure
                return code if code >= 0 else FAILURE_EXIT

            # crash-loop containment: a restartable exit within the window
            # of first-step (or of launch, if it never got that far) made
            # no progress; K of those in a row and relaunching is futile
            anchor = self._first_step_at or launched
            productive = (self._clock() - anchor) >= self.crash_loop_window
            rapid = 0 if productive else rapid + 1
            if productive:
                attempt = 0
            if rapid >= self.crash_loop_k or (
                    self.max_restarts is not None
                    and self.restarts >= self.max_restarts):
                self._worker_exited(code, 'crash-loop', uptime, reason)
                logger.error(
                    'rank %d: crash loop — %d consecutive restartable exits '
                    'within %.0fs of first-step; giving up with exit %d',
                    self.rank, rapid, self.crash_loop_window, CRASH_LOOP_EXIT)
                return CRASH_LOOP_EXIT

            self._timeline = {'detect': self._clock()}
            self._worker_exited(code, 'relaunch', uptime, reason)
            backoff = min(self.backoff_cap, self.backoff_base * 2 ** attempt)
            backoff *= 1.0 + self.backoff_jitter * self._rng.random()
            attempt += 1
            self.restarts += 1
            logger.warning(
                'rank %d: worker lost (%s) after %.1fs; relaunch #%d in '
                '%.2fs', self.rank, reason, uptime, self.restarts, backoff)
            self._dispatch(WorkerRelaunched(rank=self.rank, attempt=attempt,
                                            restarts=self.restarts,
                                            backoff=backoff))
            self._sleep(backoff)

    def _wait(self, worker: Any) -> int:
        """Poll the worker to completion, draining timeline marks and
        reacting to :meth:`terminate` (SIGTERM forward → grace → SIGKILL).
        Polling — not ``wait()`` — so a signal arriving between frames is
        honored within ``poll_interval``."""
        term_sent_at: float | None = None
        while True:
            code = worker.poll()
            if code is not None:
                return code
            self._drain_marks()
            if (self._terminate.is_set() or self._resize.is_set()) \
                    and term_sent_at is None:
                term_sent_at = self._clock()
                logger.info('rank %d: forwarding SIGTERM to worker '
                            '(%s, grace %.0fs)', self.rank,
                            'resize' if self._resize.is_set() else 'drain',
                            self.grace)
                try:
                    worker.send_signal(signal_module.SIGTERM)
                except (OSError, ValueError):
                    pass
            elif (term_sent_at is not None
                    and self._clock() - term_sent_at > self.grace):
                logger.warning('rank %d: grace expired; SIGKILLing worker',
                               self.rank)
                try:
                    worker.kill()
                except OSError:
                    pass
                term_sent_at = float('inf')   # kill once, keep polling
            self._sleep(self._poll_interval)

    def close(self) -> None:
        self._repl_stop.set()
        self._repl_wake.set()          # unblock the replication worker
        if self.server is not None:
            self.server.close()

    def __enter__(self) -> 'Supervisor':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
