"""The port's Supervisor and hot memstore, held to the reference's tests.

Twins of ``tests/test_supervisor.py``: ``TestExitContract``,
``TestSupervisorPolicy`` (a fake clock and fake processes: no real sleeps),
``TestSigtermForwarding`` (stub workers in real processes),
``TestMemStoreWire`` (the socket wire; the sharded-leaf case in its
one-device form) and ``TestHotResume`` (the port's MLP cell), and one twin
of the slow ``TestEndToEndDrill``, marked slow as the reference's is: a
worker SIGKILLed mid-epoch under the port's ``Supervisor`` relaunches,
restores hot, and ends bit for bit where an uninterrupted run ends.
Also here: the serving tests the reference keeps in
``tests/test_router_failover.py`` that need the supervisor
(``test_fenced_maps_to_exit_47_and_halts``' ``_CODE_NAMES`` line,
``test_supervised_fenced_router_halts_for_triage``,
``test_supervisor_narrates_the_standby_death_and_relaunches``).

And ``TestBuddyReplication``: hot state replicated between two
supervisors over the port's ``TcpTransport`` (and ``ChaosTransport``,
whose truncated chunks the transfer digest catches). The twin of
``tests/test_serve_failover.py::test_sigkill_subprocess_drill_under_supervisor``
is in ``tests/test_torch_failover.py``.
"""

from __future__ import annotations

import json
import os
import signal as signal_module
import sys
import threading
import time

import pytest

import numpy as np
import torch

from tpusystem_torch.checkpoint.memstore import (MemStore, MemStoreClient,
                                                 MemStoreServer, blob_digest,
                                                 pack_hot, serialize_state,
                                                 supervisor_client)
from tpusystem_torch.observe.events import (RecoveryTimeline, WorkerExited,
                                            WorkerRelaunched)
from tpusystem_torch.parallel.recovery import (CRASH_LOOP_EXIT,
                                               DIVERGED_EXIT, FAILURE_EXIT,
                                               LOST_WORKER_EXIT,
                                               PREEMPTED_EXIT, RESIZED_EXIT,
                                               ROUTER_FENCED_EXIT,
                                               RESTART_EXITS,
                                               DivergenceError, Preempted,
                                               WorkerLostError,
                                               WorldResizedError,
                                               exit_for_restart)
from tpusystem_torch.parallel.multihost import Hub, TcpTransport
from tpusystem_torch.parallel.supervisor import Supervisor
from tpusystem_torch.services.prodcon import Consumer, Producer

IDENTITY = 'drill-mlp'


# ---------------------------------------------------------------------------
# satellite: exit_for_restart maps ONLY the recovery exceptions


class TestExitContract:

    @pytest.mark.parametrize('reason, code', [
        (WorkerLostError(1, 2.0), LOST_WORKER_EXIT),
        (Preempted(signal_module.SIGTERM), PREEMPTED_EXIT),
        (WorldResizedError(1, (0, 2)), RESIZED_EXIT),
        (DivergenceError('gave up', step=7), DIVERGED_EXIT),
        (ValueError('a plain bug'), FAILURE_EXIT),
        (KeyboardInterrupt(), FAILURE_EXIT),
        (RuntimeError('not a recovery type'), FAILURE_EXIT),
    ])
    def test_exit_code_table(self, reason, code):
        """The fixed bug: an unrecognized exception used to map to the
        restartable 42 — a plain ValueError (or a ^C) would have been
        relaunched forever. Only the three recovery exceptions get
        contract codes; everything else is a non-restart failure."""
        assert exit_for_restart(reason).code == code

    def test_worker_lost_error_carries_reason(self):
        assert 'socket death' in str(WorkerLostError(2, 1.0))
        assert 'heartbeat stall' in str(WorkerLostError(2, 1.0, 'heartbeat'))
        assert WorkerLostError(2, 1.0, 'heartbeat').reason == 'heartbeat'


# ---------------------------------------------------------------------------
# fake process harness: policy tests with zero subprocesses and zero sleeps


class FakeClock:
    def __init__(self):
        self.time = 0.0
        self.slept: list[float] = []

    def __call__(self) -> float:
        return self.time

    def sleep(self, seconds: float) -> None:
        self.slept.append(seconds)
        self.time += seconds


class FakeWorker:
    """Exits with ``code`` after ``polls`` poll cycles; ``on_poll`` can
    inject timeline marks / lifetime exactly like a real worker would."""

    pid = 4242

    def __init__(self, code, polls=1, on_poll=None):
        self.code = code
        self.polls = polls
        self.on_poll = on_poll
        self.count = 0
        self.signals: list[int] = []

    def poll(self):
        self.count += 1
        if self.on_poll is not None:
            self.on_poll(self)
        return self.code if self.count > self.polls else None

    def send_signal(self, signum):
        self.signals.append(signum)

    def kill(self):
        self.signals.append(signal_module.SIGKILL)


def scripted(*workers):
    """A fake popen yielding each FakeWorker in turn."""
    launched = []

    def popen(argv, env=None):
        launched.append(env)
        return workers[len(launched) - 1]
    popen.launched = launched
    return popen


def capture_events(supervisor):
    producer = Producer()
    seen = []
    consumer = Consumer()
    for kind in (WorkerExited, WorkerRelaunched, RecoveryTimeline):
        consumer.register(kind, seen.append)
    producer.register(consumer)
    supervisor.producer = producer
    return seen


def policy_supervisor(popen, clock, **kwargs):
    kwargs.setdefault('memstore', False)
    kwargs.setdefault('backoff_jitter', 0.0)
    return Supervisor(['worker'], popen=popen, clock=clock,
                      sleep=clock.sleep, **kwargs)


class TestSupervisorPolicy:

    def test_clean_exit_is_not_relaunched(self):
        clock = FakeClock()
        popen = scripted(FakeWorker(0))
        supervisor = policy_supervisor(popen, clock)
        seen = capture_events(supervisor)
        assert supervisor.run() == 0
        assert len(popen.launched) == 1
        assert [event.action for event in seen
                if isinstance(event, WorkerExited)] == ['done']

    @pytest.mark.parametrize('code', [DIVERGED_EXIT, 1, 7])
    def test_non_restart_codes_halt_for_triage(self, code):
        """Exit 44 (diverged) and unknown codes are NEVER relaunched — a
        blind relaunch of a deterministic failure replays it."""
        clock = FakeClock()
        popen = scripted(FakeWorker(code))
        supervisor = policy_supervisor(popen, clock)
        seen = capture_events(supervisor)
        assert supervisor.run() == code
        assert len(popen.launched) == 1
        assert clock.slept.count(0.05) >= 1     # polled, never backed off
        assert [event.action for event in seen
                if isinstance(event, WorkerExited)] == ['halt']

    @pytest.mark.parametrize('code', [LOST_WORKER_EXIT, PREEMPTED_EXIT,
                                      RESIZED_EXIT, -9])
    def test_restartable_codes_relaunch(self, code):
        """42, 43, 46 and signal deaths (a SIGKILLed worker IS the
        worker-lost case) relaunch; the run ends when the worker
        completes."""
        clock = FakeClock()
        popen = scripted(FakeWorker(code), FakeWorker(0))
        supervisor = policy_supervisor(popen, clock, crash_loop_k=5)
        assert supervisor.run() == 0
        assert len(popen.launched) == 2
        assert supervisor.restarts == 1

    @pytest.mark.parametrize('signum, outcome', [
        (signal_module.SIGKILL, 'relaunch'),   # OOM-killer / SIGKILLed pod
        (signal_module.SIGTERM, 'relaunch'),   # eviction the worker missed
        (signal_module.SIGSEGV, 'relaunch'),   # process failed as a unit
        (signal_module.SIGBUS, 'relaunch'),
        (signal_module.SIGINT, 'halt'),        # ^C is operator intent
        (signal_module.SIGQUIT, 'halt'),       # ^\ likewise
    ])
    def test_signal_death_verdict_table(self, signum, outcome):
        """The fixed gap: every ``code < 0`` used to relaunch — a worker
        dying to the operator's own ^C/^\\ would be respawned forever,
        fighting the human. SIGINT/SIGQUIT now halt for triage like exit
        1; genuine process deaths still relaunch."""
        clock = FakeClock()
        popen = scripted(FakeWorker(-signum), FakeWorker(0))
        supervisor = policy_supervisor(popen, clock, crash_loop_k=5)
        seen = capture_events(supervisor)
        code = supervisor.run()
        actions = [e.action for e in seen if isinstance(e, WorkerExited)]
        if outcome == 'relaunch':
            assert code == 0 and len(popen.launched) == 2
            assert actions == ['relaunch', 'done']
        else:
            assert code == FAILURE_EXIT and len(popen.launched) == 1
            assert actions == ['halt']
            assert seen[0].code == -signum     # the event keeps the truth

    def test_resize_relaunches_under_the_new_spec_without_backoff(self):
        """The elastic commit hook: resize() drains the worker (SIGTERM),
        merges the new world spec into its env, re-points the buddy, and
        relaunches immediately — no backoff, no crash-loop sample."""
        clock = FakeClock()
        box = {}

        def trigger(worker):
            if worker.count == 1:
                box['sup'].resize({'TPUSYSTEM_ELASTIC': 'new-spec'}, buddy=2)

        first = FakeWorker(PREEMPTED_EXIT, polls=3, on_poll=trigger)
        popen = scripted(first, FakeWorker(0))
        supervisor = policy_supervisor(popen, clock)
        box['sup'] = supervisor
        seen = capture_events(supervisor)
        assert supervisor.run() == 0
        assert len(popen.launched) == 2
        assert signal_module.SIGTERM in first.signals       # the drain
        assert popen.launched[0].get('TPUSYSTEM_ELASTIC') is None
        assert popen.launched[1]['TPUSYSTEM_ELASTIC'] == 'new-spec'
        assert supervisor.buddy == 2                        # re-paired
        assert [s for s in clock.slept if s >= 1.0] == []   # no backoff
        actions = [e.action for e in seen if isinstance(e, WorkerExited)]
        assert actions == ['resize', 'done']

    def test_resize_during_backoff_applies_before_the_relaunch(self):
        """A resize committed while the supervisor sleeps out a backoff
        must fold into the environment BEFORE the relaunch — spawning a
        worker under the stale world spec just to SIGTERM it would waste
        a whole worker start."""
        clock = FakeClock()
        box = {}

        def sleep_then_resize(seconds):
            clock.sleep(seconds)
            if seconds >= 1.0:            # the backoff sleep, not a poll
                box['sup'].resize({'TPUSYSTEM_ELASTIC': 'spec'}, buddy=2)

        relaunched = FakeWorker(0)
        popen = scripted(FakeWorker(LOST_WORKER_EXIT), relaunched)
        supervisor = Supervisor(['worker'], memstore=False, popen=popen,
                                clock=clock, sleep=sleep_then_resize,
                                backoff_base=1.0, backoff_jitter=0.0)
        box['sup'] = supervisor
        assert supervisor.run() == 0
        assert len(popen.launched) == 2
        assert popen.launched[1]['TPUSYSTEM_ELASTIC'] == 'spec'
        assert supervisor.buddy == 2
        assert relaunched.signals == []   # fresh worker never SIGTERMed

    def test_operator_sigint_outranks_a_pending_resize(self):
        """^C while a resize drain is in flight still halts: the pending
        resize must not dress an operator interrupt as a relaunch."""
        clock = FakeClock()
        box = {}

        def trigger(worker):
            if worker.count == 1:
                box['sup'].resize({'TPUSYSTEM_ELASTIC': 'spec'})

        popen = scripted(FakeWorker(-signal_module.SIGINT, polls=3,
                                    on_poll=trigger))
        supervisor = policy_supervisor(popen, clock)
        box['sup'] = supervisor
        assert supervisor.run() == FAILURE_EXIT
        assert len(popen.launched) == 1

    def test_backoff_grows_exponentially_and_caps(self):
        """Relaunch delays follow min(cap, base * 2**attempt): measured on
        the fake clock, no real time passes."""
        clock = FakeClock()
        workers = [FakeWorker(42) for _ in range(6)] + [FakeWorker(0)]
        popen = scripted(*workers)
        supervisor = policy_supervisor(popen, clock, backoff_base=1.0,
                                       backoff_cap=8.0, crash_loop_k=100)
        assert supervisor.run() == 0
        backoffs = [s for s in clock.slept if s >= 1.0]
        assert backoffs == [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]

    def test_backoff_jitter_is_bounded_and_seeded(self):
        clock = FakeClock()
        popen = scripted(*([FakeWorker(42) for _ in range(4)]
                           + [FakeWorker(0)]))
        supervisor = policy_supervisor(popen, clock, backoff_base=2.0,
                                       backoff_jitter=0.5, seed=11,
                                       crash_loop_k=100)
        supervisor.run()
        backoffs = [s for s in clock.slept if s >= 2.0]
        for index, backoff in enumerate(backoffs):
            nominal = 2.0 * 2 ** index
            assert nominal <= backoff <= nominal * 1.5
        # deterministic: same seed, same jitter
        clock2 = FakeClock()
        popen2 = scripted(*([FakeWorker(42) for _ in range(4)]
                            + [FakeWorker(0)]))
        supervisor2 = policy_supervisor(popen2, clock2, backoff_base=2.0,
                                        backoff_jitter=0.5, seed=11,
                                        crash_loop_k=100)
        supervisor2.run()
        assert [s for s in clock2.slept if s >= 2.0] == backoffs

    def test_crash_loop_gives_up_with_distinct_exit(self):
        """K consecutive restartable exits within the window -> the
        supervisor stops relaunching and exits CRASH_LOOP_EXIT (45), a
        code deliberately outside RESTART_EXITS."""
        clock = FakeClock()
        popen = scripted(*[FakeWorker(42) for _ in range(10)])
        supervisor = policy_supervisor(popen, clock, crash_loop_k=3,
                                       crash_loop_window=60.0)
        seen = capture_events(supervisor)
        assert supervisor.run() == CRASH_LOOP_EXIT
        assert len(popen.launched) == 3
        actions = [e.action for e in seen if isinstance(e, WorkerExited)]
        assert actions == ['relaunch', 'relaunch', 'crash-loop']

    def test_productive_run_resets_crash_loop_and_backoff(self):
        """A worker that lives past the window (here: its polls advance the
        fake clock beyond it) clears the rapid-death counter AND the
        backoff ladder — only *consecutive* rapid deaths count."""
        clock = FakeClock()

        def long_lived(worker):
            clock.time += 30.0        # each poll cycle ages the run

        workers = [FakeWorker(42), FakeWorker(42),
                   FakeWorker(42, polls=3, on_poll=long_lived),
                   FakeWorker(42), FakeWorker(42), FakeWorker(0)]
        popen = scripted(*workers)
        supervisor = policy_supervisor(popen, clock, crash_loop_k=3,
                                       crash_loop_window=60.0,
                                       backoff_base=1.0, backoff_cap=64.0)
        assert supervisor.run() == 0
        assert len(popen.launched) == 6
        backoffs = [s for s in clock.slept if s >= 1.0]
        # 1, 2 (two rapid deaths), then the productive run resets the
        # ladder: 1 again, and the following rapid deaths climb afresh
        assert backoffs == [1.0, 2.0, 1.0, 2.0, 4.0]

    def test_first_step_mark_anchors_the_crash_window(self):
        """The window measures from the worker's first-step mark, not from
        launch: a worker that spends ages compiling, steps once, then dies
        immediately IS a crash-loop sample."""
        clock = FakeClock()

        def mark_first_step(worker):
            if worker.count == 1:
                clock.time += 100.0           # long compile, no step yet
            elif worker.count == 2:
                worker.supervisor._on_mark('first-step', {})

        workers = []
        for _ in range(3):
            worker = FakeWorker(42, polls=2, on_poll=mark_first_step)
            workers.append(worker)
        popen = scripted(*workers)
        supervisor = policy_supervisor(popen, clock, crash_loop_k=3,
                                       crash_loop_window=60.0)
        for worker in workers:
            worker.supervisor = supervisor
        assert supervisor.run() == CRASH_LOOP_EXIT
        assert len(popen.launched) == 3

    def test_max_restarts_caps_the_loop(self):
        clock = FakeClock()

        def long_lived(worker):
            clock.time += 30.0

        popen = scripted(*[FakeWorker(42, polls=3, on_poll=long_lived)
                           for _ in range(10)])
        supervisor = policy_supervisor(popen, clock, crash_loop_k=100,
                                       crash_loop_window=60.0,
                                       max_restarts=4)
        assert supervisor.run() == CRASH_LOOP_EXIT
        assert len(popen.launched) == 5            # 1 launch + 4 relaunches

    def test_terminate_during_backoff_skips_the_relaunch(self):
        """Review regression: eviction arriving while the supervisor
        sleeps out a backoff must NOT spawn a fresh worker just to
        SIGTERM it (likely before its handler is even installed) — the
        loop exits with the preemption code instead."""
        clock = FakeClock()
        supervisor_box = {}

        def sleep_then_terminate(seconds):
            clock.sleep(seconds)
            if seconds >= 1.0:            # the backoff sleep, not a poll
                supervisor_box['sup'].terminate()

        popen = scripted(FakeWorker(42), FakeWorker(0))
        supervisor = Supervisor(['worker'], memstore=False, popen=popen,
                                clock=clock, sleep=sleep_then_terminate,
                                backoff_base=1.0, backoff_jitter=0.0)
        supervisor_box['sup'] = supervisor
        assert supervisor.run() == PREEMPTED_EXIT
        assert len(popen.launched) == 1   # the doomed relaunch never ran

    def test_recovery_timeline_event_from_marks(self):
        """detect -> relaunch -> restore -> first-step, stamped on the fake
        clock, emitted as ONE RecoveryTimeline event with stage offsets
        relative to detection."""
        clock = FakeClock()
        supervisor_box = {}

        def resumed(worker):
            if worker.count == 1:
                sup = supervisor_box['sup']
                sup._on_mark('restore', {'source': 'hot', 'step': 6})
                clock.time += 0.5
                sup._on_mark('first-step', {'step': 7})

        popen = scripted(FakeWorker(42), FakeWorker(0, polls=2,
                                                    on_poll=resumed))
        supervisor = policy_supervisor(popen, clock, backoff_base=1.0)
        supervisor_box['sup'] = supervisor
        seen = capture_events(supervisor)
        assert supervisor.run() == 0
        timelines = [e for e in seen if isinstance(e, RecoveryTimeline)]
        assert len(timelines) == 1
        timeline = timelines[0]
        assert timeline.source == 'hot' and timeline.step == 6
        assert set(timeline.stages) >= {'relaunch', 'restore', 'first-step'}
        assert timeline.stages['relaunch'] <= timeline.stages['restore']
        assert timeline.stages['restore'] < timeline.stages['first-step']
        assert timeline.seconds == timeline.stages['first-step'] > 0
        assert supervisor.timelines == [timeline]


# ---------------------------------------------------------------------------
# SIGTERM forwarding: real processes, stub (jax-free) workers


STUB_DRAINS = ('import pathlib, signal, sys, time\n'
               'signal.signal(signal.SIGTERM, lambda *a: sys.exit(43))\n'
               'pathlib.Path(sys.argv[1]).touch()   # handler armed\n'
               'time.sleep(120)\n')

STUB_IGNORES = ('import pathlib, signal, sys, time\n'
                'signal.signal(signal.SIGTERM, signal.SIG_IGN)\n'
                'pathlib.Path(sys.argv[1]).touch()\n'
                'time.sleep(120)\n')


class TestSigtermForwarding:

    def stub(self, tmp_path, source):
        path = tmp_path / 'stub.py'
        path.write_text(source)
        self.ready = tmp_path / 'ready'
        return [sys.executable, str(path), str(self.ready)]

    def when_ready(self, action):
        """Fire ``action`` once the stub's handler is armed — terminating
        before that would hit the default SIGTERM disposition instead of
        the handler under test."""

        def wait_then_act():
            deadline = time.monotonic() + 30
            while not self.ready.exists() and time.monotonic() < deadline:
                time.sleep(0.01)
            action()

        threading.Thread(target=wait_then_act, daemon=True).start()

    def test_sigterm_reaches_the_preemption_handler(self, tmp_path):
        """Regression: the forwarded SIGTERM must land in the worker's own
        handler — exit 43 (the preemption drain), NOT a SIGKILL — and the
        supervisor passes that code through without relaunching."""
        supervisor = Supervisor(self.stub(tmp_path, STUB_DRAINS),
                                memstore=False, grace=10.0)
        self.when_ready(supervisor.terminate)
        start = time.monotonic()
        assert supervisor.run() == PREEMPTED_EXIT
        assert time.monotonic() - start < 8.0      # drained, no grace burn

    def test_sigterm_via_installed_signal_handler(self, tmp_path):
        """The launcher wiring: the scheduler SIGTERMs the *supervisor*
        process; the installed handler forwards to the worker."""
        previous = signal_module.getsignal(signal_module.SIGTERM)
        supervisor = Supervisor(self.stub(tmp_path, STUB_DRAINS),
                                memstore=False, grace=10.0)
        supervisor.install_signal_handler()
        try:
            self.when_ready(
                lambda: os.kill(os.getpid(), signal_module.SIGTERM))
            assert supervisor.run() == PREEMPTED_EXIT
        finally:
            signal_module.signal(signal_module.SIGTERM, previous)

    def test_grace_expiry_escalates_to_sigkill(self, tmp_path, caplog):
        """A worker that ignores SIGTERM is SIGKILLed once the grace
        window closes. The supervisor still exits with the preemption
        code: a raw negative waitpid code through SystemExit would
        surface as a meaningless 128+ shell status."""
        import logging
        supervisor = Supervisor(self.stub(tmp_path, STUB_IGNORES),
                                memstore=False, grace=0.5)
        self.when_ready(supervisor.terminate)
        with caplog.at_level(logging.WARNING, 'tpusystem_torch.supervisor'):
            assert supervisor.run() == PREEMPTED_EXIT
        assert 'grace expired' in caplog.text
        assert 'without draining' in caplog.text


# ---------------------------------------------------------------------------
# the memstore wire (no jax: blobs are plain bytes here)


class TestMemStoreWire:

    def test_push_fetch_roundtrip_chunked(self):
        store = MemStore()
        server = MemStoreServer(store, chunk_size=1024)
        client = MemStoreClient(server.address, chunk_size=1024)
        try:
            blob = os.urandom(10_000)              # ~10 chunks each way
            client.push(IDENTITY, 4, blob,
                        extras={'cursor': {'epoch': 0, 'batch': 4}})
            held = store.newest(IDENTITY)
            assert held.step == 4 and held.blob == blob
            fetched = client.fetch(IDENTITY)
            assert fetched.step == 4 and fetched.blob == blob
            assert fetched.extras == {'cursor': {'epoch': 0, 'batch': 4}}
            assert client.fetch('unknown-identity') is None
        finally:
            client.close()
            server.close()

    def test_stale_push_never_replaces_newer(self):
        store = MemStore()
        store.put(IDENTITY, 9, b'newer')
        store.put(IDENTITY, 3, b'older')
        assert store.newest(IDENTITY).blob == b'newer'

    def test_corrupted_slot_reads_as_absent(self, caplog):
        """RAM corruption (or a torn replication) must cost only the hot
        tier: the digest check turns the slot into a miss, never state."""
        import logging
        store = MemStore()
        entry = store.put(IDENTITY, 5, b'good bytes')
        entry.blob = b'bad  bytes'
        with caplog.at_level(logging.WARNING, 'tpusystem_torch.memstore'):
            assert store.newest(IDENTITY) is None
        assert 'digest' in caplog.text

    def test_put_verifies_caller_digest(self):
        store = MemStore()
        with pytest.raises(ValueError, match='digest'):
            store.put(IDENTITY, 5, b'payload', digest=blob_digest(b'other'))

    def test_marks_reach_the_supervisor(self):
        marks = []
        server = MemStoreServer(on_mark=lambda s, i: marks.append((s, i)))
        client = MemStoreClient(server.address)
        try:
            client.mark('restore', source='hot', step=6)
            client.mark('first-step', step=7)
            deadline = time.monotonic() + 5
            while len(marks) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert marks == [('restore', {'source': 'hot', 'step': 6}),
                             ('first-step', {'step': 7})]
        finally:
            client.close()
            server.close()

    def test_dead_supervisor_degrades_push_and_fetch(self, caplog):
        """Review regression: a supervisor that dies mid-run must cost
        only the hot tier — push returns False and fetch returns None
        (logged once), never an exception that would kill the worker with
        a non-restartable exit while disk checkpoints still stand."""
        import logging
        server = MemStoreServer()
        client = MemStoreClient(server.address)
        assert client.push(IDENTITY, 1, b'while alive') is True
        server.close()                    # the supervisor is OOM-killed
        with caplog.at_level(logging.WARNING, 'tpusystem_torch.memstore'):
            assert client.push(IDENTITY, 2, b'after death') is False
            assert client.push(IDENTITY, 3, b'again') is False
            assert client.fetch(IDENTITY) is None
        assert caplog.text.count('supervisor unreachable') == 1  # logged once
        client.close()

    @staticmethod
    def _rebind(store, host, port):
        """A restarted supervisor re-listens at its old address; the
        kernel frees the port as soon as the dead client socket's FIN
        lands (the client's redial machinery closed it), which can race
        an immediate rebind by a few ms — retry like a real relaunch."""
        deadline = time.monotonic() + 5
        while True:
            try:
                return MemStoreServer(store, host=host, port=port)
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.02)

    def test_bounced_supervisor_redial_resumes_pushes(self):
        """The permanent-degradation regression: a supervisor that
        RESTARTS listens at the same address again, and the client must
        redial it — journal/hot-state pushes resume instead of silently
        freezing durability for the rest of the run."""
        store = MemStore()
        server = MemStoreServer(store)
        host, port = server.address
        client = MemStoreClient(server.address, redial_backoff=0.0)
        try:
            assert client.push(IDENTITY, 1, b'before the bounce') is True
            server.close()               # the supervisor dies...
            assert client.push(IDENTITY, 2, b'into the void') is False
            store = MemStore()           # ... and is relaunched fresh
            server = self._rebind(store, host, port)
            # the next call redials (backoff 0) and durability resumes
            assert client.push(IDENTITY, 3, b'after the bounce') is True
            assert store.newest(IDENTITY).step == 3
            fetched = client.fetch(IDENTITY)
            assert fetched.step == 3 and fetched.blob == b'after the bounce'
        finally:
            client.close()
            server.close()

    def test_redial_budget_is_bounded(self):
        """The redial ladder is capped per outage: once the budget is
        spent the client degrades permanently (the old contract) —
        even a healthy supervisor at the address is not re-dialed."""
        server = MemStoreServer()
        host, port = server.address
        client = MemStoreClient(server.address, redials=2,
                                redial_backoff=0.0)
        assert client.push(IDENTITY, 1, b'x') is True
        server.close()
        for step in range(2, 6):         # dead-socket push + 2 failed
            assert client.push(IDENTITY, step, b'y') is False   # redials
        server = self._rebind(MemStore(), host, port)
        try:                             # budget spent: stays degraded
            assert client.push(IDENTITY, 9, b'z') is False
        finally:
            client.close()
            server.close()

    def test_sharded_leaf_round_trip_is_bitwise(self):
        """The one-device form of the wire's sharded leaf: one piece whose
        index is the full slice, reassembled bit for bit onto the target's
        device; pieces of two blobs merge, and a shape that differs is a
        typed failure (-> disk)."""
        from tpusystem_torch.checkpoint.memstore import (HotState,
                                                         ShardedLeaf,
                                                         merge_hot)
        values = torch.arange(64, dtype=torch.float32).reshape(8, 8) * 0.37
        leaf = ShardedLeaf.from_tensor(values)
        assert list(leaf.shards) == [((0, 8, 1), (0, 8, 1))]
        assert torch.equal(leaf.place(torch.empty(8, 8)), values)
        with pytest.raises(ValueError, match='mismatch'):
            leaf.place(torch.empty(8, 4))
        import pickle
        blob = pickle.dumps([leaf])
        merged = merge_hot([HotState(3, blob_digest(blob), blob),
                            HotState(3, blob_digest(blob), blob)])
        assert merged.step == 3 and merged.source == 'merged'
        assert torch.equal(pickle.loads(merged.blob)[0].reassemble(), values)
        with pytest.raises(ValueError, match='disagree on the step'):
            merge_hot([HotState(3, '', blob), HotState(4, '', blob)])

    def test_supervisor_client_env_plumbing(self):
        server = MemStoreServer()
        try:
            client = supervisor_client(server.env)
            assert client is not None
            client.push(IDENTITY, 1, b'via-env')
            assert server.store.newest(IDENTITY).blob == b'via-env'
            client.close()
            assert supervisor_client({}) is None           # unsupervised
            # unreachable supervisor: hot tier off, never an exception
            assert supervisor_client(
                {'TPUSYSTEM_SUPERVISOR': '127.0.0.1:1'}) is None
        finally:
            server.close()




# ---------------------------------------------------------------------------
# the supervisor's side of the router's failover (tests/test_router_failover)


def test_fenced_router_code_is_named_and_not_restartable():
    from tpusystem_torch.parallel.supervisor import _CODE_NAMES
    assert ROUTER_FENCED_EXIT == 47 and ROUTER_FENCED_EXIT not in RESTART_EXITS
    assert _CODE_NAMES[ROUTER_FENCED_EXIT] == 'router-fenced'


def test_supervised_fenced_router_halts_for_triage():
    clock = FakeClock()
    popen = scripted(FakeWorker(ROUTER_FENCED_EXIT))
    supervisor = policy_supervisor(popen, clock)
    seen = capture_events(supervisor)
    assert supervisor.run() == ROUTER_FENCED_EXIT
    assert len(popen.launched) == 1
    assert [event.action for event in seen
            if isinstance(event, WorkerExited)] == ['halt']


def test_supervisor_narrates_the_standby_death_and_relaunches():
    clock = FakeClock()
    popen = scripted(FakeWorker(-9), FakeWorker(0))
    supervisor = policy_supervisor(popen, clock)
    seen = capture_events(supervisor)
    assert supervisor.run() == 0
    assert len(popen.launched) == 2
    assert [event.action for event in seen
            if isinstance(event, WorkerExited)] == ['relaunch', 'done']
    assert [event.restarts for event in seen
            if isinstance(event, WorkerRelaunched)] == [1]


def test_unported_knobs_name_their_items(tmp_path):
    """Every knob of the Supervisor is ported now (no knob raises for a
    later item): ``tracer=`` and ``flight_path=`` construct; the worker is
    launched with ``TPUSYSTEM_FLIGHT`` at that path after a stale
    post-mortem is cleared, and the dump it leaves is read back onto its
    ``WorkerExited``."""
    from tpusystem_torch.observe import FlightRecorder, Tracer
    from tpusystem_torch.observe.flight import ENV_FLIGHT

    flight = tmp_path / 'flight.json'
    flight.write_text('{"process": "the previous worker", "entries": []}')
    clock = FakeClock()

    def note(worker):          # what a worker's write-ahead ring leaves
        FlightRecorder(flight, process='w1').note('tick', step=worker.count)

    popen = scripted(FakeWorker(0, on_poll=note))
    tracer = Tracer('sup', clock=clock)
    supervisor = policy_supervisor(popen, clock, tracer=tracer,
                                   flight_path=str(flight))
    assert supervisor.tracer is tracer
    seen = capture_events(supervisor)
    assert supervisor.run() == 0
    assert popen.launched[0][ENV_FLIGHT] == str(flight)
    (exited,) = [event for event in seen if isinstance(event, WorkerExited)]
    assert exited.postmortem['process'] == 'w1'
    assert [entry['step'] for entry in exited.postmortem['entries']] == [2]


# ---------------------------------------------------------------------------
# the restart decision: hot state against disk


class TestHotResume:

    def parts(self):
        from tpusystem_torch.models import MLP
        from tpusystem_torch.train import (Adam, CrossEntropyLoss,
                                           build_train_step, init_state,
                                           module_apply)
        module = MLP(features=(16,), classes=10, dropout=0.2, device='cpu')
        optimizer = Adam(lr=1e-2)
        state = init_state(module, optimizer, rng=7)
        step = build_train_step(module_apply(module), CrossEntropyLoss(),
                                optimizer)
        rng = np.random.default_rng(0)
        inputs = torch.from_numpy(rng.normal(size=(8, 28, 28)).astype(
            np.float32))
        targets = torch.from_numpy(np.arange(8) % 10)
        return state, step, inputs, targets

    def trained(self, steps=3):
        state, step, inputs, targets = self.parts()
        for _ in range(steps):
            state, _ = step(state, inputs, targets)
        return state

    def blank(self):
        state = self.parts()[0]
        with torch.no_grad():
            for tensor in state.params.values():
                tensor.zero_()
        return state

    def assert_bitwise(self, left, right):
        from tpusystem_torch.checkpoint.checkpointer import flatten_state
        got, want = flatten_state(left), flatten_state(right)
        assert [path for path, _ in got] == [path for path, _ in want]
        for (_, a), (_, b) in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b

    def test_hot_restore_is_bitwise_identical_to_disk(self, tmp_path):
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        state = self.trained()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 3, state, extras={'k': 3})
            store = MemStore()
            store.put(IDENTITY, 3, serialize_state(state), extras={'k': 3})
            blank = self.blank()
            restored, step, extras, source = hot_resume(
                checkpointer, IDENTITY, blank, store)
            assert source == 'hot' and step == 3 and extras == {'k': 3}
            assert restored is blank             # into the target in place
            disk = checkpointer.restore(IDENTITY, self.blank(), epoch=3)
            self.assert_bitwise(restored, disk)
            self.assert_bitwise(restored, state)
            for tensor in restored.params.values():
                assert tensor.device == torch.device('cpu')

    def test_hot_ahead_of_disk_is_preferred(self, tmp_path):
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        older = self.trained(steps=2)
        newer = self.trained(steps=4)
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 2, older)
            store = MemStore()
            store.put(IDENTITY, 4, serialize_state(newer))
            restored, step, _, source = hot_resume(checkpointer, IDENTITY,
                                                   self.blank(), store)
            assert (source, step) == ('hot', 4)
            self.assert_bitwise(restored, newer)

    def test_stale_hot_state_falls_back_to_disk(self, tmp_path, caplog):
        import logging
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        older = self.trained(steps=2)
        newer = self.trained(steps=4)
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 4, newer)
            store = MemStore()
            store.put(IDENTITY, 2, serialize_state(older))
            with caplog.at_level(logging.WARNING, 'tpusystem_torch.memstore'):
                restored, step, _, source = hot_resume(
                    checkpointer, IDENTITY, self.blank(), store)
            assert (source, step) == ('disk', 4)
            assert 'stale' in caplog.text
            self.assert_bitwise(restored, newer)

    def test_corrupted_hot_state_falls_back_to_disk(self, tmp_path):
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        state = self.trained()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 3, state)
            store = MemStore()
            entry = store.put(IDENTITY, 5, serialize_state(state))
            entry.blob = entry.blob[:-1] + bytes([entry.blob[-1] ^ 1])
            restored, step, _, source = hot_resume(checkpointer, IDENTITY,
                                                   self.blank(), store)
            assert (source, step) == ('disk', 3)
            self.assert_bitwise(restored, state)

    def test_mismatched_hot_state_falls_back_to_disk(self, tmp_path):
        """A blob of another state's shape is refused before anything is
        written, and the disk restore follows."""
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        state = self.trained()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 3, state)
            store = MemStore()
            store.put(IDENTITY, 5, serialize_state({'w': torch.ones(3)}))
            restored, step, _, source = hot_resume(checkpointer, IDENTITY,
                                                   self.blank(), store)
            assert (source, step) == ('disk', 3)
            self.assert_bitwise(restored, state)

    def test_unsupervised_resume_is_plain_disk(self, tmp_path):
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        state = self.trained()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 3, state)
            _, step, _, source = hot_resume(checkpointer, IDENTITY,
                                            self.blank(), client=None)
            assert (source, step) == ('disk', 3)

    def test_restore_mark_rides_the_timeline(self, tmp_path):
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        state = self.trained()

        class Marked(MemStore):
            def __init__(self):
                super().__init__()
                self.marks = []

            def mark(self, stage, **info):
                self.marks.append((stage, info))

        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 3, state)
            store = Marked()
            store.put(IDENTITY, 3, serialize_state(state))
            hot_resume(checkpointer, IDENTITY, self.blank(), store)
            assert store.marks == [('restore', {'source': 'hot', 'step': 3})]

    def test_hot_restore_over_the_socket_wire(self, tmp_path):
        """The worker's path: push over the supervisor's socket, fetch and
        restore through ``supervisor_client``."""
        from tpusystem_torch.checkpoint import Checkpointer, hot_resume
        state = self.trained()
        server = MemStoreServer(chunk_size=4096)
        client = supervisor_client(server.env)
        try:
            assert client.push(IDENTITY, 3, state, extras={'k': 3})
            with Checkpointer(tmp_path, async_save=False) as checkpointer:
                restored, step, extras, source = hot_resume(
                    checkpointer, IDENTITY, self.blank(), client)
            assert (source, step, extras) == ('hot', 3, {'k': 3})
            self.assert_bitwise(restored, state)
        finally:
            client.close()
            server.close()


# ---------------------------------------------------------------------------
# the end-to-end drill: SIGKILL mid-epoch under the Supervisor, over real
# processes — relaunch, hot restore, a bit-for-bit continuation


DRILL_WORKER = r'''
import json, os, signal, sys
out_path, ckpt_root = sys.argv[1], sys.argv[2]
die_at, total = int(sys.argv[3]), int(sys.argv[4])
import torch
torch.set_num_threads(1)
from tpusystem_torch.checkpoint import (Checkpointer, hot_resume,
                                        serialize_state, supervisor_client)
from tpusystem_torch.data import Loader, SyntheticDigits
from tpusystem_torch.models import MLP
from tpusystem_torch.train import (Adam, CrossEntropyLoss, build_train_step,
                                   init_state, module_apply, resume_extras)
from tpusystem_torch.checkpoint.checkpointer import flatten_state

IDENTITY = 'drill-mlp'

def out(record):
    with open(out_path, 'a') as handle:
        handle.write(json.dumps(record) + '\n')
        handle.flush()
        os.fsync(handle.fileno())

loader = Loader(SyntheticDigits(samples=40, seed=4), batch_size=8,
                shuffle=True, seed=3, device='cpu')
module = MLP(features=(16,), classes=10, dropout=0.2, device='cpu')
optimizer = Adam(lr=1e-2)
state = init_state(module, optimizer, rng=7)
step = build_train_step(module_apply(module), CrossEntropyLoss(), optimizer)

client = supervisor_client()
checkpointer = Checkpointer(ckpt_root, async_save=False)
try:
    state, at, extras, source = hot_resume(checkpointer, IDENTITY, state,
                                           client)
except FileNotFoundError:
    pass
else:
    same = None
    if checkpointer.verify(IDENTITY, at):
        disk_module = MLP(features=(16,), classes=10, dropout=0.2,
                          device='cpu')
        disk = checkpointer.restore(
            IDENTITY, init_state(disk_module, optimizer, rng=7), epoch=at)
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else a == b for (_, a), (_, b) in zip(
                       flatten_state(state), flatten_state(disk)))
    out({'resumed': at, 'source': source, 'bitwise_disk_equal': same})
    loader.seek(extras['cursor'])

first = True
done = False
while not done:
    for inputs, targets in loader:
        state, (_, loss) = step(state, inputs, targets)
        at = int(state.step)
        extras = resume_extras(state, loader)
        checkpointer.save(IDENTITY, at, state, extras=extras)
        if client is not None:
            client.push(IDENTITY, at, serialize_state(state), extras=extras)
        if first:
            first = False
            if client is not None:
                client.mark('first-step', step=at)
        out({'step': at, 'loss': float(loss)})
        if at == die_at:
            os.kill(os.getpid(), signal.SIGKILL)
        if at >= total:
            done = True
            break
checkpointer.close()
out({'done': True})
'''


@pytest.mark.slow
class TestEndToEndDrill:

    DIE_AT, TOTAL = 6, 10

    def launch(self, tmp_path, name, *, die_at, memstore):
        run_dir = tmp_path / name
        run_dir.mkdir()
        worker = run_dir / 'worker.py'
        worker.write_text(DRILL_WORKER)
        out_path = run_dir / 'out.jsonl'
        argv = [sys.executable, str(worker), str(out_path),
                str(tmp_path / 'ckpt' / name), str(die_at), str(self.TOTAL)]
        env = {'PYTHONPATH': str(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))}
        supervisor = Supervisor(argv, memstore=memstore, env=env,
                                backoff_base=0.05, backoff_cap=0.2,
                                crash_loop_window=0.0)
        code = supervisor.run()
        records = [json.loads(line)
                   for line in out_path.read_text().splitlines()]
        losses = {r['step']: r['loss'] for r in records if 'step' in r}
        resumes = [r for r in records if 'resumed' in r]
        return code, losses, resumes, supervisor

    def test_sigkill_hot_restore_bitwise(self, tmp_path):
        """SIGKILL mid-epoch under the port's Supervisor -> relaunch ->
        restore from the memstore (source 'hot', bit for bit the disk
        checkpoint of the same step) -> the losses equal an uninterrupted
        run's; then with the memstore disabled, the disk path."""
        code, reference, resumes, _ = self.launch(
            tmp_path, 'ref', die_at=0, memstore=False)
        assert code == 0 and not resumes
        assert sorted(reference) == list(range(1, self.TOTAL + 1))

        code, losses, resumes, supervisor = self.launch(
            tmp_path, 'hot', die_at=self.DIE_AT, memstore=True)
        assert code == 0 and supervisor.restarts == 1
        assert len(resumes) == 1
        assert resumes[0]['source'] == 'hot'
        assert resumes[0]['resumed'] == self.DIE_AT
        assert resumes[0]['bitwise_disk_equal'] is True
        assert losses == reference
        assert len(supervisor.timelines) == 1
        timeline = supervisor.timelines[0]
        assert timeline.source == 'hot'
        assert set(timeline.stages) >= {'relaunch', 'restore', 'first-step'}

        code, losses, resumes, _ = self.launch(
            tmp_path, 'disk', die_at=self.DIE_AT, memstore=False)
        assert code == 0 and resumes[0]['source'] == 'disk'
        assert losses == reference


# ---------------------------------------------------------------------------
# buddy replication over the control plane (supervisor pod)


class TestBuddyReplication:

    def pod(self, faults=None):
        from tpusystem_torch.parallel.chaos import ChaosTransport
        hub = Hub(2)
        make = (lambda r: ChaosTransport(hub.address, r, 2, faults=faults[r])
                if faults else TcpTransport(hub.address, r, 2))
        transports = [make(rank) for rank in range(2)]
        deadline = time.monotonic() + 5
        while len(hub._clients) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        return hub, transports

    def test_push_is_replicated_to_the_buddy(self):
        hub, transports = self.pod()
        supervisors = [Supervisor(['w'], rank=rank,
                                  transport=transports[rank], buddy=1 - rank)
                       for rank in range(2)]
        try:
            client = MemStoreClient(supervisors[0].server.address)
            client.push(IDENTITY, 7, b'hot state bytes', extras={'b': 7})
            client.close()
            deadline = time.monotonic() + 5
            while (supervisors[1].store.newest(IDENTITY, replica=True) is None
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            replica = supervisors[1].store.newest(IDENTITY, replica=True)
            assert replica is not None
            assert replica.blob == b'hot state bytes'
            assert replica.step == 7 and replica.extras == {'b': 7}
            # the buddy's LOCAL namespace is untouched — replicas cannot
            # shadow the buddy host's own state
            assert supervisors[1].store.newest(IDENTITY) is None
        finally:
            for supervisor in supervisors:
                supervisor.close()
            for transport in transports:
                transport.close()
            hub.close()

    def test_replaced_host_pulls_from_its_buddy(self):
        """The replaced-host path: a FRESH supervisor (empty RAM) serving
        its worker's `get` pulls the hot state back from the buddy's
        replica slot over the control plane, digest-verified end to end."""
        hub, transports = self.pod()
        original = Supervisor(['w'], rank=0, transport=transports[0], buddy=1)
        buddy = Supervisor(['w'], rank=1, transport=transports[1], buddy=0)
        try:
            client = MemStoreClient(original.server.address)
            client.push(IDENTITY, 9, b'replicate me', extras={'b': 9})
            client.close()
            deadline = time.monotonic() + 5
            while (buddy.store.newest(IDENTITY, replica=True) is None
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            # host 0 is replaced: its supervisor restarts with empty RAM
            original.close()
            transports[0].close()
            replacement_transport = TcpTransport(hub.address, 0, 2)
            replacement = Supervisor(['w'], rank=0,
                                     transport=replacement_transport, buddy=1)
            try:
                client = MemStoreClient(replacement.server.address)
                pulled = client.fetch(IDENTITY)
                client.close()
                assert pulled is not None
                assert pulled.step == 9 and pulled.blob == b'replicate me'
                # and it is now cached locally for the next get
                assert replacement.store.newest(IDENTITY).step == 9
            finally:
                replacement.close()
                replacement_transport.close()
        finally:
            buddy.close()
            original.close()
            for transport in transports:
                transport.close()
            hub.close()

    def test_concurrent_buddy_push_cannot_satisfy_a_pull(self):
        """Review regression: while a replaced host pulls its state back
        (key 'hot:{id}'), the buddy's own concurrent replication push of
        ITS state (key 'replica:{id}') must never be mistaken for the
        pull's answer — with symmetric shard shapes that would silently
        restore the wrong host's bytes."""
        hub, transports = self.pod()
        try:
            # rank 1 actively replicates its own state toward rank 0
            transports[1].send_blob(0, f'replica:{IDENTITY}', b'rank1 OWN')
            # rank 0's pull must NOT see it: rank 1 has no replica slot
            # for rank 0 yet, so the honest answer is a NAK
            from tpusystem_torch.parallel.multihost import BlobError
            transports[0].on_blob = lambda *a: None   # swallow the push
            with pytest.raises(BlobError, match='no blob'):
                transports[0].fetch_blob(1, f'hot:{IDENTITY}', timeout=5)
        finally:
            for transport in transports:
                transport.close()
            hub.close()

    def test_truncated_replication_keeps_the_previous_copy(self, caplog):
        """Chaos: the replication transfer loses half a chunk — the
        transfer digest catches it at the receiving transport and the
        buddy keeps its previous (older) replica instead of a torn one."""
        import logging
        from tpusystem_torch.parallel.chaos import Faults
        faults = [Faults(seed=1, truncate=1.0, kinds=('blob',)),
                  Faults(seed=2)]
        hub, transports = self.pod(faults=faults)
        supervisors = [Supervisor(['w'], rank=rank,
                                  transport=transports[rank], buddy=1 - rank)
                       for rank in range(2)]
        try:
            # seed the buddy with a good older replica, fault-free
            from tpusystem_torch.checkpoint.memstore import HotState
            good = pack_hot(HotState(step=3, digest=blob_digest(b'v3'),
                                     blob=b'v3', extras=None))
            supervisors[1]._accept_replica(0, f'replica:{IDENTITY}', good)
            assert supervisors[1].store.newest(IDENTITY, replica=True).step == 3
            # now the live replication path, with every blob chunk truncated
            client = MemStoreClient(supervisors[0].server.address)
            with caplog.at_level(logging.WARNING, 'tpusystem_torch.multihost'):
                client.push(IDENTITY, 8, b'v8 fresh state')
                deadline = time.monotonic() + 3
                while ('digest' not in caplog.text
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
            client.close()
            assert faults[0].truncated       # the fault really fired
            held = supervisors[1].store.newest(IDENTITY, replica=True)
            assert held is not None and held.step == 3   # old copy stands
        finally:
            for supervisor in supervisors:
                supervisor.close()
            for transport in transports:
                transport.close()
            hub.close()
