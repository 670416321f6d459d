"""The port's trace plane (``observe/trace.py``), metric plane
(``observe/metrics.py``) and flight recorder (``observe/flight.py``): the
twins of ``tests/test_trace.py``, each test named as its reference test,
on the port's ``Scheduler``, ``Supervisor``, ``Checkpointer`` and elastic
coordinator. Then the cross-package check: the reference's
``Scheduler`` and the port's, over twin ``gpt2_tiny`` engines with crossed
weights on one fake clock, record the same span tree."""

import dataclasses
import json
import pathlib
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusystem_torch.observe import (FlightRecorder, Histogram, ServeLatency,
                               TraceContext, Tracer, serve_metrics_consumer)
from tpusystem_torch.observe.flight import dump_installed
from tpusystem_torch.parallel.multihost import Loopback
from tpusystem_torch.serve import Request, Scheduler
from tpusystem_torch.serve.failover import RequestJournal


class FakeClock:
    def __init__(self, now: float = 100.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


# ---------------------------------------------------------------------------
# a fake engine with the real admission surface (the fleet-test pattern)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Admission:
    row: int
    token: int
    finished: bool = False
    reason: str | None = None


@dataclasses.dataclass
class _Report:
    emitted: dict
    finished: list


@dataclasses.dataclass
class _Evicted:
    tokens: list


class _Pool:
    blocks = 100
    block_size = 8

    @staticmethod
    def blocks_for(tokens: int) -> int:
        return 1


class FakeEngine:
    """Deterministic token emission through the Scheduler's exact engine
    surface: token k of a request is ``base + k`` where base is the
    prompt length — enough to assert token-exactness without jax."""

    max_seq = 1024
    pool = _Pool()

    def __init__(self, rows: int = 2):
        self.rows = rows
        self.active: dict[int, list] = {}   # row -> [emitted, budget, base]

    def bucket(self, n: int) -> int:
        return n

    def admit_cost(self, prompt) -> int:
        return self.bucket(len(prompt))

    def can_admit(self, prompt_len: int, remaining: int,
                  prompt=None) -> bool:
        return len(self.active) < self.rows

    def _validate_sampling(self, sampling) -> None:
        pass                             # greedy-only fake

    def admit(self, prompt, remaining, stop_token=None, tag=None,
              sampling=None, emitted=()):
        row = next(r for r in range(self.rows) if r not in self.active)
        base = 1000 + len(prompt)
        if remaining == 1:
            return _Admission(row, base + 1, finished=True, reason='length')
        self.active[row] = [1, remaining, base]
        return _Admission(row, base + 1)

    def step(self):
        emitted, finished = {}, []
        for row, state in list(self.active.items()):
            state[0] += 1
            emitted[row] = [state[2] + state[0]]
            if state[0] >= state[1]:
                del self.active[row]
                tokens = [state[2] + k for k in range(1, state[0] + 1)]
                finished.append((row, 'length', tokens))
        return _Report(emitted, finished)

    def evict(self, row):
        state = self.active.pop(row)
        return _Evicted([state[2] + k for k in range(1, state[0] + 1)])


# the shared no-orphans validator IS the library's own
# (observe.trace.connected_traces — raises ValueError on a dangling
# parent); aliased here so every drill asserts through one contract
from tpusystem_torch.observe.trace import connected_traces as connected  # noqa: E402


# ---------------------------------------------------------------------------
# tracer units
# ---------------------------------------------------------------------------


class TestTracer:

    def test_span_lifecycle_and_context_parentage(self):
        clock = FakeClock()
        tracer = Tracer('p0', clock=clock)
        root = tracer.begin('request r1', cat='request')
        clock.advance(1.0)
        child = tracer.begin('queued', trace=root.context)
        clock.advance(2.0)
        tracer.end(child)
        tracer.end(root)
        assert child.trace_id == root.trace_id
        assert child.parent == root.span_id and root.parent is None
        assert child.end - child.start == pytest.approx(2.0)
        assert root.end - root.start == pytest.approx(3.0)

    def test_end_is_idempotent_and_tolerates_none(self):
        tracer = Tracer('p0', clock=FakeClock())
        span = tracer.begin('s')
        tracer.end(span, reason='done')
        first_end = span.end
        tracer.end(span, reason='again')
        assert span.end == first_end and span.args['reason'] == 'done'
        assert tracer.end(None) is None

    def test_export_is_valid_chrome_trace_json(self, tmp_path):
        clock = FakeClock()
        tracer = Tracer('hostA', clock=clock)
        with tracer.span('work', args={'k': 1}):
            clock.advance(0.5)
            tracer.instant('mark')
        open_span = tracer.begin('died-holding-this')
        clock.advance(0.25)
        path = tracer.export(tmp_path / 'trace.json')
        payload = json.loads(path.read_text())
        assert set(payload) == {'traceEvents', 'displayTimeUnit'}
        events = payload['traceEvents']
        meta = [e for e in events if e['ph'] == 'M']
        assert [m['args']['name'] for m in meta] == ['hostA']
        complete = {e['name']: e for e in events if e['ph'] == 'X'}
        assert complete['work']['dur'] == pytest.approx(0.5e6)
        # an open span exports with a provisional end and open=True
        assert complete['died-holding-this']['args']['open'] is True
        assert complete['died-holding-this']['dur'] == pytest.approx(0.25e6)
        instants = [e for e in events if e['ph'] == 'i']
        assert len(instants) == 1 and instants[0]['s'] == 'p'
        assert open_span.end is None     # export did not mutate the span

    def test_record_subsumes_timeline_stages(self):
        tracer = Tracer('sup', clock=FakeClock())
        root = tracer.record('recovery', 10.0, 14.0, cat='recovery')
        tracer.record('detect→relaunch', 10.0, 11.0, trace=root.context)
        tracer.record('relaunch→restore', 11.0, 13.5, trace=root.context)
        by_trace = connected(tracer.events())
        (group,) = by_trace.values()
        assert len(group) == 3

    def test_merge_is_id_keyed_and_idempotent(self):
        clock = FakeClock()
        a, b = Tracer('a', clock=clock), Tracer('b', clock=clock)
        root = a.begin('request r', cat='request')
        b.begin('queued', trace=root.context)
        collector = Tracer('collector', clock=clock)
        collector.merge(a)
        collector.merge(b)
        collector.merge(b.pack())          # re-send: no duplicates
        assert len(collector) == 2
        by_trace = connected(collector.events())
        (group,) = by_trace.values()       # cross-process parent resolves
        assert {e['name'] for e in group} == {'request r', 'queued'}

    def test_merge_later_copy_carries_the_closed_end(self):
        clock = FakeClock()
        worker = Tracer('w', clock=clock)
        collector = Tracer('c', clock=clock)
        span = worker.begin('decode')
        collector.merge(worker.pack())     # pushed while still open
        clock.advance(1.0)
        worker.end(span)
        collector.merge(worker.pack())     # phase-cadence re-push
        (event,) = [e for e in collector.events() if e['ph'] == 'X']
        assert 'open' not in event['args']

    def test_blob_plane_collection_rides_send_blob(self):
        clock = FakeClock()
        collector = Tracer('rank0', clock=clock)
        transport = Loopback()
        transport.on_blob = collector.accept_blob
        worker = Tracer('rank1', clock=clock)
        worker.begin('step')
        worker.send_spans(transport, to=0)
        assert len(collector) == 1
        # non-trace blobs are ignored and reported as not-ours (chainable)
        assert collector.accept_blob(0, 'replica:x', b'...') is False
        assert len(collector) == 1

    def test_context_is_picklable_and_frozen(self):
        context = TraceContext(trace_id='t/1', parent='s/1')
        assert pickle.loads(pickle.dumps(context)) == context
        with pytest.raises(dataclasses.FrozenInstanceError):
            context.trace_id = 'other'


# ---------------------------------------------------------------------------
# request-scoped tracing through the scheduler (fake engine, fake clock)
# ---------------------------------------------------------------------------


class TestSchedulerTracing:

    def drain(self, scheduler, max_steps=50):
        for _ in range(max_steps):
            if scheduler.idle:
                return
            scheduler.step()

    def test_one_connected_trace_per_request(self):
        clock = FakeClock()
        tracer = Tracer('rep0', clock=clock)
        scheduler = Scheduler(FakeEngine(rows=2), clock=clock, tracer=tracer)
        for index, budget in enumerate((3, 2, 4)):   # r2 queues behind
            scheduler.submit(Request(f'r{index}', [1] * (index + 2), budget))
        self.drain(scheduler)
        by_trace = connected(tracer.events())
        assert len(by_trace) == 3
        for group in by_trace.values():
            names = [e['name'] for e in group]
            assert sum(n.startswith('request ') for n in names) == 1
            assert 'queued' in names and 'decode' in names
        # roots closed with the terminal verdict
        roots = [e for e in tracer.events()
                 if e.get('cat') == 'request' and e['ph'] == 'X']
        assert all(e['args']['reason'] == 'length' for e in roots)
        assert all('open' not in e['args'] for e in roots)

    def test_replayed_row_parents_to_the_original_trace(self):
        """The acceptance property, unit-scale: pack the journal mid-
        stream (trace context rides the pickled Request), replay onto a
        FRESH scheduler with its own tracer, and the merged export is
        still ONE connected trace per request."""
        clock = FakeClock()
        first = Tracer('rep0', clock=clock)
        scheduler = Scheduler(FakeEngine(rows=1), clock=clock, tracer=first)
        scheduler.journal = RequestJournal('drill', clock=clock)
        scheduler.submit(Request('hot', [1, 2], 5))
        scheduler.submit(Request('cold', [1, 2, 3], 4))
        scheduler.step()                 # 'hot' seated, 'cold' queued
        scheduler.step()
        packed = scheduler.journal.pack()    # ...then the engine dies

        tick, rows = RequestJournal.unpack(packed)
        survivor = Tracer('rep1', clock=clock)
        fresh = Scheduler(FakeEngine(rows=1), clock=clock, tracer=survivor)
        for request, waited, emitted in rows:
            fresh.restore(request, waited=waited, prefix=emitted)
        self.drain(fresh)

        collector = Tracer('collector', clock=clock)
        collector.merge(first)
        collector.merge(survivor)
        by_trace = connected(collector.events())
        assert len(by_trace) == 2        # one trace per request, still
        hot_group = next(group for group in by_trace.values()
                         if any(e['args'].get('request') == 'hot'
                                for e in group))
        replayed = [e for e in hot_group if e['args'].get('replayed')]
        # 2 ticks before the kill: 1 admission token + 2 decode emissions
        assert replayed and replayed[0]['args']['prefix'] == 3
        # the replay span lives on rep1 but parents into rep0's root
        processes = {e['pid'] for e in hot_group}
        assert len(processes) == 2

    def test_cancelled_queued_request_closes_its_spans(self):
        clock = FakeClock()
        tracer = Tracer('rep0', clock=clock)
        scheduler = Scheduler(FakeEngine(rows=1), clock=clock, tracer=tracer)
        scheduler.submit(Request('a', [1, 2], 5))
        scheduler.submit(Request('b', [1, 2], 5))
        scheduler.step()
        assert scheduler.cancel('b') == 'queued'
        scheduler.cancel('a')
        self.drain(scheduler)
        open_spans = [e for e in tracer.events()
                      if e['ph'] == 'X' and e['args'].get('open')]
        assert not open_spans
        connected(tracer.events())

    def test_tracer_off_records_nothing_and_changes_nothing(self):
        clock = FakeClock()
        def run(tracer):
            scheduler = Scheduler(FakeEngine(rows=2), clock=clock,
                                  tracer=tracer)
            scheduler.submit(Request('a', [1, 2, 3], 4))
            self.drain(scheduler)
            return scheduler.results['a'].tokens
        assert run(None) == run(Tracer('t', clock=clock))


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


class TestHistogram:

    def reference(self, samples, q):
        ordered = sorted(samples)
        rank = max(1, int(np.ceil(q * len(ordered))))
        return ordered[rank - 1]

    def test_percentiles_match_sorted_reference_within_resolution(self):
        rng = np.random.default_rng(0)
        # latencies spanning 5 orders of magnitude (µs-scale to minutes)
        samples = np.concatenate([
            rng.lognormal(mean=-6, sigma=1.0, size=4000),
            rng.lognormal(mean=0.5, sigma=0.8, size=1000),
        ]).tolist()
        histogram = Histogram(resolution=0.05)
        for value in samples:
            histogram.add(value)
        for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
            exact = self.reference(samples, q)
            estimate = histogram.percentile(q)
            assert abs(estimate - exact) <= histogram.resolution * exact, (
                q, estimate, exact)

    def test_merge_in_any_order_yields_identical_percentiles(self):
        import itertools
        rng = np.random.default_rng(1)
        shards = []
        for host in range(4):        # per-host shards with skewed loads
            shard = Histogram(resolution=0.05)
            for value in rng.lognormal(mean=-3 + host, sigma=1.0,
                                       size=500 + 100 * host):
                shard.add(float(value))
            shards.append(shard)
        readings = set()
        for order in itertools.permutations(range(4)):
            merged = Histogram.merged([shards[i] for i in order])
            readings.add(tuple(merged.percentile(q)
                               for q in (0.5, 0.95, 0.99)))
            assert merged.count == sum(s.count for s in shards)
        assert len(readings) == 1, readings   # bit-identical, any order

    def test_merged_percentiles_match_pooled_reference(self):
        rng = np.random.default_rng(2)
        pools = [rng.lognormal(mean=-4, sigma=1.2, size=800).tolist()
                 for _ in range(3)]
        shards = []
        for pool in pools:
            shard = Histogram()
            for value in pool:
                shard.add(value)
            shards.append(shard)
        merged = Histogram.merged(shards)
        everything = [v for pool in pools for v in pool]
        for q in (0.5, 0.95, 0.99):
            exact = self.reference(everything, q)
            assert abs(merged.percentile(q) - exact) <= 0.05 * exact

    def test_single_sample_reads_back_exactly(self):
        histogram = Histogram()
        histogram.add(0.125)
        for q in (0.0, 0.5, 1.0):
            assert histogram.percentile(q) == 0.125

    def test_state_round_trips_and_summary(self):
        histogram = Histogram()
        for value in (0.001, 0.01, 0.25, 3.0):
            histogram.add(value)
        clone = Histogram.from_state(
            json.loads(json.dumps(histogram.state())))
        assert clone.percentile(0.5) == histogram.percentile(0.5)
        assert clone.count == 4 and clone.max == 3.0
        summary = histogram.summary()
        assert summary['count'] == 4
        assert summary['mean'] == pytest.approx(sum((0.001, 0.01, 0.25, 3.0))
                                                / 4)

    def test_validation(self):
        with pytest.raises(ValueError, match='resolution'):
            Histogram(resolution=0.0)
        with pytest.raises(ValueError, match='empty'):
            Histogram().percentile(0.5)
        with pytest.raises(ValueError, match='share bucketing'):
            Histogram(resolution=0.05).merge(Histogram(resolution=0.1))
        with pytest.raises(ValueError, match='q must be'):
            Histogram().percentile(1.5)

    def test_serve_latency_feeds_from_events_and_charts(self, tmp_path):
        from tests.tb import read_scalars
        from tpusystem_torch.observe import SummaryWriter
        from tpusystem_torch.observe import tensorboard as tensorboard_module
        from tpusystem_torch.observe.events import (EngineRestarted,
                                              RequestAdmitted,
                                              RequestCompleted)

        latency = ServeLatency()
        consumer = serve_metrics_consumer(latency, cadence=4)
        writer = SummaryWriter(tmp_path / 'run')
        consumer.dependency_overrides[tensorboard_module.writer] = \
            lambda: writer
        for index in range(8):
            consumer.consume(RequestAdmitted(
                id=f'r{index}', row=0, prompt_tokens=4,
                ttft=0.01 * (index + 1), queue_depth=1))
            consumer.consume(RequestCompleted(
                id=f'r{index}', produced=10, reason='length', seconds=1.0))
        consumer.consume(EngineRestarted(cause='stalled', replayed=1,
                                         resubmitted=0, seconds=0.5))
        writer.close()
        scalars = read_scalars(tmp_path / 'run', history=True)
        assert [step for _, step in scalars['serve/ttft_p50']] == [4, 8]
        value, _ = scalars['serve/ttft_p99'][-1]
        assert value == pytest.approx(0.08, rel=0.06)   # one bucket's worth
        assert scalars['serve/token_seconds_p50'][-1][0] == pytest.approx(
            0.1, rel=0.06)
        assert scalars['serve/recovery_p50'][0][0] == pytest.approx(
            0.5, rel=0.06)
        assert latency.ttft.count == 8 and latency.recovery.count == 1


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:

    def test_ring_is_bounded_and_dump_round_trips(self, tmp_path):
        clock = FakeClock()
        recorder = FlightRecorder(tmp_path / 'flight.json', capacity=4,
                                  cadence=2, process='w0', clock=clock)
        for index in range(10):
            recorder.note('tick', step=index)
        payload = FlightRecorder.read(tmp_path / 'flight.json')
        assert payload['process'] == 'w0'
        assert [entry['step'] for entry in payload['entries']] == [6, 7, 8, 9]
        assert len(recorder.ring) == 4

    def test_write_ahead_cadence_is_what_a_kill_leaves(self, tmp_path):
        recorder = FlightRecorder(tmp_path / 'flight.json', cadence=3,
                                  clock=FakeClock())
        recorder.note('a')
        recorder.note('b')
        assert FlightRecorder.read(tmp_path / 'flight.json') is None
        recorder.note('c')               # cadence hit: ring on disk now
        payload = FlightRecorder.read(tmp_path / 'flight.json')
        assert [entry['kind'] for entry in payload['entries']] == \
            ['a', 'b', 'c']

    def test_tap_keeps_stable_fields_only(self, tmp_path):
        from tpusystem_torch.observe.events import RequestAdmitted, Trained
        from tpusystem_torch.services.prodcon import Producer

        recorder = FlightRecorder(tmp_path / 'f.json', clock=FakeClock())
        producer = Producer()
        recorder.tap(producer)
        producer.dispatch(RequestAdmitted(id='r1', row=0, prompt_tokens=5,
                                          ttft=0.01, queue_depth=2))
        producer.dispatch(Trained(model=object(), metrics={'loss': 1.0}))
        entries = FlightRecorder.read(tmp_path / 'f.json')['entries']
        assert entries[0]['kind'] == 'RequestAdmitted'
        assert entries[0]['id'] == 'r1' and entries[0]['ttft'] == 0.01
        assert 'model' not in entries[1] and 'metrics' not in entries[1]

    def test_watch_folds_finished_spans(self, tmp_path):
        clock = FakeClock()
        recorder = FlightRecorder(tmp_path / 'f.json', clock=clock)
        tracer = Tracer('w', clock=clock)
        recorder.watch(tracer)
        span = tracer.begin('decode')
        clock.advance(0.5)
        tracer.end(span)
        entries = FlightRecorder.read(tmp_path / 'f.json')['entries']
        assert entries[0]['kind'] == 'span'
        assert entries[0]['name'] == 'decode'
        assert entries[0]['seconds'] == pytest.approx(0.5)

    def test_exit_contract_dumps_installed_recorders(self, tmp_path):
        from tpusystem_torch.parallel.recovery import (PREEMPTED_EXIT, Preempted,
                                                 exit_for_restart)

        recorder = FlightRecorder(tmp_path / 'f.json', cadence=1000,
                                  clock=FakeClock()).install()
        try:
            recorder.note('step', n=1)   # cadence 1000: nothing on disk yet
            assert FlightRecorder.read(tmp_path / 'f.json') is None
            exit = exit_for_restart(Preempted(signal.SIGTERM))
            assert exit.code == PREEMPTED_EXIT
            payload = FlightRecorder.read(tmp_path / 'f.json')
            assert payload['reason'] == 'Preempted'
            assert payload['code'] == PREEMPTED_EXIT
            assert payload['entries'][0]['kind'] == 'step'
        finally:
            recorder.uninstall()
        dump_installed()                 # uninstalled: no-op, no raise

    def test_dump_failure_degrades_and_logs_once(self, tmp_path, caplog):
        import logging
        target = tmp_path / 'not-a-dir'
        target.write_text('a file where the parent dir should be')
        recorder = FlightRecorder(target / 'f.json', clock=FakeClock())
        with caplog.at_level(logging.WARNING,
                             logger='tpusystem_torch.observe.flight'):
            recorder.note('a')
            recorder.note('b')
        assert sum('dump' in record.message
                   for record in caplog.records) == 1

    def test_sigkilled_subprocess_leaves_the_write_ahead_ring(self, tmp_path):
        """The kill contract, for real: a worker that SIGKILLs itself
        (no handler, no atexit, nothing) leaves exactly the entries the
        write-ahead cadence had already persisted."""
        worker = tmp_path / 'worker.py'
        worker.write_text(
            "import os, signal, sys\n"
            "sys.path.insert(0, sys.argv[2])\n"
            "from tpusystem_torch.observe.flight import FlightRecorder\n"
            "recorder = FlightRecorder(sys.argv[1], cadence=1)\n"
            "for step in range(5):\n"
            "    recorder.note('tick', step=step)\n"
            "os.kill(os.getpid(), signal.SIGKILL)\n")
        flight = tmp_path / 'flight.json'
        root = pathlib.Path(__file__).parent.parent
        done = subprocess.run([sys.executable, str(worker), str(flight),
                               str(root)], timeout=60)
        assert done.returncode == -signal.SIGKILL
        payload = FlightRecorder.read(flight)
        assert [entry['step'] for entry in payload['entries']] == \
            list(range(5))


# ---------------------------------------------------------------------------
# recovery / elastic / checkpoint spans
# ---------------------------------------------------------------------------


class TestSubsystemSpans:

    def test_supervisor_recovery_stages_become_spans(self):
        from tpusystem_torch.parallel.supervisor import Supervisor

        clock = FakeClock()
        tracer = Tracer('sup0', clock=clock)
        supervisor = Supervisor(['worker'], memstore=False, tracer=tracer,
                                clock=clock, sleep=lambda seconds: None)
        supervisor._timeline = {'detect': 10.0}
        supervisor._restore_info = {'source': 'hot', 'step': 7}
        for stage, at in (('relaunch', 11.0), ('restore', 12.5),
                          ('first-step', 14.0)):
            supervisor._timeline[stage] = at
        supervisor._emit_timeline()
        by_trace = connected(tracer.events())
        (group,) = by_trace.values()
        names = {event['name'] for event in group}
        assert f'recovery rank0' in names
        assert 'detect→relaunch' in names and 'restore→first-step' in names
        root = next(e for e in group if e['name'] == 'recovery rank0')
        assert root['args']['source'] == 'hot'
        assert root['dur'] == pytest.approx(4.0e6)
        # the event form still rides the bus untouched
        assert supervisor.timelines[0].stages['first-step'] == \
            pytest.approx(4.0)

    def test_elastic_wave_becomes_spans(self):
        from tpusystem_torch.parallel.elastic import (ElasticCoordinator,
                                                      ResizeDecision)

        clock = FakeClock()
        tracer = Tracer('sup0', clock=clock)
        coordinator = ElasticCoordinator(Loopback(), rank=0, size=4,
                                         clock=clock, tracer=tracer)
        # a committed wave's bookkeeping (the protocol itself is drilled
        # in test_torch_elastic.py; here: its trace-plane projection)
        coordinator.decisions.append(ResizeDecision(epoch=1,
                                                    members=(0, 1)))
        coordinator._committed_at = 50.0
        coordinator._commit_stages = {'propose': 0.5, 'commit': 1.5}
        clock.now = 53.0
        coordinator.resumed(step=12, source='hot-reshard')
        by_trace = connected(tracer.events())
        (group,) = by_trace.values()
        root = next(e for e in group
                    if e['name'] == 'elastic-resize epoch1')
        assert root['args']['source'] == 'hot-reshard'
        assert root['dur'] == pytest.approx(3.0e6)
        names = {e['name'] for e in group}
        assert 'wave-open→propose' in names and 'commit→resumed' in names

    def test_checkpointer_save_restore_spans(self, tmp_path):
        from tpusystem_torch.checkpoint import Checkpointer

        clock = FakeClock()
        tracer = Tracer('host0', clock=clock)
        state = {'w': torch.arange(4.0)}
        target = {'w': torch.zeros(4)}
        with Checkpointer(tmp_path / 'ckpt', async_save=False,
                          tracer=tracer) as checkpointer:
            checkpointer.save('m', 1, state)
            restored = checkpointer.restore('m', target, epoch=1)
        assert torch.equal(restored['w'], state['w'])
        names = [e['name'] for e in tracer.events() if e['ph'] == 'X']
        assert names == ['checkpoint-save', 'checkpoint-restore']
        args = [e['args'] for e in tracer.events() if e['ph'] == 'X']
        assert all(a['identity'] == 'm' for a in args)


class TestFlightRecorderHardening:

    def test_concurrent_notes_and_dumps_do_not_crash(self, tmp_path):
        """Entries arrive from scheduler loops, supervisor threads and
        bus dispatch at once; with cadence=1 every note also dumps — a
        mid-iteration append from another thread must never raise."""
        import threading

        recorder = FlightRecorder(tmp_path / 'f.json', capacity=64,
                                  cadence=1, clock=time.monotonic)
        errors = []

        def hammer(label):
            try:
                for index in range(200):
                    recorder.note(label, n=index)
            except Exception as error:      # pragma: no cover
                errors.append(error)

        threads = [threading.Thread(target=hammer, args=(f't{i}',))
                   for i in range(4)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        assert not errors, errors
        payload = FlightRecorder.read(tmp_path / 'f.json')
        assert payload is not None and len(payload['entries']) <= 64

    def test_non_jsonable_breadcrumb_is_sanitized_at_intake(self, tmp_path):
        """One bad entry must not poison later dumps of the whole ring
        (that would void the write-ahead SIGKILL guarantee for up to
        ``capacity`` entries): it degrades to its repr, alone, and the
        ring keeps persisting."""
        recorder = FlightRecorder(tmp_path / 'f.json', clock=FakeClock())
        recorder.note('ok', n=1)
        recorder.note('bad', arr=np.arange(3))        # not JSON-able
        recorder.note('after', n=2)                   # ...still persists
        payload = FlightRecorder.read(tmp_path / 'f.json')
        kinds = [entry['kind'] for entry in payload['entries']]
        assert kinds == ['ok', 'bad', 'after']
        assert 'unserializable' in payload['entries'][1]
        assert payload['entries'][-1]['n'] == 2

    def test_watch_chains_an_existing_sink(self, tmp_path):
        clock = FakeClock()
        seen = []
        tracer = Tracer('w', clock=clock, sink=seen.append)
        recorder = FlightRecorder(tmp_path / 'f.json', clock=clock)
        recorder.watch(tracer)
        tracer.end(tracer.begin('span'))
        assert len(seen) == 1            # the original sink still fires
        entries = FlightRecorder.read(tmp_path / 'f.json')['entries']
        assert entries[0]['kind'] == 'span'


def test_connected_traces_raises_on_a_dangling_parent():
    """The shared validator itself: a span whose parent was never
    collected (e.g. only the survivor's tracer was merged) must be
    reported, not silently grouped."""
    clock = FakeClock()
    origin = Tracer('rep0', clock=clock)
    survivor = Tracer('rep1', clock=clock)
    root = origin.begin('request r', cat='request')
    survivor.begin('queued', trace=root.context)
    with pytest.raises(ValueError, match='orphan'):
        connected(survivor.events())     # origin's root never merged
    collector = Tracer('c', clock=clock)
    collector.merge(origin)
    collector.merge(survivor)
    connected(collector.events())        # merged: no raise



# ---------------------------------------------------------------------------
# the same span tree from both packages' schedulers
# ---------------------------------------------------------------------------


def _span_tree(events: list) -> list:
    """The spans of an export as comparable data: name, category, phase,
    timestamps and args (trace, span and parent ids included), in order."""
    return [(event['name'], event.get('cat'), event['ph'], event['ts'],
             event.get('dur'), event['args'])
            for event in events if event['ph'] in ('X', 'i')]


def test_both_schedulers_record_the_same_span_tree():
    """Twin ``gpt2_tiny`` engines (float32, the reference's weights carried
    over by ``params_from_jax``), the same requests (one queued behind two
    rows, one cancelled while queued) and a fake clock advanced each step:
    the reference's tracer and the port's export the same spans — names,
    categories, parentage, timestamps and args — and one connected trace
    per request."""
    from tpusystem.observe import Tracer as ReferenceTracer
    from tests.torch_serving import BOTH, Served

    served = Served('gpt2')
    prompts = [np.random.default_rng(index).integers(0, 256, (n,))
               for index, n in enumerate((5, 9, 3, 7))]
    trees = []
    for P, tracer_type in zip(BOTH, (ReferenceTracer, Tracer)):
        clock = FakeClock()
        tracer = tracer_type('rep0', clock=clock)
        engine = served.engine(P, rows=2, block_size=8)
        scheduler = P.Scheduler(engine, clock=clock, tracer=tracer)
        for index, prompt in enumerate(prompts):
            scheduler.submit(P.Request(f'r{index}',
                                       [int(t) for t in prompt], 4))
        scheduler.step()
        assert scheduler.cancel('r3') == 'queued'
        for _ in range(40):
            if scheduler.idle:
                break
            clock.advance(0.25)
            scheduler.step()
        events = tracer.events()
        assert len(connected(events)) == len(prompts)
        trees.append(_span_tree(events))
    assert trees[0] and trees[0] == trees[1]
