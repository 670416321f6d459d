"""The port's serving failover: request journals, token-prefix replay, the
step watchdog, watermark shedding and the supervised replica.

Twins of ``tests/test_serve_failover.py`` (and of the journal-replay tests
of ``tests/test_serve_sampling.py``), with the port's in-process
``MemStore`` as the journal store. Host logic (journal framing, cadence,
recovery chain, the watchdog, watermarks) runs on the port alone and must
give the reference's outcomes; each drill with engines runs the same
requests through both packages on ``gpt2_tiny`` in float32 on the CPU
(``tests/torch_serving.py``): completions, replay reports and events equal
the reference's, and greedy streams equal the reference's ``generate``.
The twins of tests the reference marks ``slow`` are marked ``slow``.

``test_sigkill_subprocess_drill_under_supervisor``'s twin runs a port
serving worker under the port's ``Supervisor`` (slow, as the reference's).
Left out: the compiled-step witness ``trace_count`` (the port compiles
nothing).
"""

import logging
import pickle

import numpy as np
import pytest
import torch

from tests.torch_serving import (BOTH, PORT, REF, FakeClock, Served, plain,
                                 witness)
from tpusystem_torch.checkpoint.memstore import MemStore, blob_digest
from tpusystem_torch.parallel.multihost import _blob_digest
from tpusystem_torch.serve import (EngineStalled, JournalCorrupt, QueueFull,
                                   Request, RequestJournal, Scheduler,
                                   ServingReplica, StepWatchdog, Watermarks,
                                   journal_identity, recover_journal, replay)

LOGGER = 'tpusystem_torch.serve.failover'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def served():
    return Served('gpt2')


def build_for(P, served, **kwargs):
    knobs = dict(rows=2, block_size=8)
    knobs.update(kwargs)
    engine_knobs = {k: knobs.pop(k)
                    for k in ('rows', 'block_size', 'blocks', 'share_prefix',
                              'decode_impl', 'stream_dtype')
                    if k in knobs}
    return lambda: P.Scheduler(served.engine(P, **engine_knobs), **knobs)


def workload(seed=5, lengths=(5, 9, 7), budgets=(12, 10, 8)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in lengths]
    return prompts, list(budgets)


def refs_for(served, prompts, budgets):
    return [served.generate(p, b) for p, b in zip(prompts, budgets)]


def twin(scenario, served, **kwargs):
    """``scenario(P, served)`` on both packages: the records are equal."""
    port = scenario(PORT, served, **kwargs)
    assert port == scenario(REF, served, **kwargs)
    return port


# ---------------------------------------------------------------------------
# the journal: pack/unpack, digest, lifecycle, replication cadence
# ---------------------------------------------------------------------------


class TestJournal:

    def test_pack_unpack_round_trip_with_digest(self):
        clock = FakeClock()
        journal = RequestJournal('j', clock=clock)
        journal.record(Request('a', [1, 2, 3], 8), clock())
        clock.advance(2.0)
        journal.seated('a', 7)
        journal.append('a', 9)
        journal.record(Request('b', [4], 4, deadline=30.0), clock())
        journal.tick = 11
        tick, rows = RequestJournal.unpack(journal.pack())
        assert tick == 11
        assert [(r.id, waited, emitted)
                for r, waited, emitted in rows] == [
                    ('a', 2.0, [7, 9]), ('b', 0.0, [])]
        assert rows[1][0].deadline == 30.0
        # the framing is the reference's: digest of the payload, a colon
        digest, _, payload = journal.pack().partition(b':')
        assert digest == _blob_digest(payload).encode('ascii')

    @pytest.mark.parametrize('mangle', [
        lambda data: data[:len(data) // 2],                  # truncated
        lambda data: data[:-3] + b'???',                     # flipped tail
        lambda data: b'deadbeef' + data,                     # bad digest
    ])
    def test_corrupt_bytes_raise_journal_corrupt(self, mangle):
        journal = RequestJournal('j')
        journal.record(Request('a', [1, 2], 4), 0.0)
        with pytest.raises(JournalCorrupt):
            RequestJournal.unpack(mangle(journal.pack()))

    def test_rows_decode_as_the_references(self):
        """The same journal in both packages decodes to the same rows and
        tick (their bytes differ: a pickled row names its class's
        module)."""
        decoded = {}
        for P in BOTH:
            clock = FakeClock()
            journal = P.RequestJournal('x', clock=clock)
            journal.record(P.Request('a', [1, 2], 6, stop_token=3), clock())
            clock.advance(1.5)
            journal.seated('a', 4)
            journal.record(P.Request('b', [5], 2, sampling=P.SamplingParams(
                seed=2, temperature=0.5)), clock())
            journal.tick = 3
            tick, rows = P.RequestJournal.unpack(journal.pack())
            decoded[P.root] = (tick, [
                (r.id, r.prompt, r.max_new, r.stop_token, r.deadline,
                 None if r.sampling is None
                 else (r.sampling.seed, r.sampling.temperature),
                 waited, emitted) for r, waited, emitted in rows])
        assert decoded[PORT.root] == decoded[REF.root]

    def test_lifecycle_leaves_no_rows(self, served):
        def scenario(P, served):
            prompts, budgets = workload()
            scheduler = build_for(P, served)()
            scheduler.journal = journal = P.RequestJournal('j')
            for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
                scheduler.submit(P.Request(f'r{index}', prompt, budget))
            assert set(journal.rows) == {'r0', 'r1', 'r2'}
            scheduler.step()
            assert len(journal.rows['r0'].emitted) >= 1
            assert not journal.rows['r2'].emitted
            emitted = {rid: list(row.emitted)
                       for rid, row in journal.rows.items()}
            scheduler.cancel('r2')                      # queued cancel
            assert 'r2' not in journal.rows
            scheduler.cancel('r1')                      # active cancel
            assert 'r1' not in journal.rows
            scheduler.run()
            assert journal.rows == {}
            return emitted, plain(scheduler.results, seconds=False)
        twin(scenario, served)

    def test_cadence_and_monotonic_tick(self):
        store = MemStore()
        journal = RequestJournal('cad', client=store, cadence=3)
        for _ in range(7):
            journal.observe_tick()
        assert journal.pushes == 2                  # ticks 3 and 6
        entry = store.fetch(journal_identity('cad'))
        assert entry.step == 6
        tick, _ = RequestJournal.unpack(entry.blob)
        relaunched = RequestJournal('cad', client=store, cadence=3)
        relaunched.tick = tick
        for _ in range(3):
            relaunched.observe_tick()
        assert store.fetch(journal_identity('cad')).step == 9

    def test_push_failure_degrades_and_logs_once(self, caplog):
        class DeadClient:
            def push(self, *args, **kwargs):
                raise OSError('supervisor gone')

            def fetch(self, identity):
                return None

        journal = RequestJournal('dead', client=DeadClient(), cadence=1)
        with caplog.at_level(logging.WARNING, LOGGER):
            journal.observe_tick()
            journal.observe_tick()
        assert not journal.pushes
        assert caplog.text.count('journal replication') == 1

    def test_recover_journal_skips_corrupt_and_missing(self, caplog):
        good = MemStore()
        journal = RequestJournal('rec', client=good, cadence=1)
        journal.record(Request('a', [1, 2], 4), 0.0)
        journal.observe_tick()
        corrupt = MemStore()
        corrupt.put(journal_identity('rec'), 5, b'garbage-bytes')
        with caplog.at_level(logging.WARNING, LOGGER):
            recovered = recover_journal('rec', (None, MemStore(), corrupt,
                                                good))
        assert recovered is not None
        tick, rows = recovered
        assert tick == 1 and rows[0][0].id == 'a'
        assert 'rejected' in caplog.text
        assert recover_journal('rec', (MemStore(),)) is None


# ---------------------------------------------------------------------------
# the chaos drill: kill at tick k -> relaunch -> replay -> token-exact
# ---------------------------------------------------------------------------


def _kill_at_tick(P, served):
    prompts, budgets = workload()
    refs = refs_for(served, prompts, budgets)
    store = P.MemStore()
    build = build_for(P, served)
    replica = P.ServingReplica(build, identity='drill', client=store,
                               cadence=1)
    assert not replica.recovered
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica.submit(P.Request(f'r{index}', prompt, budget))
    for _ in range(4):
        replica.step()
    relaunched = P.ServingReplica(build, identity='drill', client=store,
                                  cadence=1)
    assert relaunched.recovered
    assert set(relaunched.report.replayed) == {'r0', 'r1'}
    assert relaunched.report.resubmitted == ['r2']
    results = relaunched.run_until_idle()
    for index in range(3):
        got = results[f'r{index}']
        assert got.tokens == refs[index], f'r{index} diverged after replay'
        assert got.reason == 'length'
    return plain(results, seconds=False)


@pytest.mark.slow
def test_kill_at_tick_k_replay_is_token_exact(served):
    twin(_kill_at_tick, served)


def _kill_via_chaos(P, served):
    prompts, budgets = workload(seed=11, lengths=(6, 4), budgets=(9, 7))
    refs = refs_for(served, prompts, budgets)
    store = P.MemStore()
    build = build_for(P, served)
    replica = P.ServingReplica(build, identity='chaos', client=store,
                               cadence=1, fault=P.DieAtStep(step=3))
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica.submit(P.Request(f'r{index}', prompt, budget))
    with pytest.raises(P.WorkerKilled):
        replica.run_until_idle()
    relaunched = P.ServingReplica(build, identity='chaos', client=store,
                                  cadence=1)
    assert relaunched.recovered
    results = relaunched.run_until_idle()
    for index in range(2):
        assert results[f'r{index}'].tokens == refs[index]
    return plain(results, seconds=False)


@pytest.mark.slow
def test_kill_via_chaos_fault_mid_step(served):
    twin(_kill_via_chaos, served)


class _Replicating:
    """Buddy replication in miniature: every verified local push mirrors
    to the buddy's replica namespace."""

    def __init__(self, local, buddy):
        self.local, self.buddy = local, buddy

    def push(self, identity, step, blob, extras=None):
        self.local.put(identity, step, blob, extras=extras)
        self.buddy.put(identity, step, blob, extras=extras, replica=True)
        return True

    def fetch(self, identity):
        return self.local.fetch(identity)


class _ReplicaView:
    """Read a buddy store's replica namespace."""

    def __init__(self, store):
        self.store = store

    def fetch(self, identity):
        return self.store.newest(identity, replica=True)


def _corrupt_local(P, served, caplog):
    prompts, budgets = workload(seed=13, lengths=(5, 7), budgets=(10, 6))
    refs = refs_for(served, prompts, budgets)
    local, buddy = P.MemStore(), P.MemStore()
    build = build_for(P, served)
    replica = P.ServingReplica(build, identity='pair',
                               client=_Replicating(local, buddy), cadence=1)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica.submit(P.Request(f'r{index}', prompt, budget))
    for _ in range(3):
        replica.step()
    entry = local.fetch(P.journal_identity('pair'))
    entry.blob = entry.blob[:-4] + b'!!!!'
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        relaunched = P.ServingReplica(
            build, identity='pair', client=local,
            fallbacks=(_ReplicaView(buddy),), cadence=1)
    assert 'digest' in caplog.text            # the corrupt slot was seen
    assert relaunched.recovered               # ... and the buddy answered
    results = relaunched.run_until_idle()
    for index in range(2):
        assert results[f'r{index}'].tokens == refs[index]
    return plain(results, seconds=False)


@pytest.mark.slow
def test_corrupt_local_journal_recovers_from_buddy(served, caplog):
    twin(_corrupt_local, served, caplog=caplog)


class _TornPushes:
    """A torn wire: the sender digests the full payload, the store rejects
    the truncated bytes and keeps its previous verified copy."""

    def __init__(self, store, good: int, blob_digest):
        self.store, self.good, self.count = store, good, 0
        self.blob_digest = blob_digest

    def push(self, identity, step, blob, extras=None):
        self.count += 1
        digest = self.blob_digest(bytes(blob))
        if self.count > self.good:
            blob = blob[:len(blob) // 2]
        try:
            self.store.put(identity, step, blob, digest=digest)
            return True
        except ValueError:
            return False

    def fetch(self, identity):
        return self.store.fetch(identity)


def _truncated(P, served, caplog):
    prompts, budgets = workload(seed=17, lengths=(6, 5), budgets=(12, 5))
    refs = refs_for(served, prompts, budgets)
    store = P.MemStore()
    build = build_for(P, served, rows=1)     # r1 must queue
    replica = P.ServingReplica(
        build, identity='torn',
        client=_TornPushes(store, 2, P.blob_digest), cadence=1)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica.submit(P.Request(f'r{index}', prompt, budget))
    caplog.clear()
    with caplog.at_level(logging.WARNING, f'{P.root}.serve.failover'):
        for _ in range(6):                        # kill at tick 6
            replica.step()
    assert 'journal replication' in caplog.text   # degraded, not crashed
    held = store.fetch(P.journal_identity('torn'))
    assert held.step == 2                         # old verified copy stands
    relaunched = P.ServingReplica(build, identity='torn', client=store,
                                  cadence=1)
    assert relaunched.recovered
    assert relaunched.report.replayed == ['r0']
    assert relaunched.report.resubmitted == ['r1']
    assert len(relaunched.scheduler.journal.rows['r0'].emitted) == 3
    results = relaunched.run_until_idle()
    for index in range(2):
        assert results[f'r{index}'].tokens == refs[index]
    return plain(results, seconds=False)


@pytest.mark.slow
def test_truncated_replication_degrades_to_cold_resubmit(served, caplog):
    twin(_truncated, served, caplog=caplog)


def _unrecoverable(P, served):
    build = build_for(P, served)
    replica = P.ServingReplica(build, identity='fresh', client=P.MemStore())
    assert not replica.recovered and replica.report.replayed == []
    prompts, budgets = workload(seed=19, lengths=(4,), budgets=(5,))
    replica.submit(P.Request('only', prompts[0], budgets[0]))
    results = replica.run_until_idle()
    assert results['only'].tokens == served.generate(prompts[0], budgets[0])
    return plain(results, seconds=False)


def test_unrecoverable_journal_serves_fresh_traffic(served):
    twin(_unrecoverable, served)


def _adopts(P, served):
    prompts, budgets = workload(seed=23)
    refs = refs_for(served, prompts, budgets)
    store_a = P.MemStore()
    build = build_for(P, served)
    replica_a = P.ServingReplica(build, identity='A', client=store_a,
                                 cadence=1)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica_a.submit(P.Request(f'a{index}', prompt, budget))
    for _ in range(3):
        replica_a.step()
    replica_b = P.ServingReplica(build, identity='B', client=P.MemStore(),
                                 cadence=1)
    assert not replica_b.recovered
    b_prompt, b_budget = prompts[0][::-1], 6
    replica_b.submit(P.Request('b0', b_prompt, b_budget))
    replica_b.step()
    recovered = P.recover_journal('A', (store_a,))
    assert recovered is not None
    tick, rows = recovered
    report = P.replay(replica_b.scheduler, rows)
    assert set(report.replayed) == {'a0', 'a1'}
    assert report.resubmitted == ['a2']
    results = replica_b.run_until_idle()
    for index in range(3):
        got = results[f'a{index}']
        assert got.tokens == refs[index], f'a{index} diverged'
        assert got.reason == 'length'
    assert results['b0'].tokens == served.generate(b_prompt, b_budget)
    assert set(replica_b.scheduler.journal.rows) == set()
    return (tick, [(r.id, emitted) for r, _, emitted in rows],
            plain(results, seconds=False))


def test_replica_b_adopts_replica_a_journal_token_exact(served):
    twin(_adopts, served)


def test_restore_rejects_finished_rows(served):
    scheduler = build_for(PORT, served)()
    with pytest.raises(ValueError, match='no business in the journal'):
        scheduler.restore(Request('done', [1, 2], 3), prefix=[5, 6, 7])


def _past_deadline(P, served):
    clock = FakeClock()
    scheduler = build_for(P, served, clock=clock)()
    report = P.replay(scheduler,
                      [(P.Request('late', [1, 2, 3], 6, deadline=5.0), 9.0,
                        [7, 7])])
    assert report.replayed == ['late']
    tick = scheduler.step()
    assert [(completion.request.id, where)
            for completion, where in tick.expired] == [('late', 'queued')]
    late = scheduler.results['late']
    assert late.reason == 'expired'
    assert late.tokens == [7, 7]                  # partial output survives
    assert late.seconds >= 9.0
    return plain(scheduler.results)


def test_replayed_request_past_deadline_expires_truthfully(served):
    twin(_past_deadline, served)


# ---------------------------------------------------------------------------
# test_serve_sampling.py: replay of sampled rows
# ---------------------------------------------------------------------------


SAMPLED = dict(seed=11, temperature=0.9, top_k=16, top_p=0.95)


def _kill_mid_sample(P, served):
    rng = np.random.default_rng(17)
    prompts = [list(rng.integers(0, 256, (n,))) for n in (6, 5)]
    specs = [('samp', prompts[0], 8, P.SamplingParams(**SAMPLED)),
             ('greedy', prompts[1], 6, None)]
    build = build_for(P, served)
    uninterrupted = build()
    for rid, prompt, budget, sampling in specs:
        uninterrupted.submit(P.Request(rid, prompt, budget,
                                       sampling=sampling))
    refs = {rid: c.tokens for rid, c in uninterrupted.run().items()}
    store = P.MemStore()
    replica = P.ServingReplica(build, identity='drill', client=store,
                               cadence=1)
    for rid, prompt, budget, sampling in specs:
        replica.submit(P.Request(rid, prompt, budget, sampling=sampling))
    for _ in range(3):
        replica.step()
    relaunched = P.ServingReplica(build, identity='drill', client=store,
                                  cadence=1)
    assert relaunched.recovered
    assert 'samp' in relaunched.report.replayed        # hot, mid-stream
    results = relaunched.run_until_idle()
    for rid, _prompt, _budget, _sampling in specs:
        assert results[rid].tokens == refs[rid], f'{rid} diverged'
        assert results[rid].reason == 'length'
    return plain(results, seconds=False)


def test_kill_mid_sample_replay_is_bitwise(served):
    twin(_kill_mid_sample, served)


def test_pre_sampling_journal_blob_reads_as_greedy(served):
    """A journal packed before sampling existed (its requests carry no
    ``sampling`` attribute) unpacks as greedy and replays token-exact."""
    prompt = list(np.random.default_rng(19).integers(0, 256, (5,)))
    ref = served.generate(prompt, 6)
    request = Request('old', prompt, 6)
    del request.__dict__['sampling']       # the pre-sampling pickle shape
    payload = pickle.dumps((4, [(request, 2.5, list(ref[:2]))]),
                           protocol=pickle.HIGHEST_PROTOCOL)
    blob = _blob_digest(payload).encode('ascii') + b':' + payload
    tick, rows = RequestJournal.unpack(blob)
    assert tick == 4
    restored = rows[0][0]
    assert 'sampling' in vars(restored) and restored.sampling is None
    scheduler = Scheduler(served.engine(PORT, rows=1, block_size=8))
    report = replay(scheduler, rows)
    assert report.replayed == ['old']
    assert scheduler.run()['old'].tokens == ref


# ---------------------------------------------------------------------------
# the step watchdog: hung/slow decode becomes a typed verdict + relaunch
# ---------------------------------------------------------------------------


class FakeTimer:
    """A ``threading.Timer`` stand-in: records, never fires by itself."""
    instances: list = []

    def __init__(self, interval, function):
        self.interval, self.function = interval, function
        self.cancelled = False
        FakeTimer.instances.append(self)

    def start(self):
        pass

    def cancel(self):
        self.cancelled = True


class TestWatchdog:

    def test_absolute_stall_threshold(self):
        dog = StepWatchdog(stall_after=2.0, slow_factor=None)
        dog.observe(1.99)
        with pytest.raises(EngineStalled, match='stall') as caught:
            dog.observe(2.0)
        assert caught.value.seconds == 2.0

    def test_ema_slow_verdict_is_warmup_gated_and_unpolluted(self):
        dog = StepWatchdog(slow_factor=4.0, warmup=3, floor=0.0)
        dog.observe(8.0)
        for _ in range(5):
            dog.observe(1.0)
        with pytest.raises(EngineStalled, match='slow'):
            dog.observe(dog.ema * 4.0 + 0.01)
        healthy = dog.ema
        dog.observe(1.0)
        assert dog.ema <= healthy + 1e-9

    def test_unarmed_watchdog_is_refused(self):
        with pytest.raises(ValueError, match='unarmed'):
            StepWatchdog(stall_after=None, slow_factor=None)

    def test_deadman_guard_arms_and_cancels(self):
        fired = []
        FakeTimer.instances = []
        dog = StepWatchdog(stall_after=1.5, slow_factor=None,
                           on_stall=lambda: fired.append(True),
                           timer=FakeTimer)
        with dog.guard():
            pass                      # the step returned in time
        (timer,) = FakeTimer.instances
        assert timer.interval == 1.5 and timer.cancelled and not fired
        timer.function()              # what a real expiry would run
        assert fired == [True]
        with pytest.raises(ValueError, match='stall_after'):
            StepWatchdog(slow_factor=2.0).guard()

    @pytest.mark.slow
    def test_stalled_step_fires_relaunch_and_replay_token_exact(
            self, served):
        def scenario(P, served):
            prompts, budgets = workload(seed=23, lengths=(5, 8),
                                        budgets=(9, 6))
            refs = refs_for(served, prompts, budgets)
            clock = FakeClock()
            producer = P.Producer()
            witnessed = witness(P, producer, 'EngineRestarted',
                                'RequestReplayed')
            replica = P.ServingReplica(
                build_for(P, served, clock=clock),
                identity='stall', client=P.MemStore(), cadence=1,
                watchdog=P.StepWatchdog(stall_after=5.0, slow_factor=None),
                producer=producer, clock=clock,
                fault=P.StalledStep(tick=3,
                                    action=lambda: clock.advance(10.0)))
            for index, (prompt, budget) in enumerate(zip(prompts,
                                                         budgets)):
                replica.submit(P.Request(f'r{index}', prompt, budget))
            results = replica.run_until_idle()
            assert replica.relaunches == 1
            for index in range(2):
                assert results[f'r{index}'].tokens == refs[index]
            restarts = [e for e in witnessed
                        if type(e).__name__ == 'EngineRestarted']
            assert [e.cause for e in restarts] == ['stalled']
            assert restarts[0].replayed == 2
            replayed = {e.id: e for e in witnessed
                        if type(e).__name__ == 'RequestReplayed'}
            assert set(replayed) == {'r0', 'r1'}
            assert all(e.where == 'hot' and e.prefix > 0
                       for e in replayed.values())
            return plain(results), plain(witnessed)
        twin(scenario, served)


def test_replica_deadman_arms_each_watched_tick(served):
    FakeTimer.instances = []
    replica = ServingReplica(
        build_for(PORT, served, rows=1), identity='deadman',
        watchdog=StepWatchdog(stall_after=30.0, slow_factor=None,
                              timer=FakeTimer),
        deadman=True)
    replica.submit(Request('only', [1, 2, 3, 4], 3))
    replica.run_until_idle()
    ticks = replica.scheduler.steps
    assert len(FakeTimer.instances) == ticks - 1    # build tick exempt
    assert all(timer.cancelled and timer.interval == 30.0
               for timer in FakeTimer.instances)
    with pytest.raises(ValueError, match='deadman'):
        ServingReplica(build_for(PORT, served), deadman=True)


def test_replica_refuses_a_mismatched_scheduler_clock(served):
    clock = FakeClock()
    with pytest.raises(ValueError, match='share one clock'):
        ServingReplica(build_for(PORT, served), clock=clock)
    with pytest.raises(ValueError, match='share one clock'):
        ServingReplica(build_for(PORT, served, clock=clock))


def _clientless(P, served):
    prompts, budgets = workload(seed=37, lengths=(5, 4), budgets=(8, 5))
    refs = refs_for(served, prompts, budgets)
    clock = FakeClock()
    replica = P.ServingReplica(
        build_for(P, served, rows=1, clock=clock),
        identity='ramonly', clock=clock,
        watchdog=P.StepWatchdog(stall_after=5.0, slow_factor=None),
        fault=P.StalledStep(tick=3, action=lambda: clock.advance(10.0)))
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica.submit(P.Request(f'r{index}', prompt, budget))
    results = replica.run_until_idle()
    assert replica.relaunches == 1
    assert set(replica.report.replayed + replica.report.resubmitted) \
        == {'r0', 'r1'}
    for index in range(2):
        assert results[f'r{index}'].tokens == refs[index]
    return plain(results), replica.report.replayed


def test_clientless_relaunch_replays_from_the_live_journal(served):
    twin(_clientless, served)


def test_engine_exposes_decode_step_wall_seconds(served):
    engine = served.engine(PORT, rows=1, block_size=8)
    assert engine.last_step_seconds == 0.0
    engine.admit(np.arange(1, 5), max_new=3)
    engine.step()
    assert engine.last_step_seconds > 0.0


# ---------------------------------------------------------------------------
# admission control: bounded backlog + watermark shedding by deadline slack
# ---------------------------------------------------------------------------


class TestAdmissionControl:

    def test_max_queued_typed_rejection(self, served):
        engine = served.engine(PORT, rows=1, block_size=8)
        scheduler = Scheduler(engine, max_queued=2)
        for index in range(2):
            scheduler.submit(Request(f'q{index}', [1, 2, 3], 4))
        with pytest.raises(QueueFull, match='max_queued=2'):
            scheduler.submit(Request('q2', [1, 2, 3], 4))
        assert Scheduler(engine).max_queued is None
        with pytest.raises(ValueError, match='max_queued'):
            Scheduler(engine, max_queued=0)

    def test_watermark_validation(self):
        with pytest.raises(ValueError, match='watermarks'):
            Watermarks(high=2, low=3)
        with pytest.raises(ValueError, match='watermarks'):
            Watermarks(high=0, low=0)
        assert Watermarks(high=4, low=2).excess(7) == 5
        assert Watermarks(high=4, low=2).excess(4) == 0

    def test_shed_by_deadline_slack_spares_active_rows(self, served):
        def scenario(P, served):
            clock = FakeClock()
            prompts, _ = workload(seed=29, lengths=(5,), budgets=(10,))
            engine = served.engine(P, rows=1, block_size=8)
            scheduler = P.Scheduler(engine, clock=clock,
                                    watermarks=P.Watermarks(high=2, low=1))
            scheduler.submit(P.Request('active', prompts[0], 10,
                                       deadline=0.5))
            scheduler.step()
            scheduler.submit(P.Request('soon', [1, 2, 3], 4, deadline=1.0))
            scheduler.submit(P.Request('later', [1, 2, 3], 4,
                                       deadline=60.0))
            scheduler.submit(P.Request('forever', [1, 2, 3], 4))
            tick = scheduler.step()                    # depth 3 > high 2
            shed = [(completion.request.id, slack)
                    for completion, slack in tick.shed]
            assert shed == [('soon', 1.0), ('later', 60.0)]
            assert scheduler.results['soon'].reason == 'shed'
            assert scheduler.backpressure
            assert scheduler.queue_depth == 1          # 'forever' survived
            tick = scheduler.step()                    # depth 1 <= low
            assert not tick.shed and not scheduler.backpressure
            results = scheduler.run()
            assert results['active'].tokens == served.generate(prompts[0],
                                                               10)
            assert results['forever'].reason == 'length'
            return plain(results)
        twin(scenario, served)

    def test_no_deadline_sheds_newest_first(self, served):
        clock = FakeClock()
        engine = served.engine(PORT, rows=1, block_size=8)
        scheduler = Scheduler(engine, clock=clock,
                              watermarks=Watermarks(high=2, low=2))
        scheduler.submit(Request('seated', [1, 2, 3], 20))
        scheduler.step()
        for name in ('old', 'mid', 'new'):
            scheduler.submit(Request(name, [1, 2, 3], 4))
            clock.advance(1.0)
        tick = scheduler.step()
        assert [completion.request.id
                for completion, _ in tick.shed] == ['new']
        assert tick.shed[0][1] is None             # no deadline, no slack
        assert {'old', 'mid'} <= {p.request.id for p in scheduler._queue}

    def test_service_narrates_loadshed_and_backpressure(self, served):
        def scenario(P, served):
            clock = FakeClock()
            producer = P.Producer()
            witnessed = witness(P, producer, 'LoadShed', 'Backpressure')
            service = served.service(P, producer=producer, rows=1,
                                     block_size=8, clock=clock,
                                     watermarks=P.Watermarks(high=1, low=0))
            service.submit(P.Request('seated', [1, 2, 3], 30))
            service.step()
            service.submit(P.Request('q1', [1, 2, 3], 4, deadline=2.0))
            service.submit(P.Request('q2', [1, 2, 3], 4))
            service.step()                             # sheds both
            sheds = [e for e in witnessed if type(e).__name__ == 'LoadShed']
            assert [e.id for e in sheds] == ['q1', 'q2']
            assert sheds[0].slack == 2.0 and sheds[1].slack is None
            assert all(e.queue_depth == 2 for e in sheds)
            flags = [e for e in witnessed
                     if type(e).__name__ == 'Backpressure']
            assert [e.engaged for e in flags] == [True]
            assert flags[0].queue_depth == 2
            service.step()                             # releases
            flags = [e for e in witnessed
                     if type(e).__name__ == 'Backpressure']
            assert [e.engaged for e in flags] == [True, False]
            service.cancel('seated')
            return plain(witnessed)
        twin(scenario, served)


# ---------------------------------------------------------------------------
# the injectable clock: deadline/expiry edges with zero real sleeps
# ---------------------------------------------------------------------------


def test_deadline_expiry_runs_on_the_fake_clock(served):
    clock = FakeClock()
    engine = served.engine(PORT, rows=1, block_size=8)
    scheduler = Scheduler(engine, clock=clock)
    scheduler.submit(Request('hog', [1, 2, 3, 4], 10))
    scheduler.submit(Request('starved', [1, 2, 3, 4], 4, deadline=5.0))
    tick = scheduler.step()
    assert tick.queue_depth == 1 and not tick.expired
    clock.advance(5.0)
    tick = scheduler.step()
    assert [(completion.request.id, where)
            for completion, where in tick.expired] == [('starved', 'queued')]
    assert scheduler.results['starved'].seconds == 5.0


def _same_tick_cancel(P, served):
    engine = served.engine(P, rows=1, block_size=8)
    scheduler = P.Scheduler(engine)
    scheduler.submit(P.Request('a', [1, 2, 3, 4], 3))
    scheduler.step()                   # admit emits token 1, decode token 2
    tick = scheduler.step()            # token 3: completes
    assert [completion.request.id
            for completion in tick.completed] == ['a']
    assert scheduler.cancel('a') is None
    assert scheduler.results['a'].reason == 'length'
    assert engine.free_rows == 1
    scheduler.submit(P.Request('b', [1, 2, 3], 1))   # done at admission
    tick = scheduler.step()
    assert tick.completed[0].request.id == 'b'
    assert scheduler.cancel('b') is None
    assert scheduler.results['b'].reason == 'length'
    return plain(scheduler.results, seconds=False)


def test_cancel_landing_the_same_tick_as_completion(served):
    twin(_same_tick_cancel, served)


def test_deadline_expiring_exactly_at_the_admission_tick(served):
    clock = FakeClock()
    engine = served.engine(PORT, rows=2, block_size=8)
    scheduler = Scheduler(engine, clock=clock)
    scheduler.submit(Request('edge', [1, 2, 3], 4, deadline=1.0))
    clock.advance(1.0)                             # exactly the deadline
    tick = scheduler.step()
    assert [(completion.request.id, where)
            for completion, where in tick.expired] == [('edge', 'queued')]
    assert scheduler.results['edge'].tokens == []
    assert not tick.admitted and engine.free_rows == 2


def _mid_prefill_expiry(P, served):
    clock = FakeClock()
    prompts, _ = workload(seed=31, lengths=(6,), budgets=(8,))
    engine = served.engine(P, rows=2, block_size=8)
    scheduler = P.Scheduler(engine, clock=clock)
    scheduler.submit(P.Request('keep', prompts[0], 8))
    scheduler.submit(P.Request('doomed', [1, 2, 3, 4], 20, deadline=2.0))
    original_admit = engine.admit

    def slow_admit(prompt, max_new, **kwargs):
        if kwargs.get('tag') == 'doomed':          # prefill eats the slack
            clock.advance(2.0)
        return original_admit(prompt, max_new, **kwargs)

    engine.admit = slow_admit
    tick = scheduler.step()                        # both seated
    assert len(tick.admitted) == 2 and not tick.expired
    tick = scheduler.step()
    assert [(completion.request.id, where)
            for completion, where in tick.expired] == [('doomed', 'active')]
    doomed = scheduler.results['doomed']
    assert doomed.reason == 'expired'
    assert 1 <= len(doomed.tokens) < 20
    engine.admit = original_admit
    results = scheduler.run()
    assert results['keep'].tokens == served.generate(prompts[0], 8)
    return plain(results)


def test_expiry_of_a_request_whose_row_is_mid_prefill(served):
    twin(_mid_prefill_expiry, served)


def test_memstore_slots_read_corruption_as_absent(caplog):
    """The port's ``MemStore``: monotonic slots, a digest checked on
    arrival and on every read (a corrupt slot reads as absent)."""
    store = MemStore()
    store.put('x', 5, b'five')
    assert store.put('x', 3, b'three').step == 5     # never regresses
    with pytest.raises(ValueError, match='digest'):
        store.put('x', 6, b'six', digest=blob_digest(b'other'))
    entry = store.fetch('x')
    assert entry.blob == b'five' and entry.digest == blob_digest(b'five')
    entry.blob = b'fivX'
    with caplog.at_level(logging.WARNING, 'tpusystem_torch.memstore'):
        assert store.fetch('x') is None
    assert 'digest' in caplog.text and store.identities() == []


# ---------------------------------------------------------------------------
# bf16 replay: the reference's design and the port's, side by side
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def bf16_pair():
    """``gpt2_tiny`` in bfloat16 in both packages, on the same weights."""
    import jax
    import jax.numpy as jnp

    from tpusystem.models import gpt2_tiny as reference_tiny
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import gpt2_tiny
    reference = reference_tiny(dtype='bfloat16')
    prompt = jnp.asarray(np.random.default_rng(0).integers(0, 256, (1, 8)),
                         jnp.int32)
    params = reference.init(jax.random.PRNGKey(0), prompt)['params']
    port = gpt2_tiny(dtype='bfloat16', device='cpu')
    port.load_state_dict(params_from_jax(params))
    return {REF.root: (reference, params),
            PORT.root: (port, params_from_jax(params))}


def _bf16_streams(P, pair, kill_tick):
    """Eight seeded sampled requests (temperature 0.8) through ``P``'s
    journaled replica; with ``kill_tick`` the replica is dropped after that
    many ticks and a relaunched one replays its journal."""
    module, params = pair[P.root]
    knobs = dict(rows=4, block_size=8)
    if P is PORT:
        knobs['device'] = 'cpu'
    build = lambda: P.Scheduler(P.Engine(module, params, **knobs))
    store = P.MemStore()
    replica = P.ServingReplica(build, identity='bf16', client=store,
                               cadence=1)
    rng = np.random.default_rng(5)
    for index in range(8):
        prompt = rng.integers(0, 256, (int(rng.integers(4, 12)),)).tolist()
        replica.submit(P.Request(f'r{index}', prompt, 24,
                                 sampling=P.SamplingParams(
                                     seed=100 + index, temperature=0.8)))
    if kill_tick is not None:
        for _ in range(kill_tick):
            replica.step()
        replica = P.ServingReplica(build, identity='bf16', client=store,
                                   cadence=1)
        assert replica.recovered
    return {name: [int(token) for token in completion.tokens]
            for name, completion in replica.run_until_idle().items()}


def test_bf16_replay_is_token_exact_on_the_cpu_in_both_packages(bf16_pair):
    """The open question of the card's bf16 replay (a replayed row
    re-prefills ``prompt + prefix``, where the uninterrupted run made the
    prefix's KV one decode step at a time): on the CPU in bfloat16 the
    reference's kill-and-replay and the port's are both token-exact
    against each package's own uninterrupted run, at the same kill tick,
    so the port's replay departs from the reference's nowhere the
    reference can be run. The fork on the card comes from the card's
    decode products (next test)."""
    for P in BOTH:
        whole = _bf16_streams(P, bf16_pair, None)
        replayed = _bf16_streams(P, bf16_pair, 12)
        assert replayed == whole, P.root


def test_bf16_prefill_and_decode_make_the_same_kv_on_the_cpu(bf16_pair):
    """Why replay holds on the CPU: in both packages a prefill of twelve
    tokens and a prefill of six followed by six one-token decode steps
    leave the same bfloat16 cache, bit for bit. Replay is token-exact
    exactly when this holds; on the card the decode products run through
    the decode matmul kernel, whose sums are ordered otherwise than the
    prefill's, so the caches (and then the streams) may part."""
    import jax
    import jax.numpy as jnp
    tokens = np.random.default_rng(0).integers(0, 256, (1, 12))
    reference, params = bf16_pair[REF.root]
    decoder = reference.clone(decode=True)

    def reference_cache(split):
        cache = decoder.init(jax.random.PRNGKey(0),
                             jnp.asarray(tokens[:, :split]))['cache']
        for start, stop in [(0, split)] + [(at, at + 1)
                                           for at in range(split, 12)]:
            _, mutated = decoder.apply(
                {'params': params, 'cache': cache},
                jnp.asarray(tokens[:, start:stop]), mutable=['cache'])
            cache = mutated['cache']
        return [np.asarray(leaf) for leaf in jax.tree.leaves(cache)]

    for whole, split in zip(reference_cache(12), reference_cache(6)):
        np.testing.assert_array_equal(whole, split)
    port = bf16_pair[PORT.root][0].replace(decode=True)

    def port_cache(split):
        ids = torch.from_numpy(tokens)
        with torch.no_grad():
            _, cache = port(ids[:, :split])
            for at in range(split, 12):
                _, cache = port(ids[:, at:at + 1], cache)
        return cache

    whole, split = port_cache(12), port_cache(6)
    assert whole.keys() == split.keys()
    for name in whole:
        assert torch.equal(whole[name], split[name]), name


# ---------------------------------------------------------------------------
# observability: the failover events chart like everything else
# ---------------------------------------------------------------------------


def test_tensorboard_failover_handlers_chart_the_events(tmp_path):
    from tests.tb import read_scalars
    from tpusystem_torch.observe.events import (Backpressure,
                                                EngineRestarted, LoadShed)
    from tpusystem_torch.observe.tensorboard import (SummaryWriter,
                                                     tensorboard_consumer,
                                                     writer)

    consumer = tensorboard_consumer()
    board = SummaryWriter(tmp_path)
    consumer.dependency_overrides[writer] = lambda: board
    consumer.consume(EngineRestarted(cause='stalled', replayed=2,
                                     resubmitted=1, seconds=0.8))
    consumer.consume(LoadShed(id='r9', produced=0, queue_depth=7,
                              slack=-0.5))
    consumer.consume(Backpressure(engaged=True, queue_depth=7))
    board.flush()
    scalars = read_scalars(tmp_path)        # parsed back, not byte-poked
    value, step = scalars['serve/recovery_seconds']
    assert value == pytest.approx(0.8) and step == 1    # restart counter
    assert scalars['serve/replayed'] == (2.0, 1)
    assert scalars['serve/resubmitted'] == (1.0, 1)
    assert scalars['serve/shed'] == (7.0, 1)            # triggering depth
    value, _ = scalars['serve/shed_slack']
    assert value == pytest.approx(-0.5)
    assert scalars['serve/backpressure'] == (1.0, 1)


# ---------------------------------------------------------------------------
# the real thing: SIGKILL under the Supervisor (subprocess drill)
# ---------------------------------------------------------------------------

# the port's serving worker: the reference drill's (``__graft_entry__.py``
# ``_SERVE_FAILOVER_WORKER``) on the port, ``gpt2_tiny`` in float32 on the
# CPU with the port's seeded weights
SERVE_FAILOVER_WORKER = r'''
import json, os, signal, sys
results_path, die_tick = sys.argv[1], int(sys.argv[2])
import torch
torch.set_num_threads(1)
from tpusystem_torch.checkpoint import supervisor_client
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.observe import FlightRecorder
from tpusystem_torch.observe.events import RequestReplayed
from tpusystem_torch.serve import (Engine, Request, SamplingParams,
                                   Scheduler, ServingReplica)
from tpusystem_torch.services.prodcon import Producer
import numpy as np

module = gpt2_tiny(dtype='float32', device='cpu')
rng = np.random.default_rng(5)
prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9, 7)]
budgets = [12, 10, 8]
# r1 decodes seeded-sampled: the replay must land its threefry counters
# on the same (seed, position) pairs or the drill diverges bitwise
sampling = [None,
            SamplingParams(seed=7, temperature=0.9, top_k=16, top_p=0.95),
            None]

client = supervisor_client()        # None on the unsupervised reference run
recorder = FlightRecorder.from_env()   # black box at TPUSYSTEM_FLIGHT
producer = Producer()
replays = []
producer.taps.append(lambda event: replays.append(event)
                     if isinstance(event, RequestReplayed) else None)
build = lambda: Scheduler(Engine(module, None, rows=2, block_size=8,
                                 device='cpu'))
replica = ServingReplica(build, identity='serve-drill', client=client,
                         cadence=1, recorder=recorder, producer=producer)
if not replica.recovered:           # the relaunch must NOT double-submit
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        replica.submit(Request(f'r{index}', prompt, budget,
                               sampling=sampling[index]))
while not replica.idle:
    replica.step()
    if die_tick and not replica.recovered \
            and replica.scheduler.steps == die_tick:
        os.kill(os.getpid(), signal.SIGKILL)     # mid-decode, no cleanup
results = replica.run_until_idle()
report = replica.report
json.dump({
    'results': {rid: completion.tokens for rid, completion in
                results.items()},
    'reasons': {rid: completion.reason for rid, completion in
                results.items()},
    'recovered': replica.recovered,
    'replayed': len(report.replayed), 'resubmitted': len(report.resubmitted),
    'replay_prefixes': {event.id: event.prefix for event in replays},
}, open(results_path, 'w'))
'''


def _postmortem_prefixes(postmortem: dict) -> dict:
    """Each still-live request's emitted-token count from a post-mortem's
    tick entries (admission token + decode emissions, finished rows
    dropped): the journal's evidence, from an independent artifact."""
    prefixes: dict[str, int] = {}
    for entry in postmortem['entries']:
        if entry.get('kind') != 'tick':
            continue
        for rid in entry.get('admitted', {}):
            prefixes[rid] = prefixes.get(rid, 0) + 1
        for rid in entry.get('emitted', {}):
            prefixes[rid] = prefixes.get(rid, 0) + 1
        for rid in entry.get('completed', []):
            prefixes.pop(rid, None)
    return prefixes


@pytest.mark.slow
def test_sigkill_subprocess_drill_under_supervisor(tmp_path):
    """A serving worker subprocess SIGKILLs itself mid-decode, the port's
    Supervisor relaunches it (signal death = worker-lost), the relaunch
    recovers the journal from the supervisor's memstore and finishes:
    completions token-exact against an uninterrupted run of the same
    worker, and the worker's flight-recorder post-mortem (write-ahead
    ring, read back by the supervisor onto ``WorkerExited``) reconstructs
    exactly the emitted prefixes the journal replay re-prefilled."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from tpusystem_torch.observe.events import WorkerExited
    from tpusystem_torch.parallel.supervisor import Supervisor

    die_tick = 4                     # mid-decode: rows seated, queue live
    worker = tmp_path / 'serve_worker.py'
    worker.write_text(SERVE_FAILOVER_WORKER)
    env = {'PYTHONPATH': str(pathlib.Path(__file__).resolve().parents[1])}
    reference_path = tmp_path / 'reference.json'
    subprocess.run([sys.executable, str(worker), str(reference_path), '0'],
                   env={**os.environ, **env}, check=True, timeout=300)
    reference = json.loads(reference_path.read_text())
    assert not reference['recovered']

    drilled_path = tmp_path / 'drilled.json'
    exits = []

    class _Bus:                      # collect WorkerExited + postmortems
        def dispatch(self, event):
            exits.append(event)

    supervisor = Supervisor(
        [sys.executable, str(worker), str(drilled_path), str(die_tick)],
        env=env, backoff_base=0.05, backoff_cap=0.2,
        crash_loop_window=0.0, producer=_Bus(),
        flight_path=str(tmp_path / 'flight.json'))
    assert supervisor.run() == 0
    assert supervisor.restarts == 1
    drilled = json.loads(drilled_path.read_text())
    assert drilled['recovered'], 'relaunch never recovered the journal'
    assert drilled['replayed'] >= 1, drilled
    assert drilled['results'] == reference['results']
    assert drilled['reasons'] == reference['reasons']
    assert drilled['replay_prefixes'].get('r1'), (
        'sampled request r1 was not mid-stream at the kill',
        drilled['replay_prefixes'])
    relaunch = next(event for event in exits
                    if isinstance(event, WorkerExited)
                    and event.action == 'relaunch')
    assert relaunch.postmortem is not None, 'no post-mortem attached'
    live = _postmortem_prefixes(relaunch.postmortem)
    expected = {rid: prefix
                for rid, prefix in drilled['replay_prefixes'].items()
                if prefix}
    assert {rid: n for rid, n in live.items() if n} == expected, (
        live, drilled['replay_prefixes'])
