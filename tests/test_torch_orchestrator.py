"""The port's orchestrator (``tpusystem_torch/orchestrator/*`` and
``parallel/chaos.pick_tenant_chaos``), held to the reference's tests.

Every test of ``tests/test_orchestrator.py``, twinned on the port's
modules (its ``witness`` is ``tests/torch_serving.py``'s, on the port's
events). Then the port's own: ``pick_tenant_chaos`` draws the reference's
picks for the same seeds, and ``certify_tenants`` gives the reference's
report (victim, tick, non-victim outputs, verdicts) for the same seeds
over the same scripted tenants built from either package.

The reference's layout:

Same two-tier discipline as the serve drills:

* **Wire + policy** — scoped consumers and tenant buses on one shared
  Producer (the ``evaluation_consumer(subject=)`` guard generalized),
  the carve planner, JobSpec validation, the orchestrator journal's
  corrupt-reads-as-absent framing. Zero sleeps, zero processes.
* **Arbitration** — a burst shrinks the lowest-priority elastic tenant
  through its resize seam and the ebb pays the debt back; the decision
  is journaled two-phase, so an orchestrator SIGKILL mid-arbitration
  recovers and COMPLETES the in-flight resize instead of re-deciding.
* **Cross-tenant chaos** — :func:`certify_tenants` over fixed seeds:
  a seeded (tenant × component × kill-tick) draw dies and every
  non-victim tenant's outputs stay bitwise-identical to an undisturbed
  twin while the victim recovers or degrades typed.
"""

import pytest

from tests.torch_serving import PORT
from tests.torch_serving import witness as package_witness
from tpusystem_torch.checkpoint.memstore import MemStore
from tpusystem_torch.observe.events import (AnomalyDetected,
                                            CapacityArbitrated, JobAdmitted,
                                            JobHalted, JobPreempted,
                                            RequestAdmitted, RequestCompleted,
                                            Trained)
from tpusystem_torch.orchestrator import (CapacityError, JobSpec, LeakAudit,
                                          NamespacedWriter, Orchestrator,
                                          OrchestratorJournal, Submesh,
                                          TenantBus, carve, certify_tenants,
                                          orchestrator_identity,
                                          recover_orchestrator_journal, scoped,
                                          subject_of)
from tpusystem_torch.parallel.chaos import pick_tenant_chaos
from tpusystem_torch.parallel.recovery import (CRASH_LOOP_EXIT,
                                               DIVERGED_EXIT,
                                               LOST_WORKER_EXIT, RESIZED_EXIT)
from tpusystem_torch.serve.failover import JournalCorrupt
from tpusystem_torch.services.prodcon import Consumer, Producer


def witness(producer, *event_types):
    """The port's events of ``event_types`` dispatched on ``producer``."""
    return package_witness(PORT, producer, *event_types)


class FakeRunner:
    """The orchestrator's runner seam, scripted: ``code`` is what poll
    reports; every resize records the new device tuple."""

    def __init__(self, code=None):
        self.code = code
        self.resizes = []

    def poll(self):
        return self.code

    def resize(self, devices):
        self.resizes.append(tuple(devices))


class RecordingBoard:
    """SummaryWriter stand-in collecting (tag, value, step) rows."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, value, step))

    def add_scalars(self, tag, values, step):
        for name, value in values.items():
            self.rows.append((f'{tag}/{name}', value, step))

    def flush(self):
        pass

    close = flush


class Model:
    def __init__(self, identity, epoch=1):
        self.id = identity
        self.epoch = epoch


# ---------------------------------------------------------------------------
# namespaces: the blast-radius isolation wire
# ---------------------------------------------------------------------------


class TestNamespace:

    def test_subject_resolution_order(self):
        event = Trained(Model('m1'), {'loss': 0.5})
        assert subject_of(event) == 'm1'             # model.id convention
        event.tenant = 'job-a'
        assert subject_of(event) == 'job-a'          # the stamp wins
        bare = RequestCompleted(id='r', produced=3, reason='length',
                                seconds=0.1)
        assert subject_of(bare) is None              # unattributed

    def test_scoped_consumer_drops_foreign_and_unattributed(self):
        seen = []
        inner = Consumer('probe')
        inner.register(RequestCompleted, seen.append)
        consumer = scoped(inner, 'job-a')
        mine = RequestCompleted(id='a', produced=1, reason='length',
                                seconds=0.1)
        mine.tenant = 'job-a'
        theirs = RequestCompleted(id='b', produced=1, reason='length',
                                  seconds=0.1)
        theirs.tenant = 'job-b'
        bare = RequestCompleted(id='c', produced=1, reason='length',
                                seconds=0.1)
        for event in (mine, theirs, bare):
            consumer.consume(event)
        assert [event.id for event in seen] == ['a']

    def test_tenant_bus_stamps_and_isolates_two_jobs(self):
        """Two jobs on ONE shared Producer: each bus stamps its tenant
        at dispatch and scopes its consumers, so neither job's events
        ever fire the other's handlers — while an unscoped tap on the
        shared producer still witnesses the whole stream."""
        producer = Producer()
        tap = witness(producer, RequestCompleted)
        buses = {name: TenantBus(producer, name) for name in ('a', 'b')}
        seen = {name: [] for name in ('a', 'b')}
        for name, bus in buses.items():
            consumer = Consumer(f'job-{name}')
            consumer.register(RequestCompleted, seen[name].append)
            bus.register(consumer)
        buses['a'].dispatch(RequestCompleted(id='a1', produced=1,
                                             reason='length', seconds=0.1))
        buses['b'].dispatch(RequestCompleted(id='b1', produced=1,
                                             reason='length', seconds=0.1))
        assert [event.id for event in seen['a']] == ['a1']
        assert [event.id for event in seen['b']] == ['b1']
        assert [event.id for event in tap] == ['a1', 'b1']

    def test_tenant_bus_refuses_to_restamp_a_foreign_event(self):
        producer = Producer()
        event = RequestCompleted(id='x', produced=1, reason='length',
                                 seconds=0.1)
        TenantBus(producer, 'a').dispatch(event)
        with pytest.raises(ValueError, match='refusing to re-stamp'):
            TenantBus(producer, 'b').dispatch(event)
        with pytest.raises(ValueError, match='non-None tenant'):
            TenantBus(producer, None)

    def test_leak_audit_records_foreign_deliveries(self):
        audit = LeakAudit('a')
        mine = RequestCompleted(id='m', produced=1, reason='length',
                                seconds=0.1)
        mine.tenant = 'a'
        theirs = RequestCompleted(id='t', produced=1, reason='length',
                                  seconds=0.1)
        theirs.tenant = 'b'
        audit.consume(mine)
        audit.consume(theirs)
        assert audit.seen == 2
        assert audit.leaks == [('a', 'b', 'RequestCompleted')]

    def test_namespaced_writer_prefixes_every_tag(self):
        board = RecordingBoard()
        writer = NamespacedWriter(board, 'job-a')
        writer.add_scalar('serve/tok_s', 3.0, 7)
        writer.add_scalars('loss', {'train': 0.5}, 2)
        assert board.rows == [('job-a/serve/tok_s', 3.0, 7),
                              ('job-a/loss/train', 0.5, 2)]
        with pytest.raises(ValueError):
            NamespacedWriter(board, '')


# ---------------------------------------------------------------------------
# the satellite regression: cross-job leakage through REAL consumers
# (the evaluation_consumer subject-scope guard, generalized)
# ---------------------------------------------------------------------------


class TestCrossJobLeakage:

    def test_serve_metrics_never_ingest_a_foreign_completion(self):
        """Two models' serving stacks share one Producer: each job's
        serve-metrics consumer (scoped through its TenantBus) must
        never fold a foreign request's latency into its histograms."""
        from tpusystem_torch.observe.metrics import ServeLatency
        from tpusystem_torch.observe.metrics import serve_metrics_consumer
        from tpusystem_torch.observe import tensorboard as tensorboard_module
        producer = Producer()
        states = {name: ServeLatency() for name in ('a', 'b')}
        for name, state in states.items():
            consumer = serve_metrics_consumer(latency=state)
            board = RecordingBoard()
            consumer.dependency_overrides[tensorboard_module.writer] = (
                lambda board=board: board)
            TenantBus(producer, name).register(consumer)
        for name, count in (('a', 3), ('b', 1)):
            bus = TenantBus(producer, name)
            for index in range(count):
                bus.dispatch(RequestAdmitted(
                    id=f'{name}{index}', row=0, prompt_tokens=4,
                    ttft=0.1, queue_depth=1))
                bus.dispatch(RequestCompleted(
                    id=f'{name}{index}', produced=5, reason='length',
                    seconds=0.5))
        assert states['a'].ttft.count == 3
        assert states['b'].ttft.count == 1

    def test_sentinel_and_training_charts_never_cross_models(self):
        """The tensorboard consumer (training + sentinel charts) scoped
        per model id — the exact evaluation_consumer regression, lifted
        to the chart consumers: model B's divergence must not land on
        model A's board, and vice versa. No stamping here: the scope
        resolves through the events' own ``model.id``, so pre-existing
        events isolate without a TenantBus."""
        from tpusystem_torch.observe import tensorboard as tensorboard_module
        from tpusystem_torch.observe import tensorboard_consumer
        producer = Producer()
        boards = {}
        for identity in ('m-a', 'm-b'):
            consumer = tensorboard_consumer()
            board = boards[identity] = RecordingBoard()
            consumer.dependency_overrides[tensorboard_module.writer] = (
                lambda board=board: board)
            producer.register(scoped(consumer, identity))
        producer.dispatch(Trained(Model('m-a', epoch=2), {'loss': 0.5}))
        producer.dispatch(AnomalyDetected(Model('m-b', epoch=1), step=9,
                                          kind='spike', loss=9.0,
                                          gnorm=100.0, zscore=8.0))
        tags_a = {tag for tag, _, _ in boards['m-a'].rows}
        tags_b = {tag for tag, _, _ in boards['m-b'].rows}
        assert any(tag.startswith('m-a/') for tag in tags_a)
        assert not any('m-b' in tag for tag in tags_a)
        assert any('anomal' in tag or 'sentinel' in tag or 'm-b' in tag
                   for tag in tags_b)
        assert not any('m-a' in tag for tag in tags_b)


# ---------------------------------------------------------------------------
# specs and the carve planner
# ---------------------------------------------------------------------------


class TestCarve:

    def test_jobspec_validation_and_elasticity(self):
        spec = JobSpec('train', 'train', priority=1, chips=4, min_chips=2)
        assert spec.elastic
        pinned = JobSpec('serve', 'serve', priority=2, chips=2)
        assert pinned.min_chips == 2 and not pinned.elastic
        with pytest.raises(ValueError):
            JobSpec('', 'train', priority=1, chips=2)
        with pytest.raises(ValueError):
            JobSpec('x', 'train', priority=1, chips=0)
        with pytest.raises(ValueError):
            JobSpec('x', 'train', priority=1, chips=2, min_chips=3)

    def test_carve_is_contiguous_deterministic_priority_ordered(self):
        specs = [JobSpec('train', 'train', priority=1, chips=4, min_chips=2),
                 JobSpec('serve', 'serve', priority=3, chips=2),
                 JobSpec('eval', 'eval', priority=0, chips=1)]
        placements = carve(range(8), specs)
        assert placements['serve'].devices == (0, 1)      # highest first
        assert placements['train'].devices == (2, 3, 4, 5)
        assert placements['eval'].devices == (6,)
        assert carve(range(8), specs) == placements       # deterministic

    def test_carve_refuses_oversubscription_typed(self):
        with pytest.raises(CapacityError, match='9 chips'):
            carve(range(8), [
                JobSpec('a', 'train', priority=1, chips=5),
                JobSpec('b', 'serve', priority=2, chips=4)])
        with pytest.raises(ValueError, match='duplicate job names'):
            carve(range(8), [JobSpec('a', 'train', priority=1, chips=1),
                             JobSpec('a', 'serve', priority=2, chips=1)])
        with pytest.raises(ValueError):
            Submesh((0, 0, 1))


# ---------------------------------------------------------------------------
# the orchestrator: lifecycle, blast radius, arbitration, recovery
# ---------------------------------------------------------------------------


def gang(client=None, producer=None):
    """The standing three-tenant drill: elastic low-priority training,
    pinned high-priority serving, a pinned background eval."""
    orchestrator = Orchestrator(range(8), client=client, producer=producer)
    tenants = {
        'train': orchestrator.admit(
            JobSpec('train', 'train', priority=1, chips=4, min_chips=2),
            FakeRunner()),
        'serve': orchestrator.admit(
            JobSpec('serve', 'serve', priority=2, chips=2), FakeRunner()),
        'eval': orchestrator.admit(
            JobSpec('eval', 'eval', priority=0, chips=1), FakeRunner()),
    }
    return orchestrator, tenants


class TestOrchestrator:

    def test_admission_seats_and_narrates(self):
        producer = Producer()
        admitted = witness(producer, JobAdmitted)
        orchestrator, tenants = gang(producer=producer)
        assert [event.job for event in admitted] == ['train', 'serve',
                                                     'eval']
        assert len(orchestrator.free) == 1
        assert tenants['train'].submesh.devices == (0, 1, 2, 3)
        with pytest.raises(ValueError, match='already admitted'):
            orchestrator.admit(JobSpec('train', 'train', priority=1,
                                       chips=1), FakeRunner())
        with pytest.raises(CapacityError, match='only 1 are free'):
            orchestrator.admit(JobSpec('big', 'train', priority=1,
                                       chips=4), FakeRunner())

    @pytest.mark.parametrize('code,reason', [
        (DIVERGED_EXIT, 'diverged'), (CRASH_LOOP_EXIT, 'crash-loop'),
        (1, 'failure')])
    def test_halt_isolates_the_blast_radius(self, code, reason):
        """A non-restartable exit halts ONLY its tenant: devices return
        to the pool, JobHalted carries the typed verdict, and no other
        tenant's runner, submesh, or state is touched."""
        producer = Producer()
        halted = witness(producer, JobHalted)
        orchestrator, tenants = gang(producer=producer)
        before = {name: tenant.submesh.devices
                  for name, tenant in tenants.items()}
        tenants['eval'].runner.code = code
        changed = orchestrator.step()
        assert [tenant.name for tenant in changed] == ['eval']
        assert tenants['eval'].state == 'halted'
        assert (halted[0].job, halted[0].code,
                halted[0].reason) == ('eval', code, reason)
        for name in ('train', 'serve'):
            assert tenants[name].state == 'running'
            assert tenants[name].submesh.devices == before[name]
            assert tenants[name].runner.resizes == []
        assert set(orchestrator.free) == {7} | set(before['eval'])

    def test_restartable_exits_are_the_supervisor_trees_business(self):
        orchestrator, tenants = gang()
        for code in (LOST_WORKER_EXIT, RESIZED_EXIT, 43):
            tenants['train'].runner.code = code
            assert orchestrator.step() == []
            assert tenants['train'].state == 'running'

    def test_clean_exit_retires_and_frees(self):
        orchestrator, tenants = gang()
        tenants['eval'].runner.code = 0
        (retired,) = orchestrator.step()
        assert retired.state == 'done' and retired.exit_code == 0
        assert 6 in orchestrator.free

    def test_burst_shrinks_lowest_priority_elastic_donor(self):
        producer = Producer()
        preempted = witness(producer, JobPreempted)
        arbitrated = witness(producer, CapacityArbitrated)
        orchestrator, tenants = gang(producer=producer)
        granted = orchestrator.request_capacity('serve', 3)
        # 1 chip from the free pool + 2 preempted from training
        assert len(granted) == 3
        assert tenants['train'].submesh.devices == (0, 1)
        assert tenants['train'].runner.resizes == [(0, 1)]
        assert len(tenants['serve'].submesh) == 5
        assert orchestrator.free == []
        assert (preempted[0].job, preempted[0].chips,
                preempted[0].to) == ('train', 2, 'serve')
        assert arbitrated[0].kind == 'grant' and arbitrated[0].chips == 3
        assert orchestrator.debts == [{'from': 'serve', 'to': 'train',
                                       'devices': (2, 3)}]
        # the ebb pays the debt back and training grows again
        returned = orchestrator.release_capacity('serve')
        assert returned == 2
        assert tenants['train'].submesh.devices == (0, 1, 2, 3)
        assert tenants['train'].runner.resizes[-1] == (0, 1, 2, 3)
        assert orchestrator.debts == []
        assert arbitrated[1].kind == 'release'
        assert orchestrator.release_capacity('serve') == 0   # no debt left

    def test_burst_never_shrinks_equal_or_higher_priority(self):
        orchestrator, tenants = gang()
        # eval (priority 0, pinned) asks: train outranks nobody below it
        with pytest.raises(CapacityError, match='no donor'):
            orchestrator.request_capacity('eval', 2)
        # and a refused burst is never partially applied
        assert len(orchestrator.free) == 1
        assert tenants['train'].submesh.devices == (0, 1, 2, 3)
        assert tenants['train'].runner.resizes == []

    def test_donor_floor_is_its_min_chips(self):
        orchestrator, tenants = gang()
        orchestrator.request_capacity('serve', 3)    # train at its floor
        with pytest.raises(CapacityError, match='no donor'):
            orchestrator.request_capacity('serve', 1)


class TestOrchestratorRecovery:

    def test_snapshot_journals_and_recovers_placements(self):
        store = MemStore()
        orchestrator, tenants = gang(client=store)
        tenants['eval'].runner.code = DIVERGED_EXIT
        orchestrator.step()
        runners = {name: FakeRunner() for name in tenants}
        fresh = Orchestrator(range(8), client=store)
        assert fresh.recover([store], runners)
        assert fresh.journal.term == orchestrator.journal.term + 1
        assert fresh.tenants['eval'].state == 'halted'
        assert fresh.tenants['eval'].exit_code == DIVERGED_EXIT
        assert (fresh.tenants['train'].submesh.devices
                == tenants['train'].submesh.devices)
        assert fresh.tenants['train'].spec.elastic
        with pytest.raises(RuntimeError, match='fresh orchestrator'):
            fresh.recover([store], runners)

    def test_corrupt_journal_reads_as_absent(self):
        store = MemStore()
        orchestrator, _ = gang(client=store)
        journal = OrchestratorJournal()
        with pytest.raises(JournalCorrupt):
            journal.unpack(b'x:not a journal')
        torn = MemStore()
        torn.put(orchestrator_identity('orchestrator'), 1, b'x:torn')
        assert recover_orchestrator_journal('orchestrator', [torn]) is None
        # ...and the preference chain falls through to the intact copy
        tick, state = recover_orchestrator_journal('orchestrator',
                                                   [torn, store])
        assert state['placements']['train'] == (0, 1, 2, 3)

    def test_sigkill_mid_arbitration_completes_without_redeciding(self):
        """The headline recovery drill: the orchestrator dies BETWEEN
        journaling 'decided' and finishing the resize. A fresh
        orchestrator recovers the in-flight decision and executes the
        RECORDED plan — same donor, same devices — instead of
        re-deriving one, then journals 'done'."""
        store = MemStore()
        orchestrator, tenants = gang(client=store)

        class DiesMidResize:
            def poll(self):
                return None

            def resize(self, devices):
                raise RuntimeError('orchestrator SIGKILLed mid-resize')

        tenants['train'].runner = DiesMidResize()
        with pytest.raises(RuntimeError, match='SIGKILLed'):
            orchestrator.request_capacity('serve', 3)
        # the plane holds the 'decided' record the dead process pushed
        tick, state = recover_orchestrator_journal('orchestrator', [store])
        assert state['inflight'] is not None
        assert state['inflight']['requester'] == 'serve'
        assert state['inflight']['donor'] == 'train'

        runners = {name: FakeRunner() for name in tenants}
        fresh = Orchestrator(range(8), client=store)
        assert fresh.recover([store], runners)
        # the in-flight grant COMPLETED from the journal: training shrunk
        # to the recorded remainder, serving holds the recorded grant
        assert fresh.inflight is None
        assert fresh.tenants['train'].submesh.devices == (0, 1)
        assert runners['train'].resizes == [(0, 1)]
        assert len(fresh.tenants['serve'].submesh) == 5
        assert fresh.free == []
        assert fresh.debts == [{'from': 'serve', 'to': 'train',
                                'devices': (2, 3)}]
        # and the 'done' record is on the plane: a SECOND recovery finds
        # nothing in flight
        again = Orchestrator(range(8), client=store)
        assert again.recover([store], {name: FakeRunner()
                                       for name in tenants})
        assert again.inflight is None
        assert again.tenants['train'].submesh.devices == (0, 1)

    def test_recovered_term_fences_the_predecessors_pushes(self):
        store = MemStore()
        orchestrator, _ = gang(client=store)
        fresh = Orchestrator(range(8), client=store)
        assert fresh.recover([store], {})
        # the successor stamped its bumped term; the predecessor's next
        # push lands at a LOWER store step and the plane keeps the
        # successor's copy (term * 1_000_000 + tick monotonic-step rule)
        orchestrator.journal.tick += 1
        orchestrator.journal.replicate(orchestrator.snapshot())
        tick, state = recover_orchestrator_journal('orchestrator', [store])
        assert state['term'] == fresh.journal.term


# ---------------------------------------------------------------------------
# the seeded tenant chaos picker
# ---------------------------------------------------------------------------


class TestTenantChaosPick:

    def test_deterministic_and_in_range(self):
        tenants, components = ('a', 'b', 'c'), ('worker', 'plane')
        first = pick_tenant_chaos(5, tenants, components, lo=1, hi=8)
        assert pick_tenant_chaos(5, tenants, components, lo=1, hi=8) == first
        assert first.tenant in tenants and first.component in components
        assert 1 <= first.step <= 8
        picked = {pick_tenant_chaos(seed, tenants, components).tenant
                  for seed in range(32)}
        assert picked == set(tenants)       # every tenant is reachable

    def test_validation(self):
        with pytest.raises(ValueError):
            pick_tenant_chaos(0, (), ('x',))
        with pytest.raises(ValueError):
            pick_tenant_chaos(0, ('a',), ())
        with pytest.raises(ValueError):
            pick_tenant_chaos(0, ('a',), ('x',), lo=5, hi=2)


# ---------------------------------------------------------------------------
# cross-tenant chaos certification over fixed seeds
# ---------------------------------------------------------------------------


def job_token(name, position):
    """Deterministic per-job token stream — pure function of (job,
    position), so a replayed job recovers bitwise by construction."""
    return (sum(map(ord, name)) * 37 + position * 13) % 991


class ScriptedJob:
    """A certifiable job driver: emits its deterministic token stream
    one step at a time, narrating each emission on its tenant bus. The
    two scripted kills mirror the real failure modes: ``lose`` drops
    the last two tokens and replays them (the journal-replay shape —
    recovers bitwise), ``halt`` is a typed terminal verdict (the
    exit-44/45 shape — degrades, never corrupts)."""

    def __init__(self, name, length=6, bus=None,
                 completed=RequestCompleted):
        self.name = name
        self.length = length
        self.bus = bus
        self.completed = completed
        self.tokens = []
        self.done = False
        self.verdict = None
        self.duplicates = []

    @property
    def idle(self):
        return self.done or self.verdict is not None

    def step(self):
        if self.idle:
            return
        position = len(self.tokens)
        self.tokens.append(job_token(self.name, position))
        if self.bus is not None:
            self.bus.dispatch(self.completed(
                id=f'{self.name}-{position}', produced=1, reason='length',
                seconds=0.01))
        if len(self.tokens) >= self.length:
            self.done = True

    def outputs(self):
        reason = self.verdict or ('done' if self.done else 'running')
        return {'stream': (reason, tuple(self.tokens))}

    def lose(self):
        if self.verdict is None:
            self.tokens = self.tokens[:-2]
            self.done = False

    def halt(self):
        self.verdict = 'halted'


def _names(root):
    """One package's classes a tenant harness is built from."""
    import importlib
    from types import SimpleNamespace
    orchestrator = importlib.import_module(f'{root}.orchestrator')
    return SimpleNamespace(
        Producer=importlib.import_module(f'{root}.services.prodcon').Producer,
        RequestCompleted=importlib.import_module(
            f'{root}.observe.events').RequestCompleted,
        TenantBus=orchestrator.TenantBus, LeakAudit=orchestrator.LeakAudit,
        TenantHarness=orchestrator.TenantHarness,
        certify_tenants=orchestrator.certify_tenants)


def tenant_harness(sabotage=None, unscoped_audit=False, package=None):
    """Three scripted tenants on one shared Producer, each behind its
    TenantBus with a LeakAudit registered through the tenant's own
    wiring path; ``sabotage`` lets a kill reach ACROSS tenants (the bug
    the certifier must catch), ``unscoped_audit`` wires one audit
    without its scope (the leak the certifier must catch). ``package``
    (``_names('tpusystem')``) builds it from the reference's classes."""
    names_of = package or _names('tpusystem_torch')

    def build():
        P = names_of
        producer = P.Producer()
        audits = []
        jobs, kills = {}, {}
        names = ('train', 'serve', 'eval')
        for name in names:
            bus = P.TenantBus(producer, name)
            audit = P.LeakAudit(name)
            if unscoped_audit and name == 'eval':
                producer.register(audit)     # the leak: no scope
            else:
                bus.register(audit)
            audits.append(audit)
            jobs[name] = ScriptedJob(name, length=6, bus=bus,
                                     completed=P.RequestCompleted)
        for name in names:
            job = jobs[name]

            def corrupt(job=job, name=name):
                job.halt()
                if sabotage is not None:
                    other = jobs[sabotage(name)]
                    other.tokens.append(-1)   # a cross-tenant write

            kills[name] = {'worker': job.lose, 'plane': corrupt}
        return P.TenantHarness(
            jobs=jobs, kills=kills,
            leaks=lambda: [leak for audit in audits
                           for leak in audit.leaks])
    return build


class TestCertifyTenants:

    @pytest.mark.parametrize('seed', range(10))
    def test_non_victims_stay_bitwise_across_seeds(self, seed):
        """The acceptance drill: for every seeded (tenant × component ×
        kill-tick) draw, the two non-victim tenants finish bitwise-
        identical to the undisturbed reference, the victim recovers
        bitwise (worker kill) or degrades typed (plane kill), nothing
        hangs, nothing leaks across a namespace."""
        report = certify_tenants(tenant_harness(), seed=seed)
        assert report.ok, report.summary()
        assert report.exact == 2             # both non-victims, bitwise
        assert not report.leaked and not report.hung
        if report.component == 'worker':
            assert report.victim_exact       # replay recovered bitwise
        else:
            assert report.victim_verdict == 'halted'

    def test_cross_tenant_corruption_is_caught(self):
        """A kill that writes into ANOTHER tenant's stream must turn
        the report red — the whole point of the bitwise non-victim
        check."""
        names = ('train', 'serve', 'eval')

        def neighbor(name):
            return names[(names.index(name) + 1) % len(names)]

        reports = [certify_tenants(tenant_harness(sabotage=neighbor),
                                   seed=seed) for seed in range(10)]
        corrupted = [report for report in reports
                     if report.component == 'plane']
        assert corrupted, 'no seed in range drew the corrupting kill'
        assert all(not report.ok and report.mismatches
                   for report in corrupted)

    def test_cross_namespace_delivery_is_caught(self):
        """An audit wired WITHOUT its scope witnesses foreign events —
        certification reports the leak even when every token stream is
        intact."""
        report = certify_tenants(tenant_harness(unscoped_audit=True),
                                 seed=0)
        assert report.leaked and not report.ok
        assert any(tenant == 'eval' for tenant, _, _ in report.leaked)

    def test_reference_must_drain(self):
        def build():
            harness = tenant_harness()()
            harness.jobs['train'].length = 10 ** 9   # never idles
            return harness
        with pytest.raises(RuntimeError, match='fix the harness'):
            certify_tenants(build, seed=0, max_steps=50)

    def test_component_sets_must_match_across_tenants(self):
        def build():
            harness = tenant_harness()()
            del harness.kills['eval']['plane']
            return harness
        with pytest.raises(ValueError, match='SAME component set'):
            certify_tenants(build, seed=0)

    def test_lo_floor_keeps_the_kill_after_startup(self):
        with pytest.raises(ValueError, match='lo must be >= 1'):
            certify_tenants(tenant_harness(), seed=0, lo=0)


# ---------------------------------------------------------------------------
# the port's own: the seeded draws and verdicts are the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('tenants,components,lo,hi', [
    (('a', 'b', 'c'), ('worker', 'plane'), 1, 8),
    (('train', 'serve', 'eval', 'recsys'), ('worker',), 2, 5),
    (('solo',), ('router', 'standby', 'replica'), 0, 30)])
def test_tenant_picks_are_the_reference_s(tenants, components, lo, hi):
    from tpusystem.parallel.chaos import pick_tenant_chaos as reference
    for seed in range(64):
        got = pick_tenant_chaos(seed, tenants, components, lo=lo, hi=hi)
        want = reference(seed, tenants, components, lo=lo, hi=hi)
        assert (got.tenant, got.component, got.step) == (
            want.tenant, want.component, want.step), seed


@pytest.mark.parametrize('seed', range(10))
def test_certify_reports_are_the_reference_s(seed):
    """The same scripted tenants, built from either package's classes:
    the port's ``certify_tenants`` reports what the reference's does (the
    drawn victim, component and tick, the non-victims exact, the victim's
    verdict, nothing leaked), field for field."""
    import dataclasses
    reference = _names('tpusystem')
    want = reference.certify_tenants(tenant_harness(package=reference),
                                     seed=seed)
    got = certify_tenants(tenant_harness(), seed=seed)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.ok and got.exact == 2

