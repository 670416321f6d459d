"""No single point of failure on the port: the crash-recoverable router,
the warm-standby takeover, and the seeded fleet chaos certification.

Twins of ``tests/test_router_failover.py``: the router journal's framing
and the lease (fenced terms over the port's ``MemStore``), idempotent
submission, ``FleetClient``'s redial, the takeover drills on the fake fleet
of ``tests/test_torch_fleet.py``, and ``certify_fleet`` at the reference's
fixed seeds; host logic, so the outcomes are the reference's. The
real-engine drills (kill the router mid-stream; one certification, marked
``slow`` as the reference marks it) run the same requests through both
packages on ``gpt2_tiny`` in float32 on the CPU (``tests/torch_serving.py``)
and compare completions and the takeover's counts.

The supervised-router tests (``test_supervised_fenced_router_halts_for_
triage``, ``test_supervisor_narrates_the_standby_death_and_relaunches`` and
the ``supervisor._CODE_NAMES`` check of
``test_fenced_maps_to_exit_47_and_halts``) are twinned in
``tests/test_torch_supervisor.py``. The reference's ``trace_count``
witness has no counterpart (the port compiles nothing).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_fleet import (expected_tokens, fake_fleet,
                                    scripted_token, witness)
from tests.torch_serving import PORT, REF, FakeClock, Served, plain
from tests.torch_serving import witness as witness_in
from tpusystem_torch.checkpoint.memstore import MemStore
from tpusystem_torch.observe.events import (RequestRerouted, RouterDeposed,
                                            RouterTakeover)
from tpusystem_torch.parallel.chaos import pick_chaos
from tpusystem_torch.parallel.recovery import (RESTART_EXITS,
                                               ROUTER_FENCED_EXIT,
                                               exit_for_restart)
from tpusystem_torch.serve import (FleetClient, FleetHarness,
                                   JournalCorrupt, Request, Router,
                                   RouterFenced, RouterJournal, RouterLease,
                                   certify_fleet, recover_router_journal,
                                   router_identity)
from tpusystem_torch.serve.certify import _stream_ok
from tpusystem_torch.services.prodcon import Producer


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# harness: journaled fake fleets and the standby takeover move
# ---------------------------------------------------------------------------


def journaled_fleet(clock, n=3, *, plane=None, producer=None, cadence=1,
                    **knobs):
    """A fake fleet whose router journals + holds the lease on ``plane``
    (the buddy-replicated memstore stand-in that outlives the router)."""
    plane = plane if plane is not None else MemStore()
    lease = RouterLease(client=plane, clock=clock)
    router, handles, stores = fake_fleet(
        clock, n=n,
        router_knobs=dict(journal=RouterJournal(client=plane,
                                                cadence=cadence),
                          lease=lease, producer=producer),
        **knobs)
    lease.acquire()
    return router, handles, plane


def standby_takeover(old_router, plane, clock, *, producer=None):
    """What a warm standby does the moment ``watch()`` trips: fence the
    term, rebuild from the journal + health sweep, serve. The replica
    handles are the SAME objects — replicas outlive their router."""
    lease = RouterLease(client=plane, clock=clock, holder='standby')
    standby = Router(old_router.handles, clock=clock, producer=producer,
                     journal=RouterJournal(client=plane), lease=lease)
    lease.acquire()
    report = standby.recover((plane,))
    return standby, report


def drain(router, max_steps=400):
    completions = []
    for _ in range(max_steps):
        if router.idle:
            return completions
        completions.extend(router.step().completed)
    raise AssertionError('fleet never drained')


# ---------------------------------------------------------------------------
# the router journal wire
# ---------------------------------------------------------------------------


class TestRouterJournal:

    def test_pack_unpack_roundtrip(self):
        journal = RouterJournal()
        journal.tick = 7
        state = {'brownout': True, 'results': {}, 'routes': [('r', 1.5)]}
        tick, restored = RouterJournal.unpack(journal.pack(state))
        assert tick == 7 and restored == state

    def test_corrupt_reads_as_absent_and_falls_through(self):
        """The failover discipline one tier up: a torn router journal
        must never restore — it reads as absent and recovery falls to
        the next client in the preference chain."""
        clock = FakeClock()
        good, torn = MemStore(), MemStore()
        journal = RouterJournal(client=good)
        journal.tick = 3
        assert journal.replicate({'routes': []})
        torn.put(router_identity(), 1, b'x:not a journal')
        with pytest.raises(JournalCorrupt):
            RouterJournal.unpack(b'x:not a journal')
        assert recover_router_journal('router', (torn,)) is None
        tick, state = recover_router_journal('router', (torn, good))
        assert tick == 3 and state == {'routes': []}
        # an unreachable plane likewise falls through, never raises
        class Dead:
            def fetch(self, identity):
                raise OSError('plane down')
        assert recover_router_journal('router', (Dead(), good)) is not None

    def test_cadence_gates_replication(self):
        plane = MemStore()
        journal = RouterJournal(client=plane, cadence=3)
        for _ in range(7):
            journal.observe_tick(lambda: {'routes': []})
        assert journal.tick == 7 and journal.pushes == 2   # ticks 3 and 6
        with pytest.raises(ValueError, match='cadence'):
            RouterJournal(cadence=0)

    def test_zombie_term_cannot_overwrite_the_incumbent(self):
        """The auto-fence: pushes encode ``term * 1M + tick`` as the
        memstore step, so a deposed router's journal — even at a much
        later tick — never replaces the new incumbent's state."""
        plane = MemStore()
        zombie = RouterJournal(client=plane)
        zombie.term, zombie.tick = 1, 500
        incumbent = RouterJournal(client=plane)
        incumbent.term, incumbent.tick = 2, 1
        assert incumbent.replicate({'holder': 'incumbent'})
        zombie.tick = 900
        zombie.replicate({'holder': 'zombie'})
        _tick, state = recover_router_journal('router', (plane,))
        assert state == {'holder': 'incumbent'}

    def test_push_failure_degrades_log_once(self, caplog):
        class Wedged:
            def push(self, identity, step, blob):
                raise OSError('plane down')
        journal = RouterJournal(client=Wedged())
        with caplog.at_level('WARNING'):
            for _ in range(4):
                journal.observe_tick(lambda: {})
        warnings = [record for record in caplog.records
                    if 'router journal' in record.message]
        assert len(warnings) == 1    # log-once, routing never interrupted


# ---------------------------------------------------------------------------
# the lease: acquire / renew / watch / fence
# ---------------------------------------------------------------------------


class TestRouterLease:

    def test_acquire_renew_and_watch_patience(self):
        clock = FakeClock()
        plane = MemStore()
        active = RouterLease(client=plane, clock=clock, renew_every=1.0)
        assert active.acquire() == 1
        standby = RouterLease(client=plane, clock=clock, holder='standby',
                              miss_after=3.0)
        assert standby.watch() is False      # first observation seeds it
        for _ in range(6):                   # renewals advancing = patience
            clock.advance(1.0)
            active.renew()
            assert standby.watch() is False
        clock.advance(3.0)                   # incumbent silent past the miss
        assert standby.watch() is True

    def test_renew_self_gates_to_renew_every(self):
        clock = FakeClock()
        plane = MemStore()
        lease = RouterLease(client=plane, clock=clock, renew_every=2.0)
        lease.acquire()
        before = lease.count
        lease.renew()                        # clock unchanged: gated
        assert lease.count == before
        clock.advance(2.0)
        lease.renew()
        assert lease.count == before + 1

    def test_renew_before_acquire_is_a_caller_error(self):
        lease = RouterLease(client=MemStore(), clock=FakeClock())
        with pytest.raises(ValueError, match='acquire'):
            lease.renew()

    def test_standby_fences_and_the_zombie_renewal_is_typed(self):
        """The split-brain guard: the standby publishes term + 1; the
        deposed incumbent's next renewal reads the higher term back
        (the elastic echo discipline) and raises RouterFenced."""
        clock = FakeClock()
        plane = MemStore()
        active = RouterLease(client=plane, clock=clock)
        active.acquire()
        standby = RouterLease(client=plane, clock=clock, holder='standby')
        assert standby.acquire() == 2
        clock.advance(1.5)
        with pytest.raises(RouterFenced) as caught:
            active.renew()
        assert caught.value.term == 1 and caught.value.observed == 2
        # ... and the zombie's renewal never landed in the store
        assert active.observe()[0] == 2

    def test_store_outage_is_not_a_router_death(self):
        """watch() must never fence on a plane hiccup — an unreachable
        store returns False (the incumbent may be perfectly healthy)."""
        clock = FakeClock()

        class Flaky:
            dead = False

            def put(self, identity, step, blob, **kw):
                return MemStore.put(self.store, identity, step, blob, **kw)

            def fetch(self, identity):
                if self.dead:
                    raise OSError('plane down')
                return self.store.fetch(identity)
        flaky = Flaky()
        flaky.store = MemStore()
        active = RouterLease(client=flaky, clock=clock)
        active.acquire()
        standby = RouterLease(client=flaky, clock=clock, holder='standby')
        standby.watch()
        flaky.dead = True
        clock.advance(100.0)
        assert standby.watch() is False

    def test_fenced_maps_to_exit_47_and_halts(self):
        """The supervisor contract: RouterFenced carries exit 47 through
        the generic ``exit_code`` rung; 47 is deliberately not
        restartable (the standby is the restart)."""
        verdict = exit_for_restart(RouterFenced(1, 2))
        assert verdict.code == ROUTER_FENCED_EXIT == 47
        assert ROUTER_FENCED_EXIT not in RESTART_EXITS

# ---------------------------------------------------------------------------
# idempotent submission: the redial contract's other half
# ---------------------------------------------------------------------------


class TestSubmitIdempotency:

    def test_in_flight_resubmit_returns_placement_without_doubling(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2)
        placed = router.submit(Request('a', [1], 8))
        depth = handles[0].placements + handles[1].placements
        assert router.submit(Request('a', [1], 8)) == placed
        assert handles[0].placements + handles[1].placements == depth

    def test_settled_resubmit_returns_sentinel(self):
        clock = FakeClock()
        router, _, _ = fake_fleet(clock, n=1)
        router.submit(Request('a', [1], 3))
        drain(router)
        assert router.submit(Request('a', [1], 3)) == 'settled'
        assert router.results['a'].tokens == expected_tokens('a', 3)


# ---------------------------------------------------------------------------
# kill the router: journal rebuild, standby takeover (fakes)
# ---------------------------------------------------------------------------


class TestRouterTakeover:

    def test_kill_router_mid_stream_journal_rebuild_token_exact(self):
        """THE tentpole drill (fake tier): the incumbent dies with rows
        seated AND queued; the standby fences, replays the journal, and
        every request completes token-exact — reseated rows keep
        streaming from their position, queued rows re-place, nothing
        double-completes."""
        clock = FakeClock()
        producer = Producer()
        takeovers = witness(producer, RouterTakeover)
        reroutes = witness(producer, RequestRerouted)
        # 2 replicas x 2 rows: 4 seated, 4 queued at the kill
        router, handles, plane = journaled_fleet(clock, n=2,
                                                 producer=producer)
        for i in range(8):
            router.submit(Request(f'r{i}', [1 + i], 6))
        for _ in range(2):
            router.step()
        seated = {rid for handle in handles
                  for rid in handle.scheduler._seated}
        assert len(seated) == 4
        # the incumbent is never stepped again: the in-process crash
        standby, report = standby_takeover(router, plane, clock,
                                           producer=producer)
        assert report['source'] == 'journal'
        assert report['term'] == 2
        assert report['reseated'] >= 4       # the seated rows re-attach
        assert takeovers and takeovers[0].term == 2
        # reseated rows were NOT re-placed — they keep streaming
        assert not {event.id for event in reroutes} & seated
        first = standby.step()
        for rid in seated & set(first.emitted):
            position = len(handles[0].scheduler._seated.get(
                rid, handles[1].scheduler._seated.get(rid, [0, 0, []]))[2])
            assert first.emitted[rid] == scripted_token(rid, position - 1)
        completions = drain(standby)
        assert set(standby.results) == {f'r{i}' for i in range(8)}
        for i in range(8):
            assert standby.results[f'r{i}'].tokens \
                == expected_tokens(f'r{i}', 6), f'r{i}'
        # no duplicate completions across the whole incident
        assert sorted(completions) == sorted(set(completions))

    def test_settled_results_survive_and_never_double_complete(self):
        """The completion-edge idempotency table rides the journal: a
        request the old router settled stays settled — the standby
        answers 'settled' to a resubmit and never re-runs it."""
        clock = FakeClock()
        router, _, plane = journaled_fleet(clock, n=1)
        router.submit(Request('done', [1], 2))
        drain(router)
        router.submit(Request('live', [2], 8))
        router.step()
        standby, report = standby_takeover(router, plane, clock)
        assert report['settled'] >= 1
        assert standby.submit(Request('done', [1], 2)) == 'settled'
        assert standby.results['done'].tokens == expected_tokens('done', 2)
        completions = drain(standby)
        assert 'done' not in completions     # never re-ran
        assert standby.results['live'].tokens == expected_tokens('live', 8)

    def test_cold_sweep_rebuild_without_a_router_journal(self):
        """No router journal survives (cold rung): the health sweep
        alone rebuilds the tables from the replicas' own results dicts
        and request journals — slower to rebuild, still token-exact."""
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2)
        for i in range(6):
            router.submit(Request(f'r{i}', [1 + i], 5))
        for _ in range(2):
            router.step()
        standby = Router(router.handles, clock=clock)
        report = standby.recover(())
        assert report['source'] == 'sweep'
        assert report['reseated'] >= 1
        drain(standby)
        assert set(standby.results) == {f'r{i}' for i in range(6)}
        for i in range(6):
            assert standby.results[f'r{i}'].tokens \
                == expected_tokens(f'r{i}', 5)

    def test_brownout_flag_rides_the_journal(self):
        clock = FakeClock()
        router, _, plane = journaled_fleet(clock, n=1)
        router.brownout = True
        router.step()
        standby, _ = standby_takeover(router, plane, clock)
        assert standby.brownout is True

    def test_zombie_router_step_raises_fenced_and_narrates(self):
        """A not-yet-dead incumbent that lost its lease must STOP at the
        top of its next tick — before placing anything — with the typed
        verdict narrated as RouterDeposed."""
        clock = FakeClock()
        producer = Producer()
        deposed = witness(producer, RouterDeposed)
        router, _, plane = journaled_fleet(clock, n=1, producer=producer)
        router.submit(Request('a', [1], 8))
        router.step()
        standby, _ = standby_takeover(router, plane, clock)
        clock.advance(1.5)                   # past the renew gate
        with pytest.raises(RouterFenced):
            router.step()
        assert deposed and deposed[0].term == 1 and deposed[0].observed == 2
        drain(standby)
        assert standby.results['a'].tokens == expected_tokens('a', 8)


# ---------------------------------------------------------------------------
# the client side: redial with capped seeded backoff, resubmit by id
# ---------------------------------------------------------------------------


class TestFleetClient:

    def test_redials_until_the_standby_answers(self):
        calls, sleeps = [0], []

        class Standby:
            @staticmethod
            def submit(request):
                return 'rep0'

        def resolve():
            calls[0] += 1
            if calls[0] <= 2:
                raise ConnectionError('router socket died')
            return Standby()
        client = FleetClient(resolve, sleep=sleeps.append, seed=3)
        assert client.submit(Request('a', [1], 4)) == 'rep0'
        assert client.redials == 2 and len(sleeps) == 2
        # capped exponential with bounded jitter, deterministic by seed
        import random
        rng = random.Random(3)
        for attempt, slept in enumerate(sleeps):
            base = min(2.0, 0.05 * 2 ** attempt)
            assert slept == base * (1.0 + 0.25 * rng.random())

    def test_zombie_fenced_router_is_a_redial_signal(self):
        class Zombie:
            @staticmethod
            def submit(request):
                raise RouterFenced(1, 2)

        class Standby:
            @staticmethod
            def submit(request):
                return 'rep1'
        answers = [Zombie(), Standby()]
        client = FleetClient(lambda: answers.pop(0), sleep=lambda s: None)
        assert client.submit(Request('a', [1], 4)) == 'rep1'
        assert client.redials == 1

    def test_exhausted_redials_raise_typed(self):
        def resolve():
            raise OSError('nobody home')
        client = FleetClient(resolve, max_redials=2, sleep=lambda s: None)
        with pytest.raises(ConnectionError, match='no standby took over'):
            client.submit(Request('a', [1], 4))
        assert client.redials == 2

    def test_validation(self):
        with pytest.raises(ValueError):
            FleetClient(lambda: None, max_redials=-1)
        with pytest.raises(ValueError):
            FleetClient(lambda: None, backoff_base=0.5, backoff_cap=0.1)

    def test_backoff_schedule_is_deterministic_by_seed(self):
        """The capped-backoff path, pinned: the jitter schedule is
        a pure function of the seed — two clients with the same seed
        sleep the identical schedule, a different seed diverges, and a
        red redial storm replays exactly from its seed (the Faults /
        pick_chaos discipline applied to client backoff)."""
        def schedule(seed, failures=6):
            calls, sleeps = [0], []

            class Standby:
                @staticmethod
                def submit(request):
                    return 'rep0'

            def resolve():
                calls[0] += 1
                if calls[0] <= failures:
                    raise ConnectionError('router socket died')
                return Standby()
            client = FleetClient(resolve, sleep=sleeps.append, seed=seed)
            client.submit(Request('a', [1], 4))
            return sleeps

        first, again = schedule(seed=11), schedule(seed=11)
        assert first == again                 # same seed, same schedule
        assert len(first) == 6
        assert schedule(seed=12) != first     # the jitter is really there
        # every slept value obeys the cap and the bounded-jitter window
        for attempt, slept in enumerate(first):
            base = min(2.0, 0.05 * 2 ** attempt)
            assert base <= slept <= base * 1.25

    def test_end_to_end_resubmit_across_a_takeover(self):
        """The whole client contract in one move: submit, router dies,
        redial finds the standby, resubmit by id is idempotent, and
        the result reads from the journal-carried idempotency table."""
        clock = FakeClock()
        router, _, plane = journaled_fleet(clock, n=1)
        current = {'router': router, 'dead': False}

        def resolve():
            if current['dead']:
                raise ConnectionError('router gone')
            return current['router']
        client = FleetClient(resolve, sleep=lambda s: None)
        assert client.submit(Request('a', [1], 3)) == 'rep0'
        drain(router)
        current['dead'] = True               # the crash ...
        standby, _ = standby_takeover(router, plane, clock)

        def heal():
            current['dead'] = False
            current['router'] = standby
        healer = FleetClient(resolve, sleep=lambda s: heal())
        assert healer.submit(Request('a', [1], 3)) == 'settled'
        assert healer.result('a').tokens == expected_tokens('a', 3)


# ---------------------------------------------------------------------------
# the double-failure window: the standby dies before its takeover
# completes, the fenced incumbent is already gone
# ---------------------------------------------------------------------------


class TestDoubleFailureWindow:

    def test_standby_death_mid_takeover_leaves_journal_recoverable(self):
        """Standby #1 fences the term and dies BEFORE ``recover()``
        completes, with the fenced incumbent already gone — the worst
        moment. The journal (pushed by the incumbent, untouched by the
        half-takeover) must still recover a FRESH standby, which fences
        a higher term and drains every in-flight row token-exact."""
        clock = FakeClock()
        router, _, plane = journaled_fleet(clock, n=2)
        for request_id in ('a', 'b', 'c'):
            router.submit(Request(request_id, [1], 6))
        router.step()
        router.step()
        # the incumbent is gone (SIGKILL form: the object is abandoned,
        # its last journal push outlives it on the plane)
        half_lease = RouterLease(client=plane, clock=clock,
                                 holder='standby-1')
        half_lease.acquire()                 # the fence landed (term 2)...
        # ...and standby-1 died right here: no recover(), no serving.
        # A fresh standby must not be blocked by the orphaned fence:
        fresh_lease = RouterLease(client=plane, clock=clock,
                                  holder='standby-2')
        standby = Router(router.handles, clock=clock,
                         journal=RouterJournal(client=plane),
                         lease=fresh_lease)
        fresh_lease.acquire()
        assert fresh_lease.term > half_lease.term   # a THIRD term
        report = standby.recover((plane,))
        assert report['reseated'] + report['replaced'] >= 1
        drain(standby)
        for request_id in ('a', 'b', 'c'):
            assert (standby.results[request_id].tokens
                    == expected_tokens(request_id, 6))
        # and the orphan's late renewal is fenced out like any zombie's
        clock.advance(1.5)
        with pytest.raises(RouterFenced):
            half_lease.renew()

# ---------------------------------------------------------------------------
# the chaos picker + certification over fixed seeds
# ---------------------------------------------------------------------------


def certifiable(clock_box=None):
    """A FleetHarness builder over the fake fleet with all five
    components wired: router (standby takeover), standby (no-op death),
    a replica kill, and the supervisor plane (journal pushes wedge)."""
    def build():
        clock = FakeClock()
        if clock_box is not None:
            clock_box.append(clock)
        plane = MemStore()
        wedge = {'dead': False}

        class Plane:
            @staticmethod
            def put(identity, step, blob, **kw):
                if wedge['dead']:
                    raise OSError('supervisor plane down')
                return plane.put(identity, step, blob, **kw)

            @staticmethod
            def fetch(identity):
                if wedge['dead']:
                    raise OSError('supervisor plane down')
                return plane.fetch(identity)
        router, handles, _ = fake_fleet(clock, n=3, router_knobs=dict(
            journal=RouterJournal(client=Plane()),
            lease=RouterLease(client=Plane(), clock=clock)))
        router.lease.acquire()
        workload = [Request(f'r{i}', [1 + i], 4 + (i % 4))
                    for i in range(7)]

        def kill_router():
            standby, report = standby_takeover(router, plane, clock)
            return standby, report

        def kill_supervisor():
            wedge['dead'] = True             # journal degrades, serving on

        kills = {'router': kill_router,
                 'standby': lambda: None,
                 'prefill': handles[1].kill,
                 'decode': handles[2].kill,
                 'supervisor': kill_supervisor}
        return FleetHarness(router=router, workload=workload, kills=kills,
                            advance=lambda: clock.advance(0.1))
    return build


class TestChaosCertification:

    def test_pick_is_seeded_and_validated(self):
        components = ('router', 'standby', 'prefill', 'decode', 'supervisor')
        picks = {seed: pick_chaos(seed, components, lo=1, hi=8)
                 for seed in range(16)}
        assert all(picks[seed] == pick_chaos(seed, components, lo=1, hi=8)
                   for seed in picks)        # same seed, same scenario
        assert {pick.component for pick in picks.values()} == set(components)
        assert all(1 <= pick.step <= 8 for pick in picks.values())
        with pytest.raises(ValueError):
            pick_chaos(0, ())
        with pytest.raises(ValueError):
            pick_chaos(0, components, lo=5, hi=2)

    @pytest.mark.parametrize('seed', [0, 1, 2])
    def test_certify_fleet_fixed_seeds(self, seed):
        """The acceptance invariant, three fixed seeds in tier-1: every
        accepted request completes exactly or fails typed; no hung
        requests, no duplicate completions."""
        report = certify_fleet(certifiable(), seed=seed, lo=1, hi=6)
        assert report.ok, report.summary()
        assert report.accepted == 7
        assert report.completed + len(report.degraded) == 7

    def test_certify_covers_every_component(self):
        """Sweep seeds until each of the five components has been the
        victim at least once — the uniform pick genuinely reaches them
        all, and the invariant holds for each."""
        survived = set()
        for seed in range(24):
            if len(survived) == 5:
                break
            report = certify_fleet(certifiable(), seed=seed, lo=1, hi=6)
            assert report.ok, report.summary()
            survived.add(report.component)
        assert survived == {'router', 'standby', 'prefill', 'decode',
                            'supervisor'}

    def test_certify_validates_the_harness(self):
        with pytest.raises(ValueError, match='lo must be >= 1'):
            certify_fleet(certifiable(), seed=0, lo=0)
        with pytest.raises(ValueError, match='no kill thunk'):
            certify_fleet(certifiable(), seed=0,
                          components=('volcano',))

    def test_stream_subsequence_check(self):
        assert _stream_ok([2, 3, 5], [1, 2, 3, 4, 5])
        assert _stream_ok([], [1, 2])
        assert not _stream_ok([3, 2], [1, 2, 3])   # order violated
        assert not _stream_ok([9], [1, 2, 3])      # token never completed


# ---------------------------------------------------------------------------
# real engines: the kill-the-router acceptance drill
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def served():
    return Served('gpt2')


def real_journaled_fleet(P, served, clock, plane, n=3):
    stores = [P.MemStore() for _ in range(n)]
    handles = []
    for index in range(n):
        def build():
            return P.Scheduler(served.engine(P, rows=2, block_size=8),
                               clock=clock)
        handles.append(P.ReplicaHandle(P.ServingReplica(
            build, identity=f'rep{index}', client=stores[index],
            clock=clock)))
    lease = P.RouterLease(client=plane, clock=clock)
    router = P.Router(handles, clock=clock,
                      journal=P.RouterJournal(client=plane), lease=lease)
    lease.acquire()
    return router, handles


def real_takeover(P, old_router, plane, clock, *, producer=None):
    lease = P.RouterLease(client=plane, clock=clock, holder='standby')
    standby = P.Router(old_router.handles, clock=clock, producer=producer,
                       journal=P.RouterJournal(client=plane), lease=lease)
    lease.acquire()
    report = standby.recover((plane,))
    return standby, report


def failover_workload(P, seed=11):
    """Greedy, seeded-sampled and streamed rows in one pot."""
    rng = np.random.default_rng(seed)
    requests = []
    for index in range(6):
        prompt = rng.integers(0, 256, (5 + (index % 4),)).tolist()
        sampling = (P.SamplingParams(temperature=0.8, seed=100 + index,
                                     top_k=16)
                    if index % 2 else None)
        requests.append(P.Request(f'r{index}', prompt, 6 + (index % 3),
                                  sampling=sampling))
    return requests


def _kill_router(P, served):
    clock = FakeClock()
    reference_router, _ = real_journaled_fleet(P, served, clock,
                                               P.MemStore(), n=3)
    for request in failover_workload(P):
        reference_router.submit(request)
    reference = reference_router.run_until_idle()
    plane = P.MemStore()
    router, handles = real_journaled_fleet(P, served, clock, plane, n=3)
    streamed: dict = {}

    def collect(tick):
        for rid, tokens in tick.emitted.items():
            streamed.setdefault(rid, []).extend(
                int(token) for token in tokens)
    for request in failover_workload(P):
        router.submit(request)
    for _ in range(2):
        collect(router.step())           # rows seated, streaming
    producer = P.Producer()
    takeovers = witness_in(P, producer, 'RouterTakeover')
    standby, report = real_takeover(P, router, plane, clock,
                                    producer=producer)
    assert report['source'] == 'journal' and takeovers
    clock.advance(1.5)
    with pytest.raises(P.RouterFenced):
        router.step()
    completions = []
    for _ in range(400):
        if standby.idle:
            break
        tick = standby.step()
        collect(tick)
        completions.extend(tick.completed)
    assert standby.idle, 'takeover fleet never drained'
    assert set(standby.results) == set(reference)
    for rid, completion in standby.results.items():
        assert completion.tokens == reference[rid].tokens, rid
        assert completion.reason == reference[rid].reason, rid
        assert P.certify._stream_ok(streamed.get(rid, []),
                                    list(completion.tokens)), rid
    assert sorted(completions) == sorted(set(completions))
    return (plain(standby.results), streamed,
            {key: value for key, value in report.items()
             if key != 'seconds'})


def _certify_real(P, served):
    def build():
        clock = FakeClock()
        plane = P.MemStore()
        router, handles = real_journaled_fleet(P, served, clock, plane,
                                               n=3)
        kills = {
            'router': lambda: real_takeover(P, router, plane, clock),
            'standby': lambda: None,
            'decode': handles[2].kill,
        }
        return P.FleetHarness(router=router,
                              workload=failover_workload(P), kills=kills,
                              advance=lambda: clock.advance(0.05))
    report = P.certify_fleet(build, seed=1, lo=1, hi=4)
    assert report.ok, report.summary()
    return report.summary(), report.completed, report.degraded


class TestKillTheRouterReal:

    def test_kill_router_mid_stream_token_exact(self, served):
        """Kill the active router mid-stream with greedy and
        seeded-sampled rows in flight while streaming; the standby takes
        over from the journal and every accepted request's tokens equal
        an undisturbed fleet's, its streamed transcript consistent; the
        port's run is the reference's."""
        assert _kill_router(PORT, served) == _kill_router(REF, served)

    @pytest.mark.slow
    def test_certify_fleet_real_engines(self, served):
        """One seeded certification over real engines."""
        assert _certify_real(PORT, served) == _certify_real(REF, served)
