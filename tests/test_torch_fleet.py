"""The port's serving fleet: the health-checked router, journal hand-off,
retries and hedging, fleet shedding and autoscale.

Twins of ``tests/test_serve_fleet.py`` (and of the fleet tests of
``tests/test_serve_sampling.py``). The policy tests drive the port's
``Router`` over the reference's fake replicas, rebuilt on the port's
classes (a scripted scheduler with the real surface, deterministic tokens,
no engine) on a fake clock, with the reference's assertions: host logic,
so the outcomes are the reference's. The chaos drills run real engines:
the same requests through both packages on ``gpt2_tiny`` in float32 on the
CPU (``tests/torch_serving.py``), a ``PreemptionWave`` killing replicas
mid-stream; completions and reroute events equal the reference's run, and
both equal an uninterrupted fleet. The twins of tests the reference marks
``slow`` are marked ``slow``.

The trace-plane half of ``test_preemption_wave_mid_stream_token_exact``
is its own test here (``test_preemption_wave_gives_one_connected_trace_per_
request``): both packages' merged fleet exports hold the reference's
properties and the same span tree.
"""

import json
import logging

import numpy as np
import pytest
import torch

from tests.torch_serving import (PORT, REF, FakeClock, Served, plain,
                                 span_tree)
from tests.torch_serving import witness as witness_in
from tpusystem_torch.checkpoint.memstore import MemStore
from tpusystem_torch.serve import (AutoscalePolicy, FleetSaturated,
                                   NoHealthyReplica, QueueFull,
                                   ReplicaHandle, Request, RequestJournal,
                                   RoutePolicy, Router, Watermarks)
from tpusystem_torch.serve.scheduler import Completion, Tick
from tpusystem_torch.services.prodcon import Consumer, Producer


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def witness(producer, *event_types):
    """Collect the given event types dispatched on ``producer``."""
    seen = []
    consumer = Consumer('probe')
    for event_type in event_types:
        consumer.register(event_type, seen.append)
    producer.register(consumer)
    return seen


# ---------------------------------------------------------------------------
# the fake replica: the real Scheduler surface, scripted decode
# ---------------------------------------------------------------------------


def scripted_token(request_id: str, position: int) -> int:
    """Deterministic emission: the fake fleet's stand-in for greedy
    decode — any replica resuming ``request_id`` at ``position`` emits
    the same token, so hot handoffs are checkable arithmetic."""
    return (sum(map(ord, request_id)) * 31 + position) % 997


def expected_tokens(request_id: str, budget: int) -> list:
    return [scripted_token(request_id, p) for p in range(budget)]


class FakeScheduler:
    """The :class:`~tpusystem_torch.serve.Scheduler` surface with scripted
    decode: each step seats up to ``rows`` requests (emitting the
    admission token, the engine's contract) and every seated row emits
    one :func:`scripted_token` per tick. ``wedged=True`` seats rows but
    never decodes past the admission token — the straggler the
    timeout/hedge ladder must beat."""

    def __init__(self, *, clock, rows: int = 2, max_queued=None,
                 wedged: bool = False) -> None:
        self.rows = rows
        self.max_queued = max_queued
        self.wedged = wedged
        self.journal = None
        self.backpressure = False
        self._clock = clock
        self._queue = []             # (request, submitted, prefix)
        self._seated = {}            # id -> [request, submitted, tokens]
        self.results = {}
        self.steps = 0

    # ------------------------------------------------------- intake
    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def active(self):
        return len(self._seated)

    @property
    def idle(self):
        return not self._queue and not self._seated

    def submit(self, request):
        if (self.max_queued is not None
                and len(self._queue) >= self.max_queued):
            raise QueueFull(f'{request.id!r}: backlog full')
        self._queue.append((request, self._clock(), []))
        if self.journal is not None:
            self.journal.record(request, self._clock())

    def restore(self, request, *, waited=0.0, prefix=()):
        prefix = [int(t) for t in prefix]
        if len(prefix) >= request.max_new:
            raise ValueError(f'{request.id!r} already finished')
        submitted = self._clock() - waited
        self._queue.append((request, submitted, prefix))
        if self.journal is not None:
            self.journal.restored(request, submitted, prefix)

    def cancel(self, request_id):
        for entry in list(self._queue):
            if entry[0].id == request_id:
                self._queue.remove(entry)
                if self.journal is not None:
                    self.journal.finished(request_id)
                return 'queued'
        seated = self._seated.pop(request_id, None)
        if seated is not None:
            self._complete(seated[0], seated[1], seated[2], 'cancelled')
            return 'active'
        return None

    def shed_candidates(self):
        now = self._clock()
        out = []
        for request, submitted, _prefix in self._queue:
            slack = (None if request.deadline is None
                     else request.deadline - (now - submitted))
            out.append((request.id, slack, now - submitted))
        return out

    def shed(self, request_id):
        for entry in list(self._queue):
            if entry[0].id == request_id:
                self._queue.remove(entry)
                return self._complete(entry[0], entry[1], [], 'shed')
        return None

    # ------------------------------------------------------- serving
    def _complete(self, request, submitted, tokens, reason):
        completion = Completion(request, list(tokens), reason,
                                self._clock() - submitted)
        self.results[request.id] = completion
        if self.journal is not None:
            self.journal.finished(request.id)
        return completion

    def step(self):
        self.steps += 1
        admitted = []
        while self._queue and len(self._seated) < self.rows:
            request, submitted, prefix = self._queue.pop(0)
            tokens = list(prefix)
            self._seated[request.id] = [request, submitted, tokens]
            admitted.append((request, None, self._clock() - submitted))
            if not prefix:           # admission emits the first token
                tokens.append(scripted_token(request.id, 0))
                if self.journal is not None:
                    self.journal.seated(request.id, tokens[-1])
        emitted, completed = {}, []
        for request_id, entry in list(self._seated.items()):
            request, submitted, tokens = entry
            if not self.wedged and len(tokens) < request.max_new:
                token = scripted_token(request_id, len(tokens))
                tokens.append(token)
                emitted[request_id] = token
                if self.journal is not None:
                    self.journal.append(request_id, token)
            if len(tokens) >= request.max_new:
                del self._seated[request_id]
                completed.append(self._complete(request, submitted,
                                                tokens, 'length'))
        if self.journal is not None:
            self.journal.observe_tick()
        return Tick(admitted, emitted, completed, len(self._queue),
                    len(self._seated))


class FakeReplica:
    """The ServingReplica surface over a :class:`FakeScheduler`, with
    the journal wired exactly like the real one (client = supervisor-RAM
    stand-in that outlives a kill)."""

    def __init__(self, identity, *, clock, client=None, cadence=1,
                 fallbacks=(), **knobs):
        self.identity = identity
        self.client = client
        self.fallbacks = tuple(fallbacks)
        self.scheduler = FakeScheduler(clock=clock, **knobs)
        self.scheduler.journal = RequestJournal(identity, client=client,
                                                cadence=cadence, clock=clock)

    def submit(self, request):
        self.scheduler.submit(request)

    def step(self):
        return self.scheduler.step()

    @property
    def results(self):
        return self.scheduler.results

    @property
    def idle(self):
        return self.scheduler.idle


def fake_fleet(clock, n=2, *, cadence=1, router_knobs=None, **knobs):
    stores = [MemStore() for _ in range(n)]
    handles = [ReplicaHandle(FakeReplica(f'rep{i}', clock=clock,
                                         client=stores[i], cadence=cadence,
                                         **knobs))
               for i in range(n)]
    router = Router(handles, clock=clock, **(router_knobs or {}))
    return router, handles, stores


# ---------------------------------------------------------------------------
# routing and health
# ---------------------------------------------------------------------------


class TestRouting:

    def test_least_loaded_placement(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=3)
        names = [router.submit(Request(f'r{i}', [1], 4)) for i in range(3)]
        # each submission deepens a replica, so the next goes elsewhere
        assert sorted(names) == ['rep0', 'rep1', 'rep2']

    def test_prefix_affinity_steers_to_the_warm_replica(self):
        """A replica whose engine holds the prompt's prefix in its radix
        tree wins placement over emptier-but-cold replicas — and loses
        it again the moment it is backpressured (affinity is a steering
        hint, never a pressure override)."""
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=3)

        class _WarmEngine:
            @staticmethod
            def prefix_cached_len(prompt):
                return 8 if list(prompt[:2]) == [1, 2] else 0

        handles[2].scheduler.engine = _WarmEngine()
        # depth tie everywhere: the warm radix tree breaks it
        assert router.submit(Request('warm', [1, 2, 3, 4], 4)) == 'rep2'
        # ... and keeps winning even when rep2 is now DEEPER than the rest
        assert router.submit(Request('warm2', [1, 2, 3, 4], 4)) == 'rep2'
        # a cold prompt ignores affinity: least-loaded as before
        assert router.submit(Request('cold', [9, 9], 4)) in ('rep0', 'rep1')
        # backpressure outranks the warm cache
        handles[2].scheduler.backpressure = True
        assert router.submit(Request('warm3', [1, 2, 3, 4], 4)) != 'rep2'

    def test_backpressured_replica_passed_over(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2)
        handles[0].scheduler.backpressure = True
        assert router.submit(Request('a', [1], 4)) == 'rep1'
        # ... unless every healthy replica is backpressured
        handles[1].scheduler.backpressure = True
        assert router.submit(Request('b', [1], 4)) in ('rep0', 'rep1')

    def test_queue_full_falls_to_next_replica_then_saturates(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2, max_queued=1)
        assert router.submit(Request('r0', [1], 8)) == 'rep0'
        # rep0's backlog is full: the router retries on rep1
        assert router.submit(Request('r1', [1], 8)) == 'rep1'
        with pytest.raises(FleetSaturated):
            router.submit(Request('overflow', [1], 8))

    def test_dead_fleet_raises_no_healthy(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=1)
        handles[0].kill()
        with pytest.raises(NoHealthyReplica):
            router.submit(Request('a', [1], 4))
        assert not handles[0].healthy   # dying at submit IS the verdict

    def test_dead_on_submit_reroutes_to_survivor(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2)
        handles[0].kill()
        assert router.submit(Request('a', [1], 4)) == 'rep1'
        assert not handles[0].healthy

    def test_completions_settle_and_drain(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2)
        for i in range(4):
            router.submit(Request(f'r{i}', [1], 3))
        results = router.run_until_idle()
        assert set(results) == {'r0', 'r1', 'r2', 'r3'}
        for i in range(4):
            assert results[f'r{i}'].tokens == expected_tokens(f'r{i}', 3)
            assert results[f'r{i}'].reason == 'length'

    def test_fleet_cancel_reaches_the_placed_replica(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=2)
        router.submit(Request('a', [1], 8))
        assert router.cancel('a') == 'queued'
        assert router.cancel('a') is None    # idempotent: route gone
        assert router.idle

    def test_external_replica_completions_settle(self):
        """Review regression: an externally-driven replica's completions
        must settle through the router (it never sees their Ticks) —
        otherwise the route table leaks, idle never lands, and the
        retry ladder re-places finished work."""
        clock = FakeClock()
        external = ReplicaHandle(FakeReplica('ext', clock=clock),
                                 external=True)
        router = Router([external], clock=clock,
                        policy=RoutePolicy(timeout=5.0, max_retries=2),
                        heartbeat_timeout=100.0)
        assert router.submit(Request('a', [1], 3)) == 'ext'
        # the replica's own loop runs it to completion...
        external.beat()
        while not external.replica.idle:
            external.replica.step()
        clock.advance(10.0)          # ...past the retry patience
        tick = router.step()         # harvest, not a timeout reroute
        assert tick.completed == ['a']
        assert not tick.rerouted
        assert router.idle
        assert router.results['a'].tokens == expected_tokens('a', 3)

    def test_cancel_purges_the_orphan_buffer(self):
        """Review regression: a cancelled orphan must not be
        resurrected by the next adopt."""
        clock = FakeClock()
        router, handles, _ = fake_fleet(clock, n=1)
        router.submit(Request('a', [1], 5))
        router.step()
        handles[0].kill()
        router.step()                # 'a' parks in the orphan buffer
        assert router.cancel('a') == 'queued'
        router.adopt(ReplicaHandle(FakeReplica('rep9', clock=clock)))
        assert router.run_until_idle() == {}   # nothing resurrected
        assert 'a' not in router.results

    def test_duplicate_replica_names_refused(self):
        clock = FakeClock()
        with pytest.raises(ValueError):
            Router([ReplicaHandle(FakeReplica('x', clock=clock)),
                    ReplicaHandle(FakeReplica('x', clock=clock))],
                   clock=clock)


# ---------------------------------------------------------------------------
# the health verdict + journal handoff (fake replicas; the real-engine
# drill is TestFleetChaosDrill)
# ---------------------------------------------------------------------------


class TestFailover:

    def test_kill_mid_stream_hot_and_cold_handoff(self):
        from tpusystem_torch.observe.events import (ReplicaUnhealthy,
                                              RequestRerouted)
        clock = FakeClock()
        producer = Producer()
        seen = witness(producer, ReplicaUnhealthy, RequestRerouted)
        router, handles, stores = fake_fleet(clock, n=3)
        router.producer = producer
        # rep0 (rows=2) ends up with two seated rows and one queued one
        assert router.submit(Request('v-seated', [1], 8)) == 'rep0'
        assert router.submit(Request('bg1', [1], 4)) == 'rep1'
        assert router.submit(Request('bg2', [1], 4)) == 'rep2'
        assert router.submit(Request('v-seated2', [1], 8)) == 'rep0'
        clock.advance(1.0)
        router.step()                # seats both victims, emits 2 tokens
        assert router.submit(Request('bg3', [1], 4)) == 'rep1'
        assert router.submit(Request('bg4', [1], 4)) == 'rep2'
        # depths tie at 2 apiece: fleet order sends the victim to rep0
        assert router.submit(Request('v-queued', [1], 6)) == 'rep0'
        clock.advance(1.0)
        handles[0].kill()            # SIGKILL analogue; store survives
        tick = router.step()
        assert not handles[0].healthy
        moved = {event.id: event for event in tick.rerouted}
        assert moved['v-seated'].where == 'hot'
        assert moved['v-seated'].prefix >= 1
        assert moved['v-queued'].where == 'cold'
        assert {event.origin for event in tick.rerouted} == {'rep0'}
        placements_after = handles[0].placements
        results = router.run_until_idle()
        # never routed to the dead replica after the verdict
        assert handles[0].placements == placements_after
        # token-exact across the handoff: prefix + resumed == scripted
        for rid, budget in (('v-seated', 8), ('v-seated2', 8),
                            ('v-queued', 6)):
            assert results[rid].tokens == expected_tokens(rid, budget), rid
            assert results[rid].reason == 'length'
        kinds = {type(event).__name__ for event in seen}
        assert {'ReplicaUnhealthy', 'RequestRerouted'} <= kinds

    def test_cadence_gap_rows_resubmit_cold_from_routing_table(self):
        """A request routed AFTER the journal's last push exists only in
        the router's table — it must re-home cold, never drop."""
        clock = FakeClock()
        router, handles, stores = fake_fleet(clock, n=2, cadence=100)
        # cadence 100: nothing was ever pushed to the store
        assert router.submit(Request('a', [1], 5)) == 'rep0'
        handles[0].kill()
        tick = router.step()
        assert [event.id for event in tick.rerouted] == ['a']
        assert tick.rerouted[0].where == 'cold'
        results = router.run_until_idle()
        assert results['a'].tokens == expected_tokens('a', 5)

    def test_corrupt_local_journal_recovers_from_buddy(self, caplog):
        clock = FakeClock()
        store, buddy_store = MemStore(), MemStore()
        replica = FakeReplica('rep0', clock=clock, client=store)
        handle = ReplicaHandle(replica,
                               journal_clients=(store, buddy_store))
        survivor = ReplicaHandle(FakeReplica('rep1', clock=clock))
        router = Router([handle, survivor], clock=clock)
        assert router.submit(Request('a', [1], 6)) == 'rep0'
        router.step()                # seats + journals + pushes
        # mirror the push to the buddy (the supervisor replication
        # rider's job on a real pod), then corrupt the local copy
        entry = store.fetch('journal:rep0')
        buddy_store.put('journal:rep0', entry.step, entry.blob)
        store._slots[('journal:rep0', False)].blob = b'torn!'
        handle.kill()
        with caplog.at_level(logging.WARNING):
            tick = router.step()
        assert [event.id for event in tick.rerouted] == ['a']
        assert tick.rerouted[0].where == 'hot'   # the buddy copy had it
        results = router.run_until_idle()
        assert results['a'].tokens == expected_tokens('a', 6)

    def test_no_survivor_parks_orphans_until_adopt(self):
        clock = FakeClock()
        router, handles, stores = fake_fleet(clock, n=1)
        router.submit(Request('a', [1], 5))
        router.step()
        handles[0].kill()
        tick = router.step()
        assert tick.orphans == 1 and not tick.rerouted
        with pytest.raises(NoHealthyReplica):
            router.submit(Request('b', [1], 4))
        router.adopt(ReplicaHandle(FakeReplica('rep9', clock=clock)))
        results = router.run_until_idle()
        assert results['a'].tokens == expected_tokens('a', 5)
        assert results['a'].reason == 'length'

    def test_heartbeat_verdict_on_external_replica(self):
        clock = FakeClock()
        external = ReplicaHandle(FakeReplica('ext', clock=clock),
                                 external=True)
        survivor = ReplicaHandle(FakeReplica('rep1', clock=clock))
        router = Router([external, survivor], clock=clock,
                        heartbeat_timeout=5.0)
        assert router.submit(Request('a', [1], 4)) == 'ext'
        external.beat()
        router.step()                # beat stamped: still healthy
        assert external.healthy
        clock.advance(6.0)
        tick = router.step()         # stale: verdict + re-home
        assert not external.healthy
        assert external.cause.startswith('heartbeat')
        assert [event.id for event in tick.rerouted] == ['a']
        results = router.run_until_idle()
        assert results['a'].tokens == expected_tokens('a', 4)


# ---------------------------------------------------------------------------
# timeout retry + hedging (+ the TTFT-from-original-submission pin)
# ---------------------------------------------------------------------------


class TestRetryAndHedge:

    def test_timeout_reroutes_with_original_submission_accounting(self):
        """The satellite pin: a request retried on a second replica
        reports waited-time from ORIGINAL submission, not re-submission
        — threaded through restore(waited=) on the fake clock."""
        clock = FakeClock()
        wedged = ReplicaHandle(FakeReplica('wedge', clock=clock,
                                           wedged=True))
        healthy = ReplicaHandle(FakeReplica('ok', clock=clock))
        router = Router([wedged, healthy], clock=clock,
                        policy=RoutePolicy(timeout=10.0, max_retries=1))
        # empty fleet: ties break in fleet order, so the wedge seats it
        assert router.submit(Request('slow', [1], 4)) == 'wedge'
        router.step()                # seats, emits ONLY the admission token
        clock.advance(11.0)          # past the per-replica patience
        tick = router.step()
        moved = [event for event in tick.rerouted if event.id == 'slow']
        assert moved and moved[0].cause == 'timeout'
        assert moved[0].target == 'ok'
        assert moved[0].where == 'hot'   # the admission token carried over
        results = router.run_until_idle()
        completion = results['slow']
        # prefix (admission token on the wedge) + resumed, token-exact
        assert completion.tokens == expected_tokens('slow', 4)
        # latency counts from FIRST submission: the 11s on the wedge
        assert completion.seconds >= 11.0
        # TTFT on the second replica was accounted from the original
        # submission too: its scheduler saw a backdated submit time
        assert healthy.scheduler.results['slow'].seconds >= 11.0

    def test_retry_ladder_is_capped(self):
        clock = FakeClock()
        replicas = [ReplicaHandle(FakeReplica(f'w{i}', clock=clock,
                                              wedged=True))
                    for i in range(2)]
        router = Router(replicas, clock=clock,
                        policy=RoutePolicy(timeout=5.0, max_retries=2,
                                           retry_backoff=2.0))
        router.submit(Request('a', [1], 4))
        reroutes = 0
        for _ in range(30):
            clock.advance(21.0)      # far past every rung of the ladder
            reroutes += len(router.step().rerouted)
        assert reroutes == 2         # max_retries, then the ladder stops

    def test_hedge_first_completion_wins_loser_cancelled(self):
        clock = FakeClock()
        wedged = ReplicaHandle(FakeReplica('wedge', clock=clock,
                                           wedged=True))
        healthy = ReplicaHandle(FakeReplica('ok', clock=clock))
        router = Router([wedged, healthy], clock=clock,
                        policy=RoutePolicy(hedge_after=5.0))
        assert router.submit(Request('h', [1], 3)) == 'wedge'
        router.step()
        clock.advance(6.0)
        tick = router.step()         # hedge fires onto 'ok'
        hedges = [event for event in tick.rerouted
                  if event.cause == 'hedge']
        assert hedges and hedges[0].target == 'ok'
        assert router._routes['h'].hedged == 'ok'
        results = router.run_until_idle()
        assert results['h'].tokens == expected_tokens('h', 3)
        assert results['h'].reason == 'length'
        # the loser (the wedge) no longer holds the request
        assert wedged.scheduler.active == 0
        loser = wedged.scheduler.results.get('h')
        assert loser is not None and loser.reason == 'cancelled'

    def test_dead_hedge_leg_does_not_rehome_the_live_primary(self):
        clock = FakeClock()
        primary = ReplicaHandle(FakeReplica('p', clock=clock, wedged=True))
        hedge = ReplicaHandle(FakeReplica('h', clock=clock, wedged=True))
        router = Router([primary, hedge], clock=clock,
                        policy=RoutePolicy(hedge_after=2.0))
        assert router.submit(Request('a', [1], 4)) == 'p'
        router.step()
        clock.advance(3.0)
        router.step()                # hedged onto 'h'
        route = router._routes['a']
        assert route.hedged == 'h'
        hedge.kill()
        tick = router.step()
        assert route.hedged is None  # hedge leg cleared, primary lives
        assert not any(event.id == 'a' and event.cause == 'failover'
                       for event in tick.rerouted)
        assert route.handle == 'p' and primary.healthy


# ---------------------------------------------------------------------------
# fleet watermarks: global shed by slack, brownout front door
# ---------------------------------------------------------------------------


class TestFleetDegradation:

    def test_global_shed_picks_most_doomed_across_replicas(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(
            clock, n=2, rows=1,
            router_knobs={'watermarks': Watermarks(high=3, low=2)})
        # seat one long row per replica, then queue with distinct slacks
        router.submit(Request('seat0', [1], 20))
        router.submit(Request('seat1', [1], 20))
        router.step()
        router.submit(Request('doomed', [1], 8, deadline=2.0))   # rep0
        router.submit(Request('roomy', [1], 8, deadline=50.0))   # rep1
        router.submit(Request('patient', [1], 8))
        router.submit(Request('patient2', [1], 8))
        tick = router.step()
        # global depth 4 > high 3: shed to low 2 — deadline-carrying
        # victims first, ascending slack, ACROSS replicas ('doomed' on
        # rep0, then 'roomy' on rep1; no-deadline requests survive)
        shed_ids = [completion.request.id for completion, _ in tick.shed]
        assert shed_ids == ['doomed', 'roomy']
        assert router.results['doomed'].reason == 'shed'
        assert router.brownout

    def test_brownout_refuses_no_deadline_at_front_door(self):
        clock = FakeClock()
        router, handles, _ = fake_fleet(
            clock, n=2, rows=1,
            router_knobs={'watermarks': Watermarks(high=2, low=2)})
        for i in range(4):
            router.submit(Request(f'r{i}', [1], 30))
        router.step()                # seats one per replica, 2 queued
        router.submit(Request('q1', [1], 30))
        router.step()                # 3 queued > high 2 -> brownout
        assert router.brownout
        with pytest.raises(FleetSaturated):
            router.submit(Request('nodeadline', [1], 4))
        # deadline-carrying work still enters and competes by slack
        router.submit(Request('bounded', [1], 4, deadline=1e6))
        router.run_until_idle()
        assert not router.brownout   # drained back under the low mark
        router.submit(Request('after', [1], 3))
        assert router.run_until_idle()['after'].reason == 'length'

    def test_fleet_backpressure_narrated_on_toggle(self):
        from tpusystem_torch.observe.events import Backpressure, LoadShed
        clock = FakeClock()
        producer = Producer()
        seen = witness(producer, Backpressure, LoadShed)
        router, handles, _ = fake_fleet(
            clock, n=1, rows=1,
            router_knobs={'watermarks': Watermarks(high=1, low=0),
                          'producer': producer})
        for i in range(4):
            router.submit(Request(f'r{i}', [1], 2))
        router.run_until_idle()
        router.step()                # the drained fleet re-crosses the
        toggles = [event.engaged for event in seen   # low mark: released
                   if type(event).__name__ == 'Backpressure']
        assert toggles and toggles[0] is True and toggles[-1] is False
        assert any(type(event).__name__ == 'LoadShed' for event in seen)


# ---------------------------------------------------------------------------
# autoscale: grow on sustained backpressure, shrink on ebb
# ---------------------------------------------------------------------------


class TestAutoscale:

    def _fleet(self, clock, **policy):
        built, released = [], []

        def provision():
            replica = FakeReplica(f'grown{len(built)}', clock=clock)
            built.append(replica.identity)
            return ReplicaHandle(replica)

        router, handles, _ = fake_fleet(
            clock, n=1,
            router_knobs={'autoscale': AutoscalePolicy(**policy),
                          'provision': provision,
                          'release': released.append})
        return router, handles, built, released

    def test_sustained_backpressure_grows_then_ebb_shrinks(self):
        clock = FakeClock()
        from tpusystem_torch.observe.events import FleetResized
        router, handles, built, released = self._fleet(
            clock, min_replicas=1, max_replicas=3, grow_after=2,
            shrink_after=3, cooldown=0)
        producer = Producer()
        seen = witness(producer, FleetResized)
        router.producer = producer
        # the replica's own watermark flag is the pressure signal
        handles[0].scheduler.backpressure = True
        router.step()
        assert not built             # one pressured tick: not yet
        router.step()
        assert built == ['grown0']   # sustained -> grow
        handles[0].scheduler.backpressure = False
        for _ in range(4):
            router.step()            # sustained idleness -> shrink back
        assert released and released[0].name == 'grown0'
        resizes = [(event.action, event.replicas, event.name)
                   for event in seen
                   if type(event).__name__ == 'FleetResized']
        assert resizes == [('grow', 2, 'grown0'), ('shrink', 1, 'grown0')]

    def test_grow_capped_and_cooldown_rate_limits(self):
        clock = FakeClock()
        router, handles, built, _ = self._fleet(
            clock, min_replicas=1, max_replicas=2, grow_after=1,
            shrink_after=1000, cooldown=5)
        handles[0].scheduler.backpressure = True
        router.step()
        assert built == ['grown0']   # grow_after=1: first pressured tick
        for _ in range(4):
            router.step()            # inside the cooldown window
        assert built == ['grown0']
        for _ in range(5):
            router.step()            # cooldown over — but at max_replicas
        assert built == ['grown0']
        assert len(router.healthy) == 2

    def test_orphans_count_as_pressure_and_grow_adopts_them(self):
        clock = FakeClock()
        router, handles, built, _ = self._fleet(
            clock, min_replicas=1, max_replicas=2, grow_after=1,
            shrink_after=1000, cooldown=0)
        router.submit(Request('a', [1], 5))
        router.step()                # seats 'a', journals 2 tokens
        handles[0].kill()
        router.step()                # verdict: 'a' orphaned, then the
        assert built == ['grown0']   # orphan reads as pressure -> grow
        results = router.run_until_idle()
        assert results['a'].tokens == expected_tokens('a', 5)


# ---------------------------------------------------------------------------
# the real-engine fleet chaos drills
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def served():
    return Served('gpt2')


def real_fleet(P, served, clock, n=3, *, cadence=1, rows=2, producer=None,
               tracers=None, **engine_knobs):
    """N supervised replicas over real engines, each journaling into its
    own ``MemStore`` (what a kill leaves behind). With a ``tracers`` list,
    each replica's scheduler traces into its own ``P.Tracer`` (appended to
    the list) and the router into ``router.tracer``."""
    stores = [P.MemStore() for _ in range(n)]
    handles = []
    for i in range(n):
        tracer = None
        if tracers is not None:
            tracer = P.Tracer(f'rep{i}', clock=clock)
            tracers.append(tracer)

        def build(tracer=tracer):
            return P.Scheduler(served.engine(P, rows=rows, block_size=8,
                                             **engine_knobs), clock=clock,
                               tracer=tracer)
        replica = P.ServingReplica(build, identity=f'rep{i}',
                                   client=stores[i], cadence=cadence,
                                   clock=clock)
        handles.append(P.ReplicaHandle(replica))
    router = P.Router(handles, clock=clock, producer=producer,
                      tracer=None if tracers is None
                      else P.Tracer('router', clock=clock))
    return router, handles, stores


def mixed_workload(vocab=256, seed=7):
    rng = np.random.default_rng(seed)
    lengths = (5, 9, 7, 4, 11, 6, 8, 5, 10)
    budgets = (10, 8, 12, 6, 9, 11, 7, 12, 8)
    prompts = [rng.integers(0, vocab, (n,)).tolist() for n in lengths]
    return prompts, list(budgets)


def drive(router, wave, victims=(), max_steps=400):
    """Step the fleet to idle, firing the wave at its tick; returns (hot,
    cold, placements): whether both hand-off flavours were seen, and each
    victim's placement counter as of its verdict."""
    saw_hot = saw_cold = False
    placements = {}
    for _ in range(max_steps):
        if router.idle:
            break
        wave(router.ticks + 1)
        tick = router.step()
        for handle in victims:
            if not handle.healthy and handle.name not in placements:
                placements[handle.name] = handle.placements
        for event in tick.rerouted:
            saw_hot |= event.where == 'hot'
            saw_cold |= event.where == 'cold'
    assert router.idle, 'fleet never drained after the wave'
    return saw_hot, saw_cold, placements


def uninterrupted(P, served, clock, prompts, budgets, **levers):
    router, _, _ = real_fleet(P, served, clock, n=3, **levers)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        router.submit(P.Request(f'r{index}', prompt, budget))
    return router.run_until_idle()


def rerouted(events) -> list:
    return [(e.id, e.origin, e.target, e.where, e.prefix, e.cause)
            for e in events]


def _wave(P, served):
    prompts, budgets = mixed_workload()
    clock = FakeClock()
    reference = uninterrupted(P, served, clock, prompts, budgets)
    producer = P.Producer()
    seen = witness_in(P, producer, 'RequestRerouted', 'ReplicaUnhealthy')
    router, handles, _ = real_fleet(P, served, clock, n=3,
                                    producer=producer)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        router.submit(P.Request(f'r{index}', prompt, budget))
    wave = P.PreemptionWave(step=2, kills=(handles[0].kill,))
    saw_hot, saw_cold, placements = drive(router, wave,
                                          victims=(handles[0],))
    assert wave.fired and not handles[0].healthy
    assert set(router.results) == set(reference)
    for rid, completion in router.results.items():
        assert completion.tokens == reference[rid].tokens, rid
        assert completion.reason == reference[rid].reason, rid
    assert saw_hot and saw_cold, (saw_hot, saw_cold)
    assert handles[0].placements == placements['rep0']
    return plain(router.results), plain(seen)


def _traced_wave(P, served, tmp_path):
    """The wave drill traced: every replica's tracer merged into the
    router's, the export is valid Chrome trace JSON with ONE connected
    trace per request (the rerouted spans on the survivors parent to the
    original submission's trace, zero orphans), and some trace crosses
    engines. Returns the export's span tree."""
    prompts, budgets = mixed_workload()
    clock = FakeClock()
    tracers = []
    router, handles, _ = real_fleet(P, served, clock, n=3, tracers=tracers)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        router.submit(P.Request(f'r{index}', prompt, budget))
    wave = P.PreemptionWave(step=2, kills=(handles[0].kill,))
    drive(router, wave, victims=(handles[0],))
    assert wave.fired and not handles[0].healthy
    for tracer in tracers:
        router.tracer.merge(tracer)
    path = router.tracer.export(tmp_path / f'{P.root}-fleet-trace.json')
    payload = json.loads(path.read_text())
    events = [event for event in payload['traceEvents']
              if event['ph'] in ('X', 'i')]
    processes = {event['pid']: event['args']['name']
                 for event in payload['traceEvents'] if event['ph'] == 'M'}
    by_trace = P.connected_traces(payload['traceEvents'])     # 0 orphans
    for index in range(len(prompts)):
        rid = f'r{index}'
        roots = [event for event in events
                 if event['name'] == f'request {rid}']
        assert len(roots) == 1, (rid, len(roots))     # ONE trace each
        group = by_trace[roots[0]['args']['trace_id']]
        owners = {event['args'].get('request') for event in group}
        assert owners <= {rid, None}, (rid, owners)
    crossed = [trace_id for trace_id, group in by_trace.items()
               if len({processes[event['pid']] for event in group
                       if processes[event['pid']].startswith('rep')}) >= 2]
    assert crossed, 'no trace crossed engines after the handoff'
    return span_tree(payload['traceEvents'])


def _wave_levers(P, served):
    rng = np.random.default_rng(83)
    head = rng.integers(0, 256, (12,)).tolist()
    prompts = [head + rng.integers(0, 256, (k,)).tolist()
               for k in (5, 2, 4, 1, 3, 2, 5, 4, 3)]
    budgets = [10, 8, 12, 6, 9, 11, 7, 12, 8]
    clock = FakeClock()
    levers = dict(share_prefix=True, decode_impl='fused')
    reference = uninterrupted(P, served, clock, prompts, budgets, **levers)
    router, handles, _ = real_fleet(P, served, clock, n=3, **levers)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        router.submit(P.Request(f'r{index}', prompt, budget))
    wave = P.PreemptionWave(step=2, kills=(handles[0].kill,))
    saw_hot, saw_cold, _ = drive(router, wave, victims=(handles[0],))
    assert wave.fired and not handles[0].healthy
    assert saw_hot or saw_cold, 'the kill rerouted nothing'
    assert set(router.results) == set(reference)
    for rid, completion in router.results.items():
        assert completion.tokens == reference[rid].tokens, rid
        assert completion.reason == reference[rid].reason, rid
    hits = sum(handle.scheduler.engine.sharing['prefix_hits']
               for handle in handles[1:])
    assert hits > 0, 'no survivor adopted a shared prefix'
    return plain(router.results), hits


def _double_kill(P, served):
    prompts, budgets = mixed_workload()
    clock = FakeClock()
    reference = uninterrupted(P, served, clock, prompts, budgets)
    router, handles, stores = real_fleet(P, served, clock, n=3)
    buddy = P.MemStore()
    handles[1].journal_clients = (stores[1], buddy)
    for index, (prompt, budget) in enumerate(zip(prompts, budgets)):
        router.submit(P.Request(f'r{index}', prompt, budget))

    def tear_and_kill():
        entry = stores[1].fetch('journal:rep1')
        if entry is not None:    # mirror, then tear the local copy
            buddy.put('journal:rep1', entry.step, entry.blob)
            stores[1]._slots[('journal:rep1', False)].blob = b'torn'
        handles[1].kill()

    wave = P.PreemptionWave(step=3, kills=(handles[0].kill, tear_and_kill))
    _, _, placements = drive(router, wave, victims=handles[:2])
    assert [h.healthy for h in handles] == [False, False, True]
    assert handles[0].placements == placements['rep0']
    assert handles[1].placements == placements['rep1']
    assert set(router.results) == set(reference)
    for rid, completion in router.results.items():
        assert completion.tokens == reference[rid].tokens, rid
        assert completion.reason == reference[rid].reason, rid
    return plain(router.results)


class TestFleetChaosDrill:

    def test_preemption_wave_mid_stream_token_exact(self, served):
        """The acceptance drill: 3 replicas serving a mixed workload, a
        ``PreemptionWave`` kills one mid-stream; every journaled request
        completes token-exact against the uninterrupted fleet (hot hand-off
        for seated rows, cold for queued), nothing dropped, nothing routed
        to the dead replica after the verdict; the port's run is the
        reference's, event for event."""
        assert _wave(PORT, served) == _wave(REF, served)

    def test_preemption_wave_gives_one_connected_trace_per_request(
            self, served, tmp_path):
        """The trace-plane half of the reference's acceptance drill:
        every process's spans merged (the dead replica's included), one
        connected trace per request across the kill, on the port as on the
        reference, and the two exports' span trees equal."""
        assert _traced_wave(PORT, served, tmp_path) == _traced_wave(
            REF, served, tmp_path)

    def test_preemption_wave_with_sharing_and_fused_on(self, served):
        """The kill drill with ``share_prefix=True`` and
        ``decode_impl='fused'`` on every replica."""
        assert _wave_levers(PORT, served) == _wave_levers(REF, served)

    @pytest.mark.slow
    def test_double_kill_wave_with_buddy_journal(self, served):
        """A staggered wave takes two of three replicas; the second
        victim's local store is torn, so its rows come back through the
        buddy's copy, token-exact on the lone survivor."""
        assert _double_kill(PORT, served) == _double_kill(REF, served)


# ---------------------------------------------------------------------------
# test_serve_sampling.py: reroute and hedging stay bitwise with sampling
# ---------------------------------------------------------------------------


SAMPLED = dict(seed=11, temperature=0.9, top_k=16, top_p=0.95)


def _reroute_sampled(P, served):
    rng = np.random.default_rng(23)
    specs = [('s0', list(rng.integers(0, 256, (6,))), 9, SAMPLED),
             ('s1', list(rng.integers(0, 256, (5,))), 8,
              dict(seed=29, temperature=1.1, top_p=0.9)),
             ('g0', list(rng.integers(0, 256, (7,))), 8, None)]

    def requests():
        return [P.Request(rid, prompt, budget,
                          sampling=None if sampling is None
                          else P.SamplingParams(**sampling))
                for rid, prompt, budget, sampling in specs]
    reference_router, _, _ = real_fleet(P, served, FakeClock(), n=2)
    for request in requests():
        reference_router.submit(request)
    reference = reference_router.run_until_idle()
    router, handles, _ = real_fleet(P, served, FakeClock(), n=2)
    for request in requests():
        router.submit(request)
    wave = P.PreemptionWave(step=2, kills=(handles[0].kill,))
    moved = []
    for _ in range(200):
        if router.idle:
            break
        wave(router.ticks + 1)
        moved += [e for e in router.step().rerouted if e.cause == 'failover']
    assert router.idle and wave.fired and not handles[0].healthy
    assert any(e.where == 'hot' for e in moved)
    assert set(router.results) == set(reference)
    for rid, completion in router.results.items():
        assert completion.tokens == reference[rid].tokens, rid
    return plain(router.results), rerouted(moved)


@pytest.mark.slow
def test_fleet_reroute_mid_sample_is_bitwise(served):
    assert _reroute_sampled(PORT, served) == _reroute_sampled(REF, served)


def _hedged_sampled(P, served):
    prompt = list(np.random.default_rng(31).integers(0, 256, (5,)))
    single = P.Scheduler(served.engine(P, rows=2, block_size=8))
    single.submit(P.Request('ref', prompt, 8,
                            sampling=P.SamplingParams(**SAMPLED)))
    ref = single.run()['ref'].tokens
    clock = FakeClock()
    router, handles, _ = real_fleet(P, served, clock, n=2)
    router.policy = P.RoutePolicy(hedge_after=5.0)
    origin = router.submit(P.Request('h', prompt, 8,
                                     sampling=P.SamplingParams(**SAMPLED)))
    router.step()
    clock.advance(6.0)
    tick = router.step()               # the duplicate fires
    hedges = [e for e in tick.rerouted if e.cause == 'hedge']
    assert hedges and hedges[0].target != origin
    results = router.run_until_idle()
    assert results['h'].tokens == ref and results['h'].reason == 'length'
    loser = next(h for h in handles if h.name == hedges[0].target)
    partial = loser.scheduler.results['h']
    assert partial.reason == 'cancelled'
    assert 0 < len(partial.tokens) < len(ref)
    assert partial.tokens == ref[:len(partial.tokens)]   # identical stream
    return plain(results), plain(partial)


@pytest.mark.slow
def test_hedged_sampled_duplicates_emit_identical_streams(served):
    assert _hedged_sampled(PORT, served) == _hedged_sampled(REF, served)


# ---------------------------------------------------------------------------
# observability: the fleet events chart, and the router's traces
# ---------------------------------------------------------------------------


def test_tensorboard_fleet_handlers_chart_the_events(tmp_path):
    from tests.tb import read_scalars
    from tpusystem_torch.observe.events import (FleetResized,
                                                ReplicaUnhealthy,
                                                RequestRerouted)
    from tpusystem_torch.observe.tensorboard import (SummaryWriter,
                                                     tensorboard_consumer,
                                                     writer)

    consumer = tensorboard_consumer()
    board = SummaryWriter(tmp_path)
    consumer.dependency_overrides[writer] = lambda: board
    consumer.consume(ReplicaUnhealthy(name='rep0', cause='died mid-step',
                                      routed=3))
    consumer.consume(RequestRerouted(id='a', origin='rep0', target='rep1',
                                     where='hot', prefix=4,
                                     cause='failover'))
    consumer.consume(FleetResized(action='grow', replicas=4,
                                  cause='backpressure', name='rep3'))
    board.flush()
    scalars = read_scalars(tmp_path)        # parsed back, not byte-poked
    assert scalars['fleet/unhealthy_total'] == (1.0, 1)
    assert scalars['fleet/rehomed_requests'] == (3.0, 1)
    assert scalars['fleet/rerouted_total'] == (1.0, 1)
    assert scalars['fleet/reroute_prefix'] == (4.0, 1)
    assert scalars['fleet/replicas'] == (4.0, 1)


def test_refused_submit_resets_the_trace_for_a_retry():
    """FleetSaturated's contract is retry-later: the refusal closes its
    root span truthfully AND unbinds it from the request, so the retry
    roots a fresh trace instead of parenting into a closed one."""
    from tpusystem_torch.observe import Tracer

    clock = FakeClock()
    tracer = Tracer('router', clock=clock)
    router, handles, _ = fake_fleet(clock, n=1, max_queued=1,
                                    router_knobs={'tracer': tracer})
    assert router.submit(Request('r0', [1], 8)) == 'rep0'
    refused = Request('r1', [1], 8)
    with pytest.raises(FleetSaturated):
        router.submit(refused)
    assert refused.trace is None         # unbound for the retry
    refusal_roots = [e for e in tracer.events()
                     if e['name'] == 'request r1' and e['ph'] == 'X']
    assert refusal_roots[0]['args']['reason'] == 'refused'
    # backlog drains; the retry lands and roots a SECOND, fresh trace
    router.run_until_idle()
    assert router.submit(refused) == 'rep0'
    router.run_until_idle()
    roots = [e for e in tracer.events() if e['name'] == 'request r1']
    assert len(roots) == 2
    assert len({e['args']['trace_id'] for e in roots}) == 2


def test_invalid_submit_closes_the_trace_root_before_reraising():
    """A request that can never run re-raises the scheduler's ValueError to
    the caller, and the router closes its root span (reason 'invalid')
    and unbinds ``request.trace``: no open phantom root per bad
    submission."""
    from tpusystem_torch.observe import Tracer

    clock = FakeClock()
    tracer = Tracer('router', clock=clock)

    class Oversized(FakeScheduler):
        def submit(self, request):
            raise ValueError(f'{request.id!r}: exceeds engine capacity')

    replica = FakeReplica('rep0', clock=clock)
    replica.scheduler = Oversized(clock=clock)
    router = Router([ReplicaHandle(replica)], clock=clock, tracer=tracer)
    bad = Request('bad', [1], 10_000)
    with pytest.raises(ValueError, match='capacity'):
        router.submit(bad)
    assert bad.trace is None
    assert router._trace_roots == {}
    (root,) = [e for e in tracer.events() if e['ph'] == 'X']
    assert root['args']['reason'] == 'invalid'
    assert 'open' not in root['args']
