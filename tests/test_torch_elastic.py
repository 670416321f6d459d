"""The port's elastic membership (``tpusystem_torch.parallel.elastic``),
held to the reference's tests.

Twins of ``tests/test_elastic.py``'s ``TestProtocol`` and
``TestResizeDecision`` (13 tests): the :class:`ElasticCoordinator`
settle/propose/commit machine driven by a fake clock over stub transports.
Then the port's own: the same scripted waves through both packages give
the same decisions and events; a wave over real TCP transports (a hub and
three coordinators, one transport killed) commits one resize; the
one-device pieces (``split_pieces``, ``collect_pieces`` over the blob
plane, ``elastic_resume``) restore bit for bit, and fall back to disk.
``TestResharding``, ``TestWaveDrill`` and ``tests/test_chaos.py``'s
``TestBuddyDoubleLoss`` run in one world of four port processes
(``tests/torch_ranks.py``, gloo on the CPU): a placed leaf's pieces on an
fsdp=4 mesh, each rank's own control plane (the hub on rank 0), a wave
that kills hosts' transports, and the survivors' mesh built over their
ranks.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from tpusystem_torch.parallel.elastic import (ElasticCoordinator,
                                              ElasticPolicy, ResizeDecision,
                                              collect_pieces, elastic_resume,
                                              split_pieces)
from tpusystem_torch.observe.events import (ElasticTimeline,
                                            WorldResizeProposed,
                                            WorldResized)
from tpusystem_torch.services.prodcon import Consumer, Producer

IDENTITY = 'elastic-drill'


def wait_until(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# ---------------------------------------------------------------------------
# protocol: fake clock, stub transports, no sockets


class FakeClock:
    def __init__(self):
        self.time = 0.0

    def __call__(self):
        return self.time

    def advance(self, seconds):
        self.time += seconds


class StubTransport:
    """The coordinator-facing transport surface, wires replaced by lists."""

    def __init__(self, rank):
        self.rank = rank
        self._channels = {}
        self.on_control = None
        self.outbox = []

    def subscribe(self, channel, callback):
        self._channels[channel] = callback

    def send_event(self, channel, message):
        self.outbox.append((channel, message))

    def deliver(self, channel, message):
        self._channels[channel](message)


def capture_elastic(producer=None):
    producer = producer or Producer()
    seen = []
    consumer = Consumer()
    for kind in (WorldResizeProposed, WorldResized, ElasticTimeline):
        consumer.register(kind, seen.append)
    producer.register(consumer)
    return producer, seen


class Pod:
    """A stub supervisor pod: coordinators + hand-cranked frame routing."""

    def __init__(self, size, clock, policy, capture_rank=0):
        self.clock = clock
        self.live = set(range(size))
        self.stubs = [StubTransport(rank) for rank in range(size)]
        self.producer, self.seen = capture_elastic()
        self.coords = [
            ElasticCoordinator(
                self.stubs[rank], rank, size, policy=policy, clock=clock,
                producer=self.producer if rank == capture_rank else None)
            for rank in range(size)]

    def lose(self, rank):
        """The hub's 'lost' fanout: every other live host hears it (and
        ingests it now — the live coordinator's poll thread would)."""
        self.live.discard(rank)
        for survivor in self.live:
            self.stubs[survivor].on_control(('lost', rank, 0.0, 'socket'))
        for survivor in sorted(self.live):
            self.coords[survivor].step()

    def join(self, rank):
        """The hub's 'joined' fanout (excludes the joiner itself) — for a
        host whose original coordinator is still running (a flapped
        link, a fast rejoin)."""
        for other in self.live:
            if other != rank:
                self.stubs[other].on_control(('joined', rank))
        self.live.add(rank)
        for member in sorted(self.live):
            self.coords[member].step()

    def replace(self, rank, policy):
        """A replacement host: fresh transport + bootstrapping coordinator
        (``members=None`` — it adopts the first proposal that includes
        it)."""
        while len(self.stubs) <= rank:
            self.stubs.append(None)
            self.coords.append(None)
        self.stubs[rank] = StubTransport(rank)
        self.coords[rank] = ElasticCoordinator(
            self.stubs[rank], rank, policy=policy, clock=self.clock,
            members=None)
        self.join(rank)

    def pump(self, rounds=6):
        """Step every live coordinator and route every broadcast frame to
        every OTHER live host — the hub's event fanout, hand-cranked."""
        for _ in range(rounds):
            for rank in sorted(self.live):
                self.coords[rank].step()
            for rank in sorted(self.live):
                stub = self.stubs[rank]
                while stub.outbox:
                    channel, message = stub.outbox.pop(0)
                    for other in sorted(self.live):
                        if other != rank:
                            self.stubs[other].deliver(channel, message)


class TestProtocol:

    def policy(self, **overrides):
        knobs = dict(settle_window=1.0, rebroadcast=100.0)
        knobs.update(overrides)
        return ElasticPolicy(**knobs)

    def test_wave_folds_multiple_losses_into_one_resize(self):
        """The headline property: 2 losses inside one settle window are
        ONE membership epoch, not two resizes."""
        clock = FakeClock()
        pod = Pod(5, clock, self.policy())
        pod.lose(3)
        pod.pump()
        assert not any(coord.decisions for coord in pod.coords)
        clock.advance(0.5)
        pod.lose(4)                        # extends the settle window
        pod.pump()
        clock.advance(0.9)                 # 1.4 < 0.5 + 1.0... just under
        pod.pump()
        assert not any(pod.coords[rank].decisions for rank in pod.live)
        clock.advance(0.2)                 # the window closes
        pod.pump()
        for rank in pod.live:
            assert pod.coords[rank].decisions == [
                ResizeDecision(epoch=1, members=(0, 1, 2))]
        resized = [e for e in pod.seen if isinstance(e, WorldResized)]
        assert len(resized) == 1           # ONE resize for the whole wave
        assert resized[0].size == 3 and resized[0].epoch == 1
        proposed = [e for e in pod.seen
                    if isinstance(e, WorldResizeProposed)]
        assert proposed and proposed[0].cause == 'loss'

    def test_commit_requires_every_proposed_member(self):
        clock = FakeClock()
        pod = Pod(3, clock, self.policy())
        pod.lose(2)
        clock.advance(1.1)
        pod.coords[0].step()               # proposes; only its own vote
        assert pod.coords[0].step() is None
        pod.coords[1].step()               # rank 1 proposes too
        channel, message = pod.stubs[1].outbox.pop(0)
        pod.stubs[0].deliver(channel, message)
        decision = pod.coords[0].step()    # now every member voted
        assert decision == ResizeDecision(epoch=1, members=(0, 1))

    def test_min_world_holds_until_capacity_returns(self):
        clock = FakeClock()
        pod = Pod(4, clock, self.policy(min_world=3))
        pod.lose(2)
        pod.lose(3)
        clock.advance(1.1)
        pod.pump()
        assert not pod.coords[0].decisions     # would shrink below min
        pod.join(3)                            # capacity returns
        clock.advance(1.1)
        pod.pump()
        for rank in pod.live:
            assert pod.coords[rank].decisions[-1].members == (0, 1, 3)

    def test_loss_flapping_back_within_the_window_cancels_the_wave(self):
        clock = FakeClock()
        pod = Pod(3, clock, self.policy())
        pod.lose(2)
        clock.advance(0.5)
        pod.join(2)                        # the link flaked, host is back
        clock.advance(1.1)
        pod.pump()
        assert not any(coord.decisions for coord in pod.coords)
        assert pod.coords[0].members == (0, 1, 2)

    def test_cooldown_defers_the_next_wave(self):
        clock = FakeClock()
        pod = Pod(4, clock, self.policy(cooldown=5.0))
        pod.lose(3)
        clock.advance(1.1)
        pod.pump()
        assert pod.coords[0].decisions[-1].epoch == 1
        pod.lose(2)
        clock.advance(1.1)                 # settle passed, cooldown not
        pod.pump()
        assert len(pod.coords[0].decisions) == 1
        clock.advance(5.0)                 # cooldown expires
        pod.pump()
        assert pod.coords[0].decisions[-1] == ResizeDecision(
            epoch=2, members=(0, 1))

    def test_replacement_host_bootstraps_from_the_first_proposal(self):
        clock = FakeClock()
        policy = self.policy()
        pod = Pod(3, clock, policy)
        pod.lose(2)
        clock.advance(1.1)
        pod.pump()
        assert pod.coords[0].members == (0, 1)
        pod.replace(2, policy)             # fresh coordinator, members=None
        clock.advance(1.1)
        pod.pump()
        for rank in (0, 1, 2):
            assert pod.coords[rank].decisions[-1] == ResizeDecision(
                epoch=2, members=(0, 1, 2))
        assert pod.coords[2].members == (0, 1, 2)
        assert pod.coords[2].epoch == 2

    def test_max_world_caps_the_grow(self):
        clock = FakeClock()
        policy = self.policy(max_world=3)
        pod = Pod(2, clock, policy)
        pod.replace(2, policy)
        pod.replace(3, policy)             # one joiner too many
        clock.advance(1.1)
        pod.pump()
        assert pod.coords[0].decisions[-1].members == (0, 1, 2)
        assert pod.coords[3].members is None     # left pending the cap

    def test_flapped_out_host_adopts_the_readmission_epoch(self):
        """Review regression: a host flapped OUT of a committed shrink
        (it never saw the epoch) is later re-admitted — the peers'
        higher-epoch proposal names the host's own stale member set, so
        the old code computed no diff and silently dropped it, stalling
        the commit forever. It must adopt-and-echo like a bootstrap."""
        clock = FakeClock()
        pod = Pod(3, clock, self.policy())
        pod.lose(0)                        # rank 0 flaps out, sees nothing
        clock.advance(1.1)
        pod.pump()
        for rank in (1, 2):
            assert pod.coords[rank].decisions == [
                ResizeDecision(epoch=1, members=(1, 2))]
        assert pod.coords[0].epoch == 0    # it missed the whole epoch
        pod.join(0)                        # the link comes back
        clock.advance(1.1)
        pod.pump()
        for rank in (0, 1, 2):
            assert pod.coords[rank].decisions[-1] == ResizeDecision(
                epoch=2, members=(0, 1, 2)), rank
        assert pod.coords[0].epoch == 2

    def test_capped_joiner_stays_pending_for_the_next_wave(self):
        """Review regression: a joiner held out by max_world used to be
        silently cleared when the settle window closed; the policy's
        contract is that it waits for a later wave with room."""
        clock = FakeClock()
        policy = self.policy(max_world=2)
        pod = Pod(2, clock, policy)
        pod.replace(2, policy)             # no room: world is at the cap
        clock.advance(1.1)
        pod.pump()
        assert not pod.coords[0].decisions
        pod.lose(1)                        # room opens
        clock.advance(1.1)
        pod.pump()
        assert pod.coords[0].decisions[-1] == ResizeDecision(
            epoch=1, members=(0, 2))       # the pending joiner folded in
        assert pod.coords[2].members == (0, 2)

    def test_close_unhooks_the_transport_and_ignores_late_frames(self):
        """A coordinator outlived by its transport (a replacement host
        builds a NEW coordinator on the same wire) must go inert on
        close: no unbounded inbox growth, and the on_control chain head
        restored."""
        clock = FakeClock()
        stub = StubTransport(0)
        policy = self.policy()
        first = ElasticCoordinator(stub, 0, 3, policy=policy, clock=clock)
        second = ElasticCoordinator(stub, 0, 3, policy=policy, clock=clock)
        second.close()
        stub.on_control(('lost', 2, 0.0, 'socket'))   # reaches FIRST only
        first.step()
        assert first._lost == {2}
        assert second._inbox.empty()       # closed: frames not hoarded
        second._ingest(('lost', 1, 0.0, 'socket'))
        assert second._inbox.empty()
        first.close()
        assert stub.on_control is None     # fully unhooked

    def test_elastic_consumer_raises_at_the_drain(self):
        """The worker-side 46 path: a committed WorldResized event raises
        WorldResizedError from the bus drain, mapping to RESIZED_EXIT."""
        from tpusystem_torch.parallel.elastic import elastic_consumer
        from tpusystem_torch.parallel.recovery import (RESIZED_EXIT,
                                                 WorldResizedError,
                                                 exit_for_restart)
        producer = Producer()
        producer.register(elastic_consumer())
        with pytest.raises(WorldResizedError) as excinfo:
            producer.dispatch(WorldResized(epoch=2, members=[0, 2], size=2,
                                           seconds=0.1))
        assert excinfo.value.epoch == 2
        assert excinfo.value.members == (0, 2)
        assert exit_for_restart(excinfo.value).code == RESIZED_EXIT

    def test_straggler_completes_via_the_reecho(self):
        """Events are at-most-once: a rank whose pre-commit proposals were
        all dropped must still commit — the committed side re-echoes when
        it sees the straggler's rebroadcast."""
        clock = FakeClock()
        pod = Pod(3, clock, self.policy(rebroadcast=0.5))
        pod.lose(2)
        clock.advance(1.1)
        pod.coords[0].step()
        pod.stubs[0].outbox.clear()        # 0's proposal is dropped
        pod.coords[1].step()               # 1 proposes
        channel, message = pod.stubs[1].outbox.pop(0)
        pod.stubs[0].deliver(channel, message)
        assert pod.coords[0].step() is not None      # 0 commits
        assert not pod.coords[1].decisions           # 1 is the straggler
        clock.advance(0.6)                           # 1 rebroadcasts
        pod.coords[1].step()
        channel, message = pod.stubs[1].outbox.pop(0)
        pod.stubs[0].deliver(channel, message)
        pod.coords[0].step()                         # committed 0 re-echoes
        channel, message = pod.stubs[0].outbox.pop(0)
        pod.stubs[1].deliver(channel, message)
        assert pod.coords[1].step() is not None
        assert pod.coords[1].decisions == pod.coords[0].decisions


class TestResizeDecision:

    def test_rank_and_buddy_derivation(self):
        decision = ResizeDecision(epoch=3, members=(0, 2, 5, 7))
        assert decision.size == 4
        assert [decision.rank_of(m) for m in decision.members] == [0, 1, 2, 3]
        # buddies pair within the NEW dense ordering: (0,2) and (5,7)
        assert decision.buddy_of(0) == 2 and decision.buddy_of(2) == 0
        assert decision.buddy_of(5) == 7 and decision.buddy_of(7) == 5
        odd = ResizeDecision(epoch=1, members=(1, 4, 6))
        assert odd.buddy_of(6) is None     # the unpaired last member

    def test_env_round_trip(self):
        decision = ResizeDecision(epoch=2, members=(0, 3))
        env = decision.env(3)
        assert ResizeDecision.from_env(env) == (decision, 3)
        assert ResizeDecision.from_env({}) is None
        assert ResizeDecision.from_env(
            {'TPUSYSTEM_ELASTIC': 'not json'}) is None


# ---------------------------------------------------------------------------
# the port's own


def _scripted_wave(elastic, events, prodcon):
    """A 4-host pod of one package's coordinators, hand-cranked: hosts 2
    and 3 die inside one settle window (one shrink), then host 3 returns
    as a replacement (one grow). The decisions and narrated events."""
    clock = FakeClock()
    policy = elastic.ElasticPolicy(settle_window=1.0, rebroadcast=100.0)
    producer = prodcon.Producer()
    seen = []
    consumer = prodcon.Consumer()
    for kind in (events.WorldResizeProposed, events.WorldResized,
                 events.ElasticTimeline):
        consumer.register(kind, seen.append)
    producer.register(consumer)
    stubs = {rank: StubTransport(rank) for rank in range(4)}
    coords = {rank: elastic.ElasticCoordinator(
        stubs[rank], rank, 4, policy=policy, clock=clock,
        producer=producer if rank == 0 else None) for rank in range(4)}
    live = {0, 1, 2, 3}

    def pump():
        for _ in range(6):
            for rank in sorted(live):
                coords[rank].step()
            for rank in sorted(live):
                while stubs[rank].outbox:
                    channel, message = stubs[rank].outbox.pop(0)
                    for other in sorted(live - {rank}):
                        stubs[other].deliver(channel, message)
    for lost in (2, 3):
        live.discard(lost)
        for survivor in sorted(live):
            stubs[survivor].on_control(('lost', lost, 0.0, 'socket'))
        clock.advance(0.4)
        pump()
    clock.advance(1.1)
    pump()
    coords[0].resumed(step=7, source='hot-reshard', reshard=0.25)
    stubs[3] = StubTransport(3)
    coords[3] = elastic.ElasticCoordinator(stubs[3], 3, policy=policy,
                                           clock=clock, members=None)
    for other in sorted(live):
        stubs[other].on_control(('joined', 3))
    live.add(3)
    pump()
    clock.advance(1.1)
    pump()
    decisions = {rank: [(d.epoch, d.members) for d in coords[rank].decisions]
                 for rank in sorted(live)}
    narrated = [(type(event).__name__, getattr(event, 'epoch', None),
                 list(getattr(event, 'members', []) or []),
                 getattr(event, 'cause', None), getattr(event, 'size', None),
                 getattr(event, 'stages', None)) for event in seen]
    return decisions, narrated


def test_a_scripted_wave_decides_as_the_reference_does():
    from tpusystem.observe import events as jax_events
    from tpusystem.parallel import elastic as jax_elastic
    from tpusystem.services import prodcon as jax_prodcon
    from tpusystem_torch.observe import events
    from tpusystem_torch.parallel import elastic
    from tpusystem_torch.services import prodcon
    want = _scripted_wave(jax_elastic, jax_events, jax_prodcon)
    got = _scripted_wave(elastic, events, prodcon)
    assert got == want
    decisions, narrated = got
    assert decisions[0] == [(1, (0, 1)), (2, (0, 1, 3))]
    assert decisions[3] == [(2, (0, 1, 3))]
    assert [name for name, *_ in narrated].count('WorldResized') == 2


def test_a_wave_over_tcp_transports_commits_one_resize():
    """Three coordinators on a real hub (port 0): one transport dies
    without a 'bye'; the survivors hear the hub's 'lost' fanout, settle,
    exchange proposals over the event plane and commit ONE resize."""
    from tpusystem_torch.parallel.multihost import Hub, TcpTransport
    hub = Hub(3)
    transports = [TcpTransport(hub.address, rank, 3) for rank in range(3)]
    policy = ElasticPolicy(settle_window=0.3, rebroadcast=0.1)
    coords = []
    try:
        assert wait_until(lambda: len(hub._clients) == 3)
        coords = [ElasticCoordinator(transports[rank], rank, 3,
                                     policy=policy).start(interval=0.02)
                  for rank in range(3)]
        transports[2]._sock.shutdown(__import__('socket').SHUT_RDWR)
        assert wait_until(lambda: all(coords[rank].decisions
                                      for rank in (0, 1)))
        time.sleep(0.5)                     # no second resize follows
        for rank in (0, 1):
            assert coords[rank].decisions == [ResizeDecision(1, (0, 1))]
            assert coords[rank].members == (0, 1)
    finally:
        for coord in coords:
            coord.close()
        for transport in transports:
            transport.close()
        hub.close()


def _train_state(seed=0):
    import torch

    from tpusystem_torch import train as ttrain
    from tpusystem_torch.models import MLP
    module = MLP(features=(16,), classes=3, features_in=8, device='cpu')
    module.init_weights(torch.Generator().manual_seed(seed))
    optimizer = ttrain.Adam(lr=1e-2)
    state = ttrain.init_state(module, optimizer, rng=seed)
    step = ttrain.build_train_step(ttrain.module_apply(module),
                                   ttrain.CrossEntropyLoss(), optimizer)
    inputs = torch.linspace(-1, 1, 32).reshape(4, 8)
    labels = torch.tensor([0, 1, 2, 1])
    state, _ = step(state, inputs, labels)
    return state


def _tensors(state):
    from tpusystem_torch.checkpoint.checkpointer import flatten_state
    return [(path, leaf.clone() if hasattr(leaf, 'clone') else leaf)
            for path, leaf in flatten_state(state)]


def _zero(state):
    import torch
    with torch.no_grad():
        for tensor in list(state.params.values()):
            tensor.zero_()
    return state


def test_split_pieces_on_the_one_device_mesh():
    """The port's mesh is one device: it splits over one host (every
    tensor leaf one whole piece, host values as they are) and refuses any
    other count with the reference's ``ValueError``."""
    import pickle

    from tpusystem_torch.checkpoint.memstore import ShardedLeaf
    from tpusystem_torch.parallel import single_device_mesh
    state = _train_state()
    mesh = single_device_mesh('cpu')
    (blob,) = split_pieces(state, mesh, 1)
    leaves = pickle.loads(blob)
    pieces = [leaf for leaf in leaves if isinstance(leaf, ShardedLeaf)]
    assert pieces and all(len(piece.shards) == 1 for piece in pieces)
    with pytest.raises(ValueError, match='do not split over 2 hosts'):
        split_pieces(state, mesh, 2)


def test_collected_pieces_resume_bitwise_and_fall_back_to_disk(tmp_path):
    """``collect_pieces`` gathers a world's hot pieces (its own slot, a
    survivor's over the blob plane, a lost member's from its buddy's
    replica), ``elastic_resume`` merges and restores them into the target
    bit for bit ('hot-reshard'); pieces older than the newest committed
    disk step lose to disk."""
    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.checkpoint.memstore import (HotState, MemStore,
                                                     blob_digest, pack_hot)
    from tpusystem_torch.parallel import single_device_mesh
    from tpusystem_torch.parallel.multihost import Hub, TcpTransport
    state = _train_state()
    want = _tensors(state)
    (blob,) = split_pieces(state, single_device_mesh('cpu'), 1)
    entry = HotState(step=5, digest=blob_digest(blob), blob=blob)
    store = MemStore()
    store.put(IDENTITY, 5, blob)
    hub = Hub(2)
    transports = [TcpTransport(hub.address, rank, 2) for rank in range(2)]
    served = {f'own:1:{IDENTITY}': pack_hot(entry),
              f'hot:2:{IDENTITY}': pack_hot(entry)}
    transports[1].on_blob_request = served.get
    try:
        assert wait_until(lambda: len(hub._clients) == 2)
        entries = collect_pieces(IDENTITY, rank=0, members=[0, 1, 2],
                                 survivors=[0, 1], store=store,
                                 transport=transports[0],
                                 buddy_of={2: 1}.get, timeout=10)
    finally:
        for transport in transports:
            transport.close()
        hub.close()
    assert [entry.step for entry in entries] == [5, 5, 5]
    checkpointer = Checkpointer(tmp_path / 'ckpt')
    restored, step, _, source = elastic_resume(
        checkpointer, IDENTITY, _zero(state), entries)
    assert (step, source) == (5, 'hot-reshard')
    for (path, got), (_, value) in zip(_tensors(restored), want):
        assert got.equal(value) if hasattr(got, 'equal') else got == value, \
            path
    checkpointer.save(IDENTITY, 6, restored)
    checkpointer.wait()
    restored, step, _, source = elastic_resume(
        checkpointer, IDENTITY, _zero(state), entries)
    assert (step, source) == (6, 'disk')
    for (path, got), (_, value) in zip(_tensors(restored), want):
        assert got.equal(value) if hasattr(got, 'equal') else got == value, \
            path


# ---------------------------------------------------------------------------
# resharding across ranks: one world of four port processes


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    from tests import torch_ranks
    root = tmp_path_factory.mktemp('elastic-ranks')
    return torch_ranks.launch(root, dict(
        scenarios=['resharding', 'wave', 'double_loss'],
        root=str(root / 'ckpt')), ranks=4)


class TestResharding:

    def test_sharded_leaf_merges_and_reshards_across_meshes(self, world):
        """Four ranks' data-sharded pieces of one [8, 8] array, split over
        two 'hosts' and merged back (four pieces), refuse the data=2 slice
        boundaries without ``reshard`` and land on them bit for bit with
        it; one host's pieces alone do not cover the array."""
        for result in world:
            record = result['resharding']
            assert record['pieces'] == 4
            assert 'do not cover' in record['errors']['exact']
            assert 'cover only' in record['errors']['one_host']
            assert record['exact'] and record['placements']


class TestWaveDrill:

    def test_kill_two_of_four_resize_once_reshard_bitwise_grow_back(
            self, world):
        """fsdp=4 (every rank holds unique pieces), TP rules with FSDP: two
        steps, each checkpointed (gathered, rank 0 writes) and each rank's
        pieces pushed to its supervisor (buddy ``rank ^ 1``). Ranks 1 and 3
        die in one wave: one resize to (0, 2); each survivor collects all
        four hosts' pieces (its own, the peer's, the lost buddies'
        replicas), reshards them onto the survivors' fsdp=2 mesh bit for
        bit the disk restore, and trains on; host 3 returns and the world
        grows to (0, 2, 3)."""
        for rank in (0, 2):
            record = world[rank]['wave']
            assert record['decisions'] == [(1, (0, 2))]
            assert record['buddy_of_0'] == 2
            assert record['pieces'] == 4
            assert record['source'] == 'hot-reshard', record
            assert record['at'] == 2 and record['extras'] == {'step': 2}
            assert record['bitwise']
            assert record['step'] == 3 and np.isfinite(record['loss'])
            assert record['grown'] == (0, 2, 3)
        assert world[3]['wave']['grown'] == (0, 2, 3)
        assert world[0]['wave']['loss'] == world[2]['wave']['loss']
        assert world[0]['wave']['resized'] == [2, 3]
        assert world[0]['wave']['timelines'] == [('hot-reshard', 2)]
        assert all(result['wave']['fired'] for result in world)


class TestBuddyDoubleLoss:

    def test_double_buddy_loss_falls_back_to_disk(self, world):
        """Ranks 2 and 3, a buddy pair, die in one wave: their pieces lived
        only in each other's replica slots, so each survivor collects two
        contributions, the hot tier cannot cover the state and the resize
        falls back to disk, bit for bit the last committed step, and trains
        on identically."""
        for rank in (0, 1):
            record = world[rank]['double_loss']
            assert record['decisions'] == [(1, (0, 1))]
            assert record['pieces'] == 2
            assert record['source'] == 'disk' and record['at'] == 2
            assert record['bitwise']
            assert np.isfinite(record['resumed'])
            assert record['resumed'] == record['reference']
            text = ' '.join(record['warnings'])
            assert 'no surviving buddy' in text
            assert 'restore from disk' in text
