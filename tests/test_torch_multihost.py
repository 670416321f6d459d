"""The port's multi-process control plane, held to the reference's tests.

Twins of ``tests/test_multihost.py`` (``TestTransport``,
``TestDistributedProducer``, ``TestDistributedPublisher``,
``TestAgreement``, ``TestSharedTransport``, ``TestFailureDetection``,
``TestRecovery``, ``TestScale``, ``TestDeputy``, ``TestBlobs``: 37 tests)
over ``tpusystem_torch.parallel.multihost``'s ``Hub``/``TcpTransport``,
processes simulated with in-process transports as the reference does.
Then the port's own: the wire is the reference's (a port transport on a
reference hub and the other way round), the multi-process ``Runtime`` of
two ranks in one process, ``initialize``'s world, and a twin of
``tests/test_multiprocess.py::test_real_process_death_surfaces_worker_lost``
on the control plane only, with port subprocesses.

Every hub binds port 0 and every hub and transport closes in ``finally``;
every join, fetch, barrier and wait has a deadline. The standby-deputy
twin waits for the flaked rank's failover to land on the deputy before
its collective (a predicate, not a sleep): the reference's version races
it (ROADMAP queue 3).
"""

from __future__ import annotations

import socket
import time

import pytest

from tpusystem_torch.parallel.multihost import (
    BlobError, DistributedProducer, DistributedPublisher, Hub, Loopback,
    TcpTransport, WorkerLost, agree,
)
from tpusystem_torch.services.prodcon import Consumer, event
from tpusystem_torch.services.pubsub import Subscriber


@event
class Synced:
    epoch: int
    loss: float


def pod(size, **kwargs):
    hub = Hub(size, **kwargs)
    transports = [TcpTransport(hub.address, rank, size) for rank in range(size)]
    deadline = time.monotonic() + 5
    while len(hub._clients) < size and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(hub._clients) == size
    return hub, transports


def shutdown(hub, transports):
    for transport in transports:
        transport.close()
    hub.close()


def wait_until(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


class TestTransport:
    def test_wired_event_reaches_every_other_host(self):
        hub, transports = pod(3)
        try:
            seen = {rank: [] for rank in range(3)}
            for rank, transport in enumerate(transports):
                transport.subscribe('test', seen[rank].append)
            transports[1].send_event('test', {'from': 1})
            assert wait_until(lambda: seen[0] and seen[2])
            assert seen[0] == [{'from': 1}] and seen[2] == [{'from': 1}]
            assert seen[1] == []  # sender does not hear itself
        finally:
            shutdown(hub, transports)

    def test_channels_do_not_crosstalk(self):
        hub, transports = pod(2)
        try:
            alpha, beta = [], []
            transports[1].subscribe('alpha', alpha.append)
            transports[1].subscribe('beta', beta.append)
            transports[0].send_event('alpha', 'a')
            transports[0].send_event('gamma', 'dropped')  # no subscriber
            transports[0].send_event('beta', 'b')
            assert wait_until(lambda: alpha and beta)
            assert alpha == ['a'] and beta == ['b']
        finally:
            shutdown(hub, transports)

    def test_allreduce_ops(self):
        hub, transports = pod(3)
        try:
            import threading
            results = {}

            def run(rank, transport):
                results[('or', rank)] = transport.allreduce(rank == 2, op='or')
                results[('and', rank)] = transport.allreduce(True, op='and')
                results[('sum', rank)] = transport.allreduce(rank, op='sum')
                results[('gather', rank)] = sorted(transport.gather(rank))

            threads = [threading.Thread(target=run, args=(rank, transport))
                       for rank, transport in enumerate(transports)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=10)
            for rank in range(3):
                assert results[('or', rank)] is True
                assert results[('and', rank)] is True
                assert results[('sum', rank)] == 3
                assert results[('gather', rank)] == [0, 1, 2]
        finally:
            shutdown(hub, transports)

    def test_loopback_degenerate_case(self):
        transport = Loopback()
        assert transport.allreduce(True, op='and') is True
        assert transport.allreduce(False, op='or') is False
        assert transport.gather(7) == [7]
        transport.barrier()
        transport.send_event('any', 'dropped')  # nowhere to go, no error

    def test_connect_retries_until_hub_listens(self):
        import socket as socket_module
        import threading
        placeholder = socket_module.socket()
        placeholder.bind(('127.0.0.1', 0))
        address = placeholder.getsockname()
        placeholder.close()                       # port free, nothing listening
        box = {}

        def dial():
            box['transport'] = TcpTransport(address, 0, 1, connect_timeout=10)

        dialer = threading.Thread(target=dial, daemon=True)
        dialer.start()                            # client starts BEFORE the hub
        time.sleep(0.3)
        hub = Hub(1, host=address[0], port=address[1])
        try:
            dialer.join(timeout=10)
            assert 'transport' in box
            assert wait_until(lambda: len(hub._clients) == 1)
        finally:
            box['transport'].close()
            hub.close()


class TestDistributedProducer:
    def test_wired_events_cross_hosts_on_drain(self):
        hub, transports = pod(2)
        try:
            producers = [DistributedProducer(transport) for transport in transports]
            logs = {0: [], 1: []}
            for rank, producer in enumerate(producers):
                consumer = Consumer()

                def make(rank):
                    def on_synced(message: Synced):
                        logs[rank].append(message)
                    return on_synced
                consumer.register(Synced, make(rank))
                producer.register(consumer)
                producer.wire(Synced)

            producers[0].dispatch(Synced(epoch=1, loss=0.5))
            assert logs[0] == [Synced(1, 0.5)]  # local, synchronous
            assert wait_until(lambda: not producers[1]._inbox.empty())
            assert logs[1] == []  # remote events wait for a safe point
            assert producers[1].drain() == 1
            assert logs[1] == [Synced(1, 0.5)]
        finally:
            shutdown(hub, transports)

    def test_unwired_events_stay_local(self):
        hub, transports = pod(2)
        try:
            producers = [DistributedProducer(transport) for transport in transports]
            producers[0].dispatch(Synced(epoch=1, loss=0.5))
            time.sleep(0.1)
            assert producers[1].drain() == 0
        finally:
            shutdown(hub, transports)

    def test_primary_only_consumer_skipped_off_primary(self):
        hub, transports = pod(2)
        try:
            producers = [DistributedProducer(transport) for transport in transports]
            for producer in producers:
                producer.register(Consumer(), primary_only=True)
            assert len(producers[0].consumers) == 1
            assert len(producers[1].consumers) == 0
        finally:
            shutdown(hub, transports)

    def test_loopback_producer_is_plain_producer(self):
        producer = DistributedProducer()
        seen = []
        consumer = Consumer()
        consumer.register(Synced, seen.append)
        producer.register(consumer, primary_only=True)  # rank 0 -> registered
        producer.wire(Synced)
        producer.dispatch(Synced(epoch=0, loss=1.0))
        assert seen == [Synced(0, 1.0)]
        assert producer.drain() == 0


class TestDistributedPublisher:
    def test_wired_topic_crosses_hosts(self):
        hub, transports = pod(2)
        try:
            publishers = [DistributedPublisher(transport) for transport in transports]
            received = []
            subscriber = Subscriber()
            subscriber.register('loss', received.append)
            publishers[1].register(subscriber)
            publishers[1].wire('loss')
            publishers[0].wire('loss')

            publishers[0].publish(0.25, 'loss')
            assert wait_until(lambda: not publishers[1]._inbox.empty())
            publishers[1].drain()
            assert received == [0.25]
        finally:
            shutdown(hub, transports)


class TestAgreement:
    def test_any_host_stops_all(self):
        hub, transports = pod(3)
        try:
            import threading
            verdicts = {}

            def run(rank, transport):
                verdicts[rank] = agree(transport, rank == 1)  # host 1 wants out

            threads = [threading.Thread(target=run, args=(rank, transport))
                       for rank, transport in enumerate(transports)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=10)
            assert verdicts == {0: True, 1: True, 2: True}
        finally:
            shutdown(hub, transports)

    def test_unanimous_op_requires_all(self):
        assert agree(Loopback(), False, op='and') is False
        assert agree(Loopback(), True, op='and') is True


class TestSharedTransport:
    def test_producer_and_publisher_share_one_transport(self):
        """The Runtime wiring: both buses on the same TcpTransport, each
        draining only its own channel's traffic."""
        hub, transports = pod(2)
        try:
            producers = [DistributedProducer(transport) for transport in transports]
            publishers = [DistributedPublisher(transport) for transport in transports]
            for producer in producers:
                producer.wire(Synced)
            for publisher in publishers:
                publisher.wire('loss')
            events, topics = [], []
            consumer = Consumer()
            consumer.register(Synced, events.append)
            producers[1].register(consumer)
            subscriber = Subscriber()
            subscriber.register('loss', topics.append)
            publishers[1].register(subscriber)

            producers[0].dispatch(Synced(epoch=7, loss=0.1))
            publishers[0].publish(0.25, 'loss')
            assert wait_until(lambda: not producers[1]._inbox.empty()
                              and not publishers[1]._inbox.empty())
            assert producers[1].drain() == 1
            assert publishers[1].drain() == 1
            assert events == [Synced(7, 0.1)]
            assert topics == [0.25]
        finally:
            shutdown(hub, transports)


class TestFailureDetection:
    def test_crashed_worker_surfaces_immediately(self):
        """A dead connection (no 'bye') is a crash: lost is broadcast at
        once, without waiting for the heartbeat monitor."""
        hub, transports = pod(2)
        try:
            producer = DistributedProducer(transports[0])
            lost = []
            consumer = Consumer()
            consumer.register(WorkerLost, lost.append)
            producer.register(consumer)
            # Crash: the connection dies with no 'bye'. shutdown() (not just
            # close()) is needed in-process: the transport's own recv thread
            # keeps the open file description alive, so a bare close() never
            # sends the FIN a real process death would.
            transports[1]._sock.shutdown(socket.SHUT_RDWR)
            transports[1]._sock.close()
            # keep draining until the loss surfaces — a late 'joined'
            # control frame may land in the inbox first (same race the
            # silent-host test below guards against)
            assert wait_until(lambda: (producer.drain(), bool(lost))[1])
            assert lost[0].rank == 1
            assert lost[0].reason == 'socket'    # EOF, not a stall
        finally:
            transports[0].close()
            hub.close()

    def test_silent_host_surfaces_as_worker_lost_event(self):
        hub = Hub(2, heartbeat_timeout=0.3)
        transports = [
            TcpTransport(hub.address, 0, 2, heartbeat_interval=0.05),
            TcpTransport(hub.address, 1, 2),  # never heartbeats
        ]
        try:
            assert wait_until(lambda: len(hub._clients) == 2)
            producer = DistributedProducer(transports[0])
            lost = []
            consumer = Consumer()
            consumer.register(WorkerLost, lost.append)
            producer.register(consumer)
            # rank 1 stays silent past the timeout; keep draining until the
            # loss surfaces (a 'joined' frame may land in the inbox first)
            assert wait_until(lambda: (producer.drain(), bool(lost))[1],
                              timeout=5)
            assert lost[0].rank == 1
            assert lost[0].reason == 'heartbeat'   # a stall, not a crash
        finally:
            shutdown(hub, transports)


class TestRecovery:
    def test_crash_unwinds_as_worker_lost_error_at_drain(self):
        """detect (control plane) -> decide (recovery consumer) -> the
        error surfaces on the host loop thread at the drain point, never
        on a transport thread."""
        from tpusystem_torch.parallel.recovery import WorkerLostError, recovery_consumer
        hub, transports = pod(2)
        try:
            producer = DistributedProducer(transports[0])
            producer.register(recovery_consumer())
            transports[1]._sock.shutdown(socket.SHUT_RDWR)
            transports[1]._sock.close()
            # wait for the 'lost' broadcast specifically — a late 'joined'
            # control frame can land in the inbox first
            assert wait_until(lambda: 1 in hub._lost)
            assert wait_until(lambda: not producer._inbox.empty())
            with pytest.raises(WorkerLostError) as excinfo:
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline:   # drain until it surfaces
                    producer.drain()
                    time.sleep(0.01)
            assert excinfo.value.rank == 1
        finally:
            shutdown(hub, transports)

    def test_collectives_degrade_to_survivors_after_loss(self):
        """The 'observe' policy is only viable if collectives stop waiting
        for the dead rank: an allreduce started by the survivors completes
        with their contributions once the loss is detected."""
        import threading
        hub, transports = pod(3)
        try:
            transports[2]._sock.shutdown(socket.SHUT_RDWR)
            transports[2]._sock.close()
            assert wait_until(lambda: 2 in hub._lost)
            results = {}

            def contribute(rank):
                results[rank] = transports[rank].allreduce(rank == 0, op='or',
                                                           timeout=10)

            threads = [threading.Thread(target=contribute, args=(rank,))
                       for rank in (0, 1)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=10)
            assert results == {0: True, 1: True}
        finally:
            shutdown(hub, transports)

    def test_pending_collective_completes_when_holdout_dies(self):
        """Loss DURING a collective: the op was waiting on the dead rank
        and must complete with the survivors' values."""
        import threading
        hub, transports = pod(3)
        try:
            results = {}

            def contribute(rank):
                results[rank] = transports[rank].allreduce(rank, op='sum',
                                                           timeout=10)

            threads = [threading.Thread(target=contribute, args=(rank,))
                       for rank in (0, 1)]
            for thread in threads:
                thread.start()
            assert wait_until(lambda: len(hub._pending) == 1)
            transports[2]._sock.shutdown(socket.SHUT_RDWR)
            transports[2]._sock.close()
            for thread in threads:
                thread.join(timeout=10)
            assert results == {0: 1, 1: 1}   # sum of ranks 0 + 1
        finally:
            shutdown(hub, transports)

    def test_excluded_rank_collective_fails_fast(self):
        """A restarted (excluded) rank's collective raises immediately via
        the hub's 'rejected' frame instead of blocking until its timeout:
        its op counter restarted at 0, so its op_key can never match the
        survivors' (ADVICE r1 #2)."""
        hub, transports = pod(3)
        try:
            transports[2]._sock.shutdown(socket.SHUT_RDWR)
            transports[2]._sock.close()
            assert wait_until(lambda: 2 in hub._excluded)
            revived = TcpTransport(hub.address, 2, 3)
            assert wait_until(lambda: 2 in hub._clients)
            start = time.monotonic()
            with pytest.raises(RuntimeError, match='excluded'):
                revived.allreduce(True, op='and', timeout=30)
            assert time.monotonic() - start < 5   # failed fast, not timeout
            revived.close()
        finally:
            shutdown(hub, transports)

    def test_vote_then_die_still_counts_and_survivor_vote_not_dropped(self):
        """A contribution received before the crash stays in the result;
        quota completion is keyed by rank, so the dead rank's early vote
        cannot displace a survivor's."""
        import threading
        hub, transports = pod(3)
        try:
            results = {}

            def contribute(rank, value):
                results[rank] = transports[rank].allreduce(value, op='sum',
                                                           timeout=10)

            # rank 2 votes first, then dies (its own call can never return —
            # swallow the timeout so the daemon thread exits quietly)
            def doomed_vote():
                try:
                    transports[2].allreduce(10, op='sum', timeout=2)
                except Exception:
                    pass

            doomed = threading.Thread(target=doomed_vote, daemon=True)
            doomed.start()
            assert wait_until(
                lambda: any(2 in values for values in hub._pending.values()))
            transports[2]._sock.shutdown(socket.SHUT_RDWR)
            transports[2]._sock.close()
            assert wait_until(lambda: 2 in hub._excluded)
            threads = [threading.Thread(target=contribute, args=(rank, rank))
                       for rank in (0, 1)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=10)
            assert results[0] == results[1] == 10 + 0 + 1
        finally:
            shutdown(hub, transports)

    def test_late_contribution_from_excluded_rank_dropped_without_leak(self):
        """A slow-but-alive rank marked lost by the heartbeat monitor: its
        late contribution must not resurrect a completed op (pending-entry
        leak) — and its call fails fast with 'rejected' rather than racing
        the survivors' result fanout (it is outside the quota; its vote was
        dropped, so handing it the result would let it believe it
        participated)."""
        import threading
        hub = Hub(3, heartbeat_timeout=0.3)
        transports = [
            TcpTransport(hub.address, 0, 3, heartbeat_interval=0.05),
            TcpTransport(hub.address, 1, 3, heartbeat_interval=0.05),
            TcpTransport(hub.address, 2, 3),   # never heartbeats -> 'lost'
        ]
        try:
            assert wait_until(lambda: len(hub._clients) == 3)
            assert wait_until(lambda: 2 in hub._excluded, timeout=5)
            results = {}

            def contribute(rank):
                results[rank] = transports[rank].allreduce(rank, op='sum',
                                                           timeout=10)

            threads = [threading.Thread(target=contribute, args=(rank,))
                       for rank in (0, 1)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=10)
            assert results == {0: 1, 1: 1}
            # the excluded rank contributes late: dropped, no pending
            # leak, and the call fails fast instead of blocking to timeout
            start = time.monotonic()
            with pytest.raises(RuntimeError, match='excluded'):
                transports[2].allreduce(2, op='sum', timeout=30)
            assert time.monotonic() - start < 5
            assert wait_until(lambda: not hub._pending)
        finally:
            shutdown(hub, transports)

    def test_observe_policy_logs_and_continues(self, caplog):
        import logging
        from tpusystem_torch.parallel.multihost import WorkerJoined, WorkerLost
        from tpusystem_torch.parallel.recovery import recovery_consumer
        consumer = recovery_consumer('observe')
        with caplog.at_level(logging.INFO, logger='tpusystem.recovery'):
            consumer.consume(WorkerLost(rank=3, last_seen=1.0))
            consumer.consume(WorkerJoined(rank=3))
        assert 'worker 3 lost' in caplog.text
        assert 'worker 3 joined' in caplog.text

    def test_unknown_policy_rejected(self):
        from tpusystem_torch.parallel.recovery import recovery_consumer
        with pytest.raises(ValueError):
            recovery_consumer('retry')


class TestScale:
    def test_sixteen_host_pod_events_and_collectives(self):
        """Control-plane stress: a 16-host pod running wired events and
        rank-uniform collectives concurrently — the hub must route both
        without cross-talk, loss, or deadlock."""
        import threading
        hub, transports = pod(16)
        try:
            producers = [DistributedProducer(transport) for transport in transports]
            logs = {rank: [] for rank in range(16)}
            for rank, producer in enumerate(producers):
                consumer = Consumer()

                def make(rank):
                    return lambda message: logs[rank].append(message)
                consumer.register(Synced, make(rank))
                producer.register(consumer)
                producer.wire(Synced)
            results = {}

            def worker(rank):
                producers[rank].dispatch(Synced(epoch=rank, loss=0.0))
                results[('sum', rank)] = transports[rank].allreduce(rank, op='sum', timeout=30)
                results[('max', rank)] = transports[rank].allreduce(rank, op='max', timeout=30)
                transports[rank].barrier(timeout=30)

            threads = [threading.Thread(target=worker, args=(rank,))
                       for rank in range(16)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=30)
            for rank in range(16):
                assert results[('sum', rank)] == sum(range(16))
                assert results[('max', rank)] == 15
            # every host drains 15 remote events (everyone else's dispatch)
            assert wait_until(
                lambda: all(not p._inbox.empty() for p in producers))
            for rank, producer in enumerate(producers):
                deadline = time.monotonic() + 5
                while len(logs[rank]) < 16 and time.monotonic() < deadline:
                    producer.drain()
                    time.sleep(0.01)
                # 1 local + 15 remote
                assert len(logs[rank]) == 16, (rank, len(logs[rank]))
        finally:
            shutdown(hub, transports)


class TestDeputy:
    """Hub redundancy: a standby deputy hub promotes when the primary dies
    (ROADMAP robustness item — the star's single point of failure)."""

    def _pod_with_deputy(self, size=3):
        from tpusystem_torch.parallel.multihost import connect, World
        primary = Hub(size)
        deputy = Hub(size, standby_of=primary.address)
        transports = [
            TcpTransport([primary.address, deputy.address], rank, size)
            for rank in range(size)]
        assert wait_until(lambda: len(primary._clients) == size)
        return primary, deputy, transports

    def test_deputy_promotes_and_serves_after_primary_death(self):
        primary, deputy, transports = self._pod_with_deputy()
        try:
            assert deputy.is_standby
            # baseline: collectives work on the primary
            import threading
            results = {}

            def contribute(rank, value):
                results[rank] = transports[rank].allreduce(value, op='sum',
                                                           timeout=15)
            threads = [threading.Thread(target=contribute, args=(r, r + 1))
                       for r in range(3)]
            for t in threads: t.start()
            for t in threads: t.join(timeout=15)
            assert results == {0: 6, 1: 6, 2: 6}

            primary.close()                       # the star center dies
            assert wait_until(lambda: not deputy.is_standby, timeout=10)
            assert wait_until(lambda: len(deputy._clients) == 3, timeout=10)

            # post-failover collectives complete on the promoted deputy
            results.clear()
            threads = [threading.Thread(target=contribute, args=(r, 10 * (r + 1)))
                       for r in range(3)]
            for t in threads: t.start()
            for t in threads: t.join(timeout=15)
            assert results == {0: 60, 1: 60, 2: 60}

            # events flow through the deputy too
            received = []
            consumer = Consumer()

            @consumer.handler
            def on_synced(event: Synced):
                received.append(event.epoch)

            producer = DistributedProducer(transports[1])
            producer.register(consumer)
            sender = DistributedProducer(transports[0])
            sender.wire(Synced)
            sender.dispatch(Synced(epoch=7, loss=0.5))
            assert wait_until(lambda: not producer._inbox.empty(), timeout=10)
            producer.drain()
            assert received == [7]
        finally:
            for transport in transports:
                transport.close()
            deputy.close()

    def test_failover_mid_collective_raises_then_recovers(self):
        from tpusystem_torch.parallel.multihost import ControlPlaneFailover
        primary, deputy, transports = self._pod_with_deputy()
        try:
            import threading
            outcomes = {}

            def contribute(rank):
                try:
                    outcomes[rank] = transports[rank].allreduce(
                        rank, op='sum', timeout=30)
                except ControlPlaneFailover:
                    outcomes[rank] = 'failover'

            # ranks 0 and 1 wait on rank 2, which never contributes
            threads = [threading.Thread(target=contribute, args=(r,))
                       for r in (0, 1)]
            for t in threads: t.start()
            assert wait_until(lambda: len(primary._pending) == 1)
            primary.close()
            for t in threads: t.join(timeout=30)
            assert outcomes == {0: 'failover', 1: 'failover'}

            # rank 2 burns its op-2 counter slot too so sequences realign
            # (its op never reached the primary; on the deputy it would
            # wait forever for ranks that already failed theirs)
            import queue as queue_module
            with pytest.raises((ControlPlaneFailover, queue_module.Empty)):
                transports[2].allreduce(2, op='sum', timeout=3)

            assert wait_until(lambda: not deputy.is_standby, timeout=10)
            results = {}

            def retry(rank):
                results[rank] = transports[rank].allreduce(rank, op='sum',
                                                           timeout=20)
            threads = [threading.Thread(target=retry, args=(r,))
                       for r in range(3)]
            for t in threads: t.start()
            for t in threads: t.join(timeout=25)
            assert results == {0: 3, 1: 3, 2: 3}
        finally:
            for transport in transports:
                transport.close()
            deputy.close()

    def test_standby_deputy_bounces_flaked_client_back(self):
        """Split-brain guard: a client whose LINK to the live primary died
        is redirected back by the standby deputy instead of being served —
        the primary's exclusion policy then governs (it sees the crash)."""
        primary, deputy, transports = self._pod_with_deputy()
        try:
            # flake rank 2's link only; the primary itself stays up
            transports[2]._sock.shutdown(socket.SHUT_RDWR)
            assert wait_until(lambda: 2 in primary._excluded)
            assert deputy.is_standby
            # rank 2's failover has landed on the deputy before it calls:
            # a call racing the failover fails with it and never reaches
            # the deputy, whose bounce is what sends rank 2 home
            assert wait_until(lambda: transports[2]._active == 1
                              and transports[2]._reconnected.is_set()
                              and 2 in deputy._clients)
            # rank 2 failed over to the deputy; its first op gets bounced
            # ('standby'), it redials the primary (rejoins) and replays —
            # where the exclusion policy rejects it: fail-fast, no split
            with pytest.raises(RuntimeError, match='excluded|failover'):
                transports[2].allreduce(True, op='and', timeout=15)
            assert wait_until(lambda: 2 in primary._clients, timeout=10)
            # survivors still complete on the primary (degraded quota)
            import threading
            results = {}

            def contribute(rank):
                results[rank] = transports[rank].allreduce(rank, op='sum',
                                                           timeout=15)
            threads = [threading.Thread(target=contribute, args=(r,))
                       for r in (0, 1)]
            for t in threads: t.start()
            for t in threads: t.join(timeout=15)
            assert results == {0: 1, 1: 1}
        finally:
            for transport in transports:
                transport.close()
            primary.close()
            deputy.close()

    def test_rank_lost_before_failover_degrades_on_deputy(self):
        """The primary's exclusion state dies with it; the promoted deputy
        seeds liveness for never-connected ranks so its heartbeat monitor
        excludes them and survivors' collectives degrade instead of
        deadlocking on a ghost."""
        import threading
        primary = Hub(3, heartbeat_timeout=0.4)
        deputy = Hub(3, standby_of=primary.address, heartbeat_timeout=0.4)
        transports = [
            TcpTransport([primary.address, deputy.address], rank, 3,
                         heartbeat_interval=0.05)
            for rank in range(3)]
        try:
            assert wait_until(lambda: len(primary._clients) == 3)
            # rank 2 crashes and is excluded on the primary
            transports[2]._sock.shutdown(socket.SHUT_RDWR)
            assert wait_until(lambda: 2 in primary._excluded)
            transports[2].close()     # it stays gone (no deputy dialing)
            primary.close()           # then the star center dies
            assert wait_until(lambda: not deputy.is_standby, timeout=10)

            results = {}

            def contribute(rank):
                results[rank] = transports[rank].allreduce(rank, op='sum',
                                                           timeout=20)
            threads = [threading.Thread(target=contribute, args=(r,))
                       for r in (0, 1)]
            for t in threads: t.start()
            for t in threads: t.join(timeout=25)
            assert results == {0: 1, 1: 1}     # degraded to the survivors
            assert 2 in deputy._excluded
        finally:
            for transport in transports:
                transport.close()
            deputy.close()


class TestBlobs:
    """The blob plane: chunked, digest-verified point-to-point transfers
    (what the supervisor's hot-state replication rides)."""

    def test_send_blob_is_point_to_point(self):
        """A blob reaches its addressee intact — reassembled across many
        bounded chunks — and NOBODY else sees any of it."""
        hub, transports = pod(3)
        try:
            delivered, stray = [], []
            transports[2].on_blob = lambda s, k, d: delivered.append((s, k, d))
            transports[1].on_blob = lambda s, k, d: stray.append(k)
            payload = bytes(range(256)) * 64          # 16 KiB, 16+ chunks
            transports[0].send_blob(2, 'shard', payload, chunk_size=1024)
            assert wait_until(lambda: delivered)
            assert delivered == [(0, 'shard', payload)]
            time.sleep(0.1)
            assert stray == []
        finally:
            shutdown(hub, transports)

    def test_fetch_blob_request_reply(self):
        """fetch_blob asks the peer's on_blob_request hook; a peer with
        nothing NAKs, and the requester gets a typed BlobError fast."""
        hub, transports = pod(2)
        try:
            transports[1].on_blob_request = (
                lambda key: b'served:' + key.encode() if key == 'have' else None)
            assert transports[0].fetch_blob(1, 'have',
                                            timeout=10) == b'served:have'
            start = time.monotonic()
            with pytest.raises(BlobError, match='no blob'):
                transports[0].fetch_blob(1, 'missing', timeout=10)
            assert time.monotonic() - start < 5       # NAK, not a timeout
        finally:
            shutdown(hub, transports)

    def test_unclaimed_push_is_held_for_a_later_fetch(self):
        hub, transports = pod(2)
        try:
            transports[0].send_blob(1, 'early', b'pushed before the fetch')
            assert wait_until(lambda: 'early' in transports[1]._blob_ready)
            assert transports[1].fetch_blob(0, 'early',
                                            timeout=5) == b'pushed before the fetch'
        finally:
            shutdown(hub, transports)

    def test_dropped_chunk_times_out_typed(self):
        """Chaos: lost chunks mean the blob never completes — the fetcher
        gets a typed BlobError at its own timeout, and the partial
        assembly is never delivered."""
        from tpusystem_torch.parallel.chaos import ChaosTransport, Faults
        faults = Faults(seed=3, drop=0.5, kinds=('blob',))
        hub = Hub(2)
        responder = ChaosTransport(hub.address, 0, 2, faults=faults)
        requester = TcpTransport(hub.address, 1, 2)
        try:
            assert wait_until(lambda: len(hub._clients) == 2)
            received = []
            requester.on_blob = lambda s, k, d: received.append(k)
            responder.blob_chunk = 512                           # 16 chunks
            responder.on_blob_request = lambda key: bytes(8192)
            start = time.monotonic()
            with pytest.raises(BlobError, match='did not arrive'):
                requester.fetch_blob(0, 'torn', timeout=1.0)
            assert time.monotonic() - start < 5
            assert faults.dropped                # the fault really fired
            assert received == []                # no partial delivery
        finally:
            responder.close()
            requester.close()
            hub.close()

    def test_truncated_chunk_fails_digest_on_fetch(self, caplog):
        """Chaos: a truncated chunk arrives, the count completes, but the
        whole-blob digest fails — the waiting fetcher is failed typed and
        fast instead of receiving torn bytes."""
        import logging
        from tpusystem_torch.parallel.chaos import ChaosTransport, Faults
        faults = Faults(seed=1, truncate=1.0, kinds=('blob',))
        hub = Hub(2)
        responder = ChaosTransport(hub.address, 0, 2, faults=faults)
        requester = TcpTransport(hub.address, 1, 2)
        try:
            assert wait_until(lambda: len(hub._clients) == 2)
            responder.on_blob_request = lambda key: bytes(4096)
            start = time.monotonic()
            with caplog.at_level(logging.WARNING, 'tpusystem_torch.multihost'):
                with pytest.raises(BlobError, match='digest'):
                    requester.fetch_blob(0, 'torn', timeout=10)
            assert time.monotonic() - start < 5      # failed fast, typed
            assert faults.truncated == ['blob']
            assert 'digest' in caplog.text
        finally:
            responder.close()
            requester.close()
            hub.close()

    def test_fetch_is_pinned_to_the_requested_peer(self):
        """Review regression: a same-key blob pushed by a DIFFERENT rank
        while a fetch is in flight must not be mistaken for the answer —
        the waiter is pinned to the peer the request went to."""
        hub, transports = pod(3)
        try:
            unsolicited = []
            transports[0].on_blob = lambda s, k, d: unsolicited.append((s, d))
            transports[2].on_blob_request = (
                lambda key: time.sleep(0.5) or b'the real answer')
            import threading
            box = {}
            fetcher = threading.Thread(
                target=lambda: box.update(
                    got=transports[0].fetch_blob(2, 'shared-key', timeout=10)))
            fetcher.start()
            time.sleep(0.1)                 # fetch registered, reply pending
            transports[1].send_blob(0, 'shared-key', b'impostor bytes')
            fetcher.join(timeout=10)
            assert box['got'] == b'the real answer'
            assert wait_until(lambda: unsolicited)
            assert unsolicited == [(1, b'impostor bytes')]
        finally:
            shutdown(hub, transports)

    def test_transport_close_fails_inflight_fetch_typed(self):
        """Review regression: closing the transport with a fetch in
        flight must fail it typed and fast — the same no-hang-to-timeout
        discipline the collective waiters get — not leave it to ride out
        its full timeout."""
        import threading
        hub, transports = pod(2)
        try:
            transports[1].on_blob_request = (
                lambda key: time.sleep(30) or b'far too late')
            outcome = {}

            def fetch():
                start = time.monotonic()
                try:
                    transports[0].fetch_blob(1, 'slow', timeout=60)
                    outcome['verdict'] = 'completed'
                except BlobError as error:
                    outcome['verdict'] = str(error)
                outcome['elapsed'] = time.monotonic() - start

            fetcher = threading.Thread(target=fetch)
            fetcher.start()
            time.sleep(0.2)               # request sent, reply pending
            transports[0].close()
            fetcher.join(timeout=10)
            assert 'closed or failed over' in outcome['verdict']
            assert outcome['elapsed'] < 5
        finally:
            transports[1].close()
            hub.close()

    def test_concurrent_same_key_fetch_is_refused_typed(self):
        """Review regression: _blob_waiters holds one registration per
        key — a second concurrent fetch for the same key is refused typed
        instead of silently clobbering the first's."""
        import threading
        hub, transports = pod(2)
        try:
            transports[1].on_blob_request = (
                lambda key: time.sleep(0.5) or b'answer')
            box = {}
            first = threading.Thread(
                target=lambda: box.update(
                    got=transports[0].fetch_blob(1, 'dup', timeout=10)))
            first.start()
            time.sleep(0.1)
            with pytest.raises(BlobError, match='already in flight'):
                transports[0].fetch_blob(1, 'dup', timeout=10)
            first.join(timeout=10)
            assert box['got'] == b'answer'     # the first fetch unharmed
        finally:
            shutdown(hub, transports)

    def test_loopback_blob_parity(self):
        transport = Loopback()
        held = []
        transport.on_blob = lambda s, k, d: held.append((s, k, d))
        transport.send_blob(0, 'self', b'stay local')
        assert held == [(0, 'self', b'stay local')]
        transport.on_blob_request = (
            lambda key: b'mine' if key == 'x' else None)
        assert transport.fetch_blob(0, 'x') == b'mine'
        with pytest.raises(BlobError):
            transport.fetch_blob(0, 'absent')


# ---------------------------------------------------------------------------
# the port's own


@pytest.mark.parametrize('hub_side', ['reference', 'port'])
def test_the_wire_is_the_reference_s(hub_side):
    """Frames are the reference's pickled tuples: port transports complete
    collectives and carry blobs through a reference hub, and reference
    transports through a port hub."""
    import threading

    from tpusystem.parallel import multihost as reference
    from tpusystem_torch.parallel import multihost as port
    hub_module, client = ((reference, port) if hub_side == 'reference'
                          else (port, reference))
    hub = hub_module.Hub(2)
    transports = [client.TcpTransport(hub.address, rank, 2)
                  for rank in range(2)]
    try:
        assert wait_until(lambda: len(hub._clients) == 2)
        results = {}

        def contribute(rank):
            results[rank] = transports[rank].allreduce(rank + 5, op='sum',
                                                       timeout=10)
        threads = [threading.Thread(target=contribute, args=(rank,))
                   for rank in range(2)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=10)
        assert results == {0: 11, 1: 11}
        transports[1].on_blob_request = lambda key: key.encode() * 3
        assert transports[0].fetch_blob(1, 'ab', timeout=10) == b'ababab'
    finally:
        shutdown(hub, transports)


@pytest.fixture()
def no_job_env(monkeypatch):
    for name in ('TPUSYSTEM_COORDINATOR', 'TPUSYSTEM_CONTROL',
                 'TPUSYSTEM_CONTROL_DEPUTY', 'TPUSYSTEM_PROCESS_ID',
                 'TPUSYSTEM_NUM_PROCESSES'):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    from tpusystem_torch.parallel import multihost
    multihost.initialize()                 # the world back to one process


def test_initialize_names_the_world_from_arguments_or_environment(
        no_job_env):
    from tpusystem_torch.parallel.multihost import World, initialize, world
    assert initialize() == World(0, 1) == world()
    assert initialize('head:1', 4, 2) == World(2, 4) == world()
    assert not world().is_primary
    no_job_env.setenv('TPUSYSTEM_NUM_PROCESSES', '3')
    no_job_env.setenv('TPUSYSTEM_PROCESS_ID', '0')
    assert initialize('head:1') == World(0, 3)
    with pytest.raises(ValueError, match='outside'):
        initialize(num_processes=2, process_id=2)
    no_job_env.delenv('TPUSYSTEM_PROCESS_ID')
    with pytest.raises(ValueError, match='process_id'):
        initialize(num_processes=2)


def _runtimes(size, **kwargs):
    """``size`` runtimes of one job in this process: rank 0's hub binds
    port 0, the others dial the port it got."""
    from tpusystem_torch import Runtime
    first = Runtime('127.0.0.1', control_port=0, num_processes=size,
                    process_id=0, **kwargs)
    port = first.hub.address[1]
    return [first] + [Runtime('127.0.0.1', control_port=port,
                              num_processes=size, process_id=rank, **kwargs)
                      for rank in range(1, size)]


def test_multi_process_runtime_routes_agrees_and_barriers(no_job_env):
    """Three ranks' ``Runtime`` s over one TCP hub (the primary hosts it):
    a wired event reaches only the primary's ``primary_only`` consumer,
    ``should_stop`` is one verdict for all, ``barrier`` rendezvous."""
    import threading
    runtimes = _runtimes(3, heartbeat=0.5)
    try:
        assert [r.world.process_index for r in runtimes] == [0, 1, 2]
        assert [r.is_primary for r in runtimes] == [True, False, False]
        assert runtimes[0].hub is not None and runtimes[1].hub is None
        assert all(isinstance(r.transport, TcpTransport) for r in runtimes)
        assert wait_until(lambda: len(runtimes[0].hub._clients) == 3)
        pings = {rank: [] for rank in range(3)}
        for rank, runtime in enumerate(runtimes):
            consumer = Consumer()
            consumer.register(Synced, pings[rank].append)
            runtime.producer.register(consumer, primary_only=True)
            runtime.producer.wire(Synced)
        outcomes = {}

        def run(rank):
            runtime = runtimes[rank]
            runtime.barrier(timeout=20)
            if rank == 2:
                runtime.producer.dispatch(Synced(epoch=2, loss=0.5))
            outcomes[('none', rank)] = runtime.should_stop(False)
            outcomes[('one', rank)] = runtime.should_stop(rank == 1)
            outcomes[('sum', rank)] = runtime.transport.allreduce(
                rank, op='sum', timeout=20)
            runtime.barrier(timeout=20)
        threads = [threading.Thread(target=run, args=(rank,))
                   for rank in range(3)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=30)
        for rank in range(3):
            assert outcomes[('none', rank)] is False
            assert outcomes[('one', rank)] is True
            assert outcomes[('sum', rank)] == 3
        assert wait_until(lambda: (runtimes[0].sync(), bool(pings[0]))[1])
        assert pings[0] == [Synced(2, 0.5)]
        runtimes[1].sync()
        assert pings[1] == [] and pings[2] == []
    finally:
        for runtime in runtimes:
            runtime.close()


def test_runtime_barrier_timeout_is_typed(no_job_env):
    """A peer that never arrives makes ``barrier(timeout=)`` raise
    ``CollectiveTimeout`` (a ``ControlPlaneFailover``) at its deadline."""
    from tpusystem_torch.parallel import CollectiveTimeout
    runtimes = _runtimes(2, heartbeat=None)
    try:
        start = time.monotonic()
        with pytest.raises(CollectiveTimeout, match='timed out'):
            runtimes[0].barrier(timeout=0.5)
        assert time.monotonic() - start < 5
    finally:
        for runtime in runtimes:
            runtime.close()


def test_runtime_deputy_address_comes_from_the_environment(no_job_env):
    from tpusystem_torch.runtime import _deputy_address
    assert _deputy_address() is None
    no_job_env.setenv('TPUSYSTEM_CONTROL_DEPUTY', '10.0.0.7:9100')
    assert _deputy_address() == ('10.0.0.7', 9100)
    no_job_env.setenv('TPUSYSTEM_CONTROL_DEPUTY', 'no-port')
    with pytest.raises(ValueError, match='host:port'):
        _deputy_address()


FAILURE_WORKER = r'''
import json, os, sys, time
rank, nprocs = int(sys.argv[1]), int(sys.argv[2])
coordinator, out_path = sys.argv[3], sys.argv[4]

from tpusystem_torch.parallel.multihost import WorkerLost
from tpusystem_torch.runtime import Runtime
from tpusystem_torch.services import Consumer

record = {'rank': rank, 'lost': []}
runtime = Runtime(coordinator=coordinator, num_processes=nprocs,
                  process_id=rank, heartbeat=0.5)
consumer = Consumer()
consumer.register(WorkerLost, lambda lost: record['lost'].append(lost.rank))
runtime.producer.register(consumer)

runtime.barrier(timeout=60)       # everyone up, hub registrations done
if rank == nprocs - 1:
    os._exit(1)                   # abrupt death: no 'bye', no cleanup

deadline = time.monotonic() + 30
while not record['lost'] and time.monotonic() < deadline:
    runtime.sync()                # drain control-plane events
    time.sleep(0.05)

with open(out_path, 'w') as handle:
    json.dump(record, handle)
    handle.flush()
    os.fsync(handle.fileno())
if rank == 0:
    # rank 0 hosts the hub: linger so the 'lost' fanout reaches every
    # survivor before os._exit tears the hub thread down mid-broadcast
    time.sleep(2)
os._exit(0)
'''


def test_real_process_death_surfaces_worker_lost(tmp_path):
    """Failure detection over real processes, the control plane only: four
    port workers join through ``Runtime``; rank 3 dies abruptly
    (``os._exit``: no 'bye' frame, a closed socket like a crashed host);
    every survivor surfaces a ``WorkerLost`` for exactly that rank."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parents[1]
    with socket.socket() as probe:           # a free port for the hub
        probe.bind(('127.0.0.1', 0))
        port = probe.getsockname()[1]
    worker = tmp_path / 'worker.py'
    worker.write_text(FAILURE_WORKER)
    env = {key: value for key, value in os.environ.items()
           if not key.startswith('TPUSYSTEM_')}
    env.update(PYTHONPATH=str(repo), TPUSYSTEM_CONTROL=f'127.0.0.1:{port}',
               OMP_NUM_THREADS='1')
    nprocs = 4
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(rank), str(nprocs),
         f'127.0.0.1:{port - 1}', str(tmp_path / f'out{rank}.json')],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(nprocs)]
    try:
        outputs = [proc.communicate(timeout=45)[0].decode()
                   for proc in procs]
    finally:
        for proc in procs:   # a hung worker must not outlive the test
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert procs[nprocs - 1].returncode == 1      # the deliberate death
    for rank in range(nprocs - 1):
        assert procs[rank].returncode == 0, (
            f'survivor {rank} failed:\n{outputs[rank][-3000:]}')
        record = json.loads((tmp_path / f'out{rank}.json').read_text())
        assert record['lost'] == [nprocs - 1], record
