"""Elastic training: agree a new world size, reshard in RAM, keep going.
The port of :mod:`tpusystem.parallel.elastic`, copied (membership is
standard-library host logic); its state pieces are the port's memstore
(:class:`~tpusystem_torch.checkpoint.memstore.ShardedLeaf`: a placed
leaf's piece on each rank, one whole piece on a one-device mesh), and a
resize reshards the merged pieces onto the new mesh's slice boundaries.

The recovery stack restarts a fixed-size job in seconds (supervisor +
peer-replicated memstore) and topology-portable restore is proven (the
reference's ``tests/test_multiprocess.py`` resumes a 4-device checkpoint
on a 6-device world) — but a preemption wave still meant waiting for the
lost capacity or a cold full-world restart. Production fleets under
contention (Varuna, Bamboo, the spot-training literature) *shrink* on
loss and *grow* when capacity returns. This module closes that loop with
three pieces, all riding machinery the repo already has:

1. **Membership epochs** (:class:`ElasticCoordinator`) — supervisor-level
   agreement on the rank set. Loss/join events from the control-plane
   hub open a *wave*; after :attr:`ElasticPolicy.settle_window` seconds
   with no further change (so a 3-host wave triggers ONE resize, not
   three), each survivor broadcasts a ``(epoch, members)`` proposal over
   the event plane and commits when every proposed member has echoed the
   same proposal. Deliberately events + settle, not hub collectives: the
   hub's quota machinery excludes exactly the rejoining ranks a grow
   must re-admit (:meth:`~tpusystem_torch.parallel.multihost.Hub.readmit`).
   Commitment restarts the workers under a new world spec with
   :data:`~tpusystem_torch.parallel.recovery.RESIZED_EXIT`.

2. **Hot resharding** (:func:`elastic_resume` + :func:`collect_pieces`)
   — the relaunched workers rebuild the mesh at the agreed size
   (:meth:`~tpusystem_torch.parallel.mesh.MeshSpec.resized`) and reassemble
   training state from the memstore tier: each survivor contributes its
   own :class:`~tpusystem_torch.checkpoint.memstore.ShardedLeaf` pieces
   (``own:{identity}`` blob fetches), lost hosts' pieces come from their
   buddies' replica slots (``hot:{identity}``), the pieces merge
   (:func:`~tpusystem_torch.checkpoint.memstore.merge_hot`) and re-lay onto
   the new mesh (``deserialize_state`` into the target's tensors).
   Any digest/structure/missing-piece failure falls back to disk — the
   same rung discipline as
   :func:`~tpusystem_torch.checkpoint.memstore.hot_resume`. Buddy pairs are
   re-derived from the new rank set and replication resumes immediately.

3. **The grow path** — a replacement host's supervisor dials the control
   plane, the hub's ``joined`` fanout (plus the joiner's own ``join``
   announcement) opens the next settle window, and the world expands
   back, bounded by :attr:`ElasticPolicy.max_world` and rate-limited by
   :attr:`ElasticPolicy.cooldown`.

Every transition is a domain event (``WorldResizeProposed`` /
``WorldResized`` / ``ElasticTimeline``) so the ledger orders a
preemption-wave incident and TensorBoard charts world size and resize
latency with zero trainer code. The serving fleet's traffic-driven
autoscaler (:mod:`tpusystem_torch.serve.fleet`) is a second client of this
resize seam: its ``provision``/``release`` callables carve a serving
replica's capacity out of the training world (and give it back on ebb)
through exactly this membership protocol plus
:meth:`~tpusystem_torch.parallel.supervisor.Supervisor.resize` — one fleet,
traffic-shaped. The chaos drill is the contract
(the reference's ``tests/test_elastic.py``): kill k of n hosts mid-run →
ONE resize → training continues at n−k with state bitwise-equivalent to
restoring the same step from disk onto the shrunk mesh → a returning host
grows the world back — never a cold full-world restart.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from tpusystem_torch.observe.events import WorldResized
from tpusystem_torch.parallel.multihost import BlobError

logger = logging.getLogger('tpusystem_torch.elastic')

__all__ = ['ELASTIC_ENV', 'ElasticPolicy', 'ResizeDecision',
           'ElasticCoordinator', 'elastic_consumer', 'elastic_resume',
           'collect_pieces', 'split_pieces']

# how a relaunched worker learns the agreed world spec (JSON:
# {"epoch": E, "members": [...], "member": this host's original rank})
ELASTIC_ENV = 'TPUSYSTEM_ELASTIC'

# the control-plane event channel the proposal exchange rides
ELASTIC_CHANNEL = 'elastic'


@dataclass(frozen=True)
class ResizeDecision:
    """One committed membership epoch: the agreed rank set.

    ``members`` are *original* supervisor ranks (stable across resizes —
    a replaced host re-joins under its original rank); workers address
    the new world through :meth:`rank_of` (dense 0..size-1 ranks in
    member order) and :meth:`buddy_of` (pairs re-derived from the new
    ordering, ``new_rank ^ 1`` — the last member of an odd world has no
    buddy and relies on disk).
    """

    epoch: int
    members: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.members)

    def rank_of(self, member: int) -> int:
        """The dense rank of ``member`` in the new world."""
        return self.members.index(member)

    def buddy_of(self, member: int) -> int | None:
        """The member this one mirrors hot state with under the new
        pairing, or None (odd world's unpaired last member)."""
        paired = self.rank_of(member) ^ 1
        return self.members[paired] if paired < self.size else None

    def env(self, member: int) -> dict[str, str]:
        """The environment entry a relaunched worker reads to learn the
        new world (:meth:`from_env`)."""
        return {ELASTIC_ENV: json.dumps(
            {'epoch': self.epoch, 'members': list(self.members),
             'member': member})}

    @classmethod
    def from_env(cls, env: dict | None = None
                 ) -> tuple['ResizeDecision', int] | None:
        """Parse :data:`ELASTIC_ENV` → ``(decision, member)`` or None
        (not an elastic relaunch)."""
        import os
        spec = (env if env is not None else os.environ).get(ELASTIC_ENV)
        if not spec:
            return None
        try:
            payload = json.loads(spec)
            decision = cls(epoch=int(payload['epoch']),
                           members=tuple(int(m)
                                         for m in payload['members']))
            return decision, int(payload['member'])
        except (ValueError, KeyError, TypeError) as error:
            logger.warning('malformed %s=%r (%s); ignoring', ELASTIC_ENV,
                           spec, error)
            return None


@dataclass
class ElasticPolicy:
    """The resize policy knobs.

    Args:
        min_world: never agree a world smaller than this — a wave that
            would shrink below it leaves the coordinator waiting for
            capacity to return (disk checkpoints still protect the run).
        max_world: cap on grows (None: the original size is the cap the
            caller usually wants; pass explicitly). Joiners beyond the
            cap stay pending for a later wave.
        settle_window: seconds of quiet after the last membership change
            before a proposal is broadcast — the one-wave-one-resize
            knob: every loss/join inside the window folds into the same
            epoch.
        cooldown: seconds after a commit during which new changes
            accumulate but do not open a wave — rate-limits resize churn
            under flapping capacity.
        rebroadcast: proposal re-send interval while uncommitted (events
            are at-most-once; a dropped proposal must not stall the
            epoch forever).
    """

    min_world: int = 1
    max_world: int | None = None
    settle_window: float = 2.0
    cooldown: float = 0.0
    rebroadcast: float = 0.5


class ElasticCoordinator:
    """Supervisor-side membership-epoch agreement.

    Attach one per supervisor to the *supervisor pod's* control plane
    (the same transport the buddy replication rides). Loss/join frames
    from the hub feed the wave; ``step()`` drives the protocol on the
    caller's thread (or :meth:`start` spawns a polling thread). Events
    are dispatched on whichever thread calls ``step()``.

    Args:
        transport: the supervisor's control-plane client.
        rank: this supervisor's original rank.
        size: the initial world size (``members`` defaults to
            ``range(size)``). A *replacement* host joining an already
            resized pod passes ``members=None``: it bootstraps by
            adopting the first proposal that includes it.
        policy: the :class:`ElasticPolicy` knobs.
        producer: event bus for ``WorldResizeProposed`` /
            ``WorldResized`` / ``ElasticTimeline``.
        on_resize: called with the :class:`ResizeDecision` on every
            commit — the supervisor's restart hook
            (:meth:`~tpusystem_torch.parallel.supervisor.Supervisor.resize`).
        clock: injection seam for the settle/cooldown arithmetic.
    """

    def __init__(self, transport: Any, rank: int, size: int | None = None,
                 *, policy: ElasticPolicy | None = None, producer: Any = None,
                 on_resize: Callable[[ResizeDecision], None] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Any = None,
                 members: tuple[int, ...] | None = 'from-size') -> None:
        self.transport = transport
        self.rank = rank
        self.policy = policy if policy is not None else ElasticPolicy()
        self.producer = producer
        self.on_resize = on_resize
        self._clock = clock
        # observe.Tracer | None: each committed wave becomes a parent
        # span (wave-open → resumed) with one child span per stage
        # transition — the span form of ElasticTimeline, same clock
        self.tracer = tracer
        if members == 'from-size':
            members = tuple(range(size)) if size is not None else None
        self.members: tuple[int, ...] | None = (
            tuple(sorted(members)) if members is not None else None)
        self.epoch = 0
        self.decisions: list[ResizeDecision] = []
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._lost: set[int] = set()
        self._joins: set[int] = set()
        self._wave_opened: float | None = None
        self._settle_at = 0.0
        self._cooldown_until = 0.0
        self._proposal: tuple[int, tuple[int, ...]] | None = None
        self._votes: dict[int, tuple[int, tuple[int, ...]]] = {}
        self._last_broadcast = 0.0
        self._stages: dict[str, float] = {}
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        transport.subscribe(ELASTIC_CHANNEL, self._ingest)
        self._previous_on_control = transport.on_control

        def on_control(frame: tuple) -> None:
            self._ingest(frame)
            if self._previous_on_control is not None:
                self._previous_on_control(frame)
        self._on_control = on_control
        transport.on_control = on_control
        if self.members is None:
            # replacement-host bootstrap: announce; the survivors' hub
            # 'joined' fanout usually covers this, but a coordinator
            # attached after that fanout passed must still be seen
            self._send(('join', self.rank))

    # ------------------------------------------------------------------
    # wire

    def _send(self, message: tuple) -> None:
        try:
            self.transport.send_event(ELASTIC_CHANNEL, message)
        except OSError as error:
            logger.warning('elastic frame %r not sent (%s); the rebroadcast '
                           'loop retries', message[0], error)

    def _dispatch(self, event: Any) -> None:
        if self.producer is not None:
            self.producer.dispatch(event)

    # ------------------------------------------------------------------
    # the protocol

    def step(self) -> ResizeDecision | None:
        """Drive the protocol once on the caller's thread; returns the
        committed :class:`ResizeDecision` when this call commits one."""
        self._drain()
        now = self._clock()
        if (self._proposal is None and self.members is not None
                and (self._lost or self._joins)
                and now >= self._settle_at and now >= self._cooldown_until):
            self._open_proposal(now)
        if self._proposal is not None:
            if now - self._last_broadcast >= self.policy.rebroadcast:
                self._broadcast(now)
            return self._try_commit(now)
        return None

    def start(self, interval: float = 0.05) -> 'ElasticCoordinator':
        """Poll :meth:`step` on a daemon thread every ``interval``s."""
        def loop() -> None:
            while not self._closed.wait(interval):
                self.step()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _ingest(self, frame: tuple) -> None:
        # nothing drains a closed coordinator's inbox — frames arriving
        # after close() (the transport outlives us: a replacement host
        # builds a NEW coordinator on the same wire) must not pile up
        if not self._closed.is_set():
            self._inbox.put(frame)

    def close(self) -> None:
        self._closed.set()
        # unhook from the transport chain where we are still the head;
        # if another hook was chained on top of ours after construction,
        # the _ingest guard above still makes us inert
        if self.transport.on_control is self._on_control:
            self.transport.on_control = self._previous_on_control

    # ------------------------------------------------------------------

    def _open_wave(self, now: float) -> None:
        if self._wave_opened is None:
            self._wave_opened = now
            self._stages = {}
        self._settle_at = now + self.policy.settle_window

    def _drain(self) -> None:
        while True:
            try:
                frame = self._inbox.get_nowait()
            except queue.Empty:
                return
            kind = frame[0]
            now = self._clock()
            if kind == 'lost':
                self._on_lost(frame[1], now)
            elif kind in ('joined', 'join'):
                self._on_join(frame[1], now)
            elif kind == 'propose':
                self._on_propose(frame[1], frame[2], tuple(frame[3]), now)

    def _on_lost(self, lost: int, now: float) -> None:
        if self.members is None or lost not in self.members:
            self._joins.discard(lost)        # a joiner that died mid-join
            return
        if lost in self._lost:
            return
        self._lost.add(lost)
        self._joins.discard(lost)
        logger.warning('elastic: rank %d lost; wave settles in %.1fs',
                       lost, self.policy.settle_window)
        if self._proposal is not None and lost in self._proposal[1]:
            # a proposed member died before the commit: the wave is not
            # over — withdraw and re-settle so the NEXT proposal covers
            # the whole wave (one resize, not two)
            self._proposal = None
            self._votes.clear()
        self._open_wave(now)

    def _on_join(self, joiner: int, now: float) -> None:
        if self.members is None or joiner == self.rank:
            return
        if joiner in self.members and joiner not in self._lost:
            return                            # initial pod assembly noise
        if joiner in self._lost:
            # the "lost" host came back within the settle window (a
            # flapped link, a fast replacement): cancel the loss
            self._lost.discard(joiner)
            self._open_wave(now)
            return
        if joiner in self._joins:
            return
        self._joins.add(joiner)
        logger.info('elastic: rank %d joined; wave settles in %.1fs',
                    joiner, self.policy.settle_window)
        self._open_wave(now)

    def _on_propose(self, sender: int, epoch: int,
                    proposed: tuple[int, ...], now: float) -> None:
        if self.members is None:
            # replacement-host bootstrap: adopt the first epoch that
            # includes us and echo it — the commit rule (every proposed
            # member voted) then completes on every survivor and on us
            self._votes[sender] = (epoch, proposed)
            if self._proposal is None and self.rank in proposed:
                self.epoch = epoch - 1
                self._proposal = (epoch, proposed)
                self._votes[self.rank] = self._proposal
                if self._wave_opened is None:
                    self._wave_opened = now
                self._broadcast(now)
            return
        if epoch <= self.epoch:
            if epoch == self.epoch and proposed == self.members:
                # a straggler still collecting votes for an epoch we
                # already committed (our pre-commit broadcasts to it were
                # dropped): re-echo so it can complete
                self._send(('propose', self.rank, epoch, proposed))
            return
        self._votes[sender] = (epoch, proposed)
        if self._proposal == (epoch, proposed):
            return
        # their epoch outranks ours: we lagged — missed frames, or we
        # were flapped out of an epoch that committed without us. Align
        # our epoch base so the proposal we make next can MATCH theirs
        # (votes compare exact (epoch, members) tuples; proposing a
        # lower epoch could never commit).
        if epoch - 1 > self.epoch:
            self.epoch = epoch - 1
        their = set(proposed)
        ours = set(self.members)
        lost = ours - their
        joins = their - ours - {self.rank}
        if not lost and not joins:
            # their higher epoch names OUR exact member set: a
            # re-admission after a commit we never saw (we were the one
            # flapped out). The commit needs our echo — adopt, like the
            # bootstrap path.
            if self.rank in proposed:
                self.epoch = epoch - 1
                self._proposal = (epoch, proposed)
                self._votes[self.rank] = self._proposal
                if self._wave_opened is None:
                    self._wave_opened = now
                self._broadcast(now)
            return
        # fold the difference into our pending changes (the hub
        # broadcasts every loss/join to everyone, so views converge;
        # this is the catch-up for a coordinator whose frames lagged)
        # and close our window — the peer's window closing IS the
        # wave's settle
        self._lost |= lost
        self._joins |= joins
        if self._proposal is not None and self._proposal[1] != proposed:
            self._proposal = None
        self._open_wave(now)
        self._settle_at = now                 # settle immediately: catch up

    def _target(self) -> tuple[int, ...]:
        target = (set(self.members) - self._lost) | self._joins
        cap = self.policy.max_world
        if cap is not None and len(target) > cap:
            # keep existing members first, then the lowest-ranked joiners
            keep = sorted(set(self.members) & target)
            for joiner in sorted(target - set(keep)):
                if len(keep) >= cap:
                    break
                keep.append(joiner)
            target = set(keep[:cap])
        return tuple(sorted(target))

    def _open_proposal(self, now: float) -> None:
        from tpusystem_torch.observe.events import WorldResizeProposed
        target = self._target()
        if len(target) < self.policy.min_world:
            logger.error(
                'elastic: wave would shrink the world to %d (< min_world '
                '%d); holding at %d members and waiting for capacity',
                len(target), self.policy.min_world, len(self.members))
            self._settle_at = now + self.policy.settle_window
            return
        if target == self.members:            # e.g. a loss flapped back
            self._lost.clear()
            # joiners the max_world cap held out stay PENDING (the
            # policy's documented contract) — the next wave with room
            # (a loss) folds them in; only joins already folded clear
            self._joins -= set(self.members)
            self._wave_opened = None
            if self._joins:
                logger.info(
                    'elastic: joiner(s) %s wait beyond max_world=%s for a '
                    'later wave', sorted(self._joins),
                    self.policy.max_world)
                self._settle_at = now + self.policy.settle_window
            return
        cause = ('both' if self._lost and self._joins
                 else 'loss' if self._lost else 'join')
        self._proposal = (self.epoch + 1, target)
        self._votes[self.rank] = self._proposal
        self._stages.setdefault('propose', now - self._wave_opened)
        self._broadcast(now)
        self._dispatch(WorldResizeProposed(rank=self.rank,
                                           epoch=self.epoch + 1,
                                           members=list(target), cause=cause))

    def _broadcast(self, now: float) -> None:
        epoch, proposed = self._proposal
        self._send(('propose', self.rank, epoch, proposed))
        self._last_broadcast = now

    def _try_commit(self, now: float) -> ResizeDecision | None:
        from tpusystem_torch.observe.events import WorldResized
        epoch, proposed = self._proposal
        agreed = {sender for sender, vote in self._votes.items()
                  if vote == self._proposal}
        if not set(proposed) <= agreed:
            return None
        decision = ResizeDecision(epoch=epoch, members=proposed)
        opened = self._wave_opened if self._wave_opened is not None else now
        seconds = now - opened
        self.epoch = epoch
        self.members = proposed
        self._lost.clear()
        self._joins -= set(proposed)
        self._proposal = None
        self._votes.clear()
        self._wave_opened = None
        self._cooldown_until = now + self.policy.cooldown
        self._stages.setdefault('commit', seconds)
        self._commit_stages = dict(self._stages)
        self._committed_at = now - seconds     # wave-open wall anchor
        self.decisions.append(decision)
        logger.info('elastic: epoch %d committed — world is %d members %s '
                    '(%.3fs wave->commit)', epoch, decision.size,
                    list(proposed), seconds)
        self._dispatch(WorldResized(epoch=epoch, members=list(proposed),
                                    size=decision.size, seconds=seconds))
        if self.on_resize is not None:
            self.on_resize(decision)
        return decision

    def resumed(self, step: int | None = None,
                source: str | None = None, **stages: float) -> None:
        """Close the elastic timeline: training resumed at the new size.

        Called by the resharding side after the first post-resize step;
        emits :class:`~tpusystem_torch.observe.events.ElasticTimeline` with
        stage offsets relative to the wave opening."""
        from tpusystem_torch.observe.events import ElasticTimeline
        if not self.decisions:
            return
        decision = self.decisions[-1]
        now = self._clock()
        anchor = getattr(self, '_committed_at', now)
        timeline = dict(getattr(self, '_commit_stages', {}))
        timeline.update(stages)
        timeline.setdefault('resumed', now - anchor)
        seconds = now - anchor
        if self.tracer is not None and timeline:
            root = self.tracer.record(
                f'elastic-resize epoch{decision.epoch}', anchor, now,
                cat='elastic', args={'epoch': decision.epoch,
                                     'size': decision.size, 'step': step,
                                     'source': source})
            previous = ('wave-open', anchor)
            for stage, offset in sorted(timeline.items(),
                                        key=lambda kv: kv[1]):
                self.tracer.record(f'{previous[0]}→{stage}', previous[1],
                                   anchor + offset, cat='elastic',
                                   trace=root.context)
                previous = (stage, anchor + offset)
        self._dispatch(ElasticTimeline(epoch=decision.epoch,
                                       size=decision.size, step=step,
                                       source=source, seconds=seconds,
                                       stages=timeline))


def elastic_consumer():
    """Worker-side resize policy: a committed ``WorldResized`` event
    raises :class:`~tpusystem_torch.parallel.recovery.WorldResizedError` at the
    next ``runtime.sync()`` drain — the elastic sibling of
    :func:`~tpusystem_torch.parallel.recovery.recovery_consumer`.

    Register it on the worker's producer and wire ``WorldResized`` over
    the worker control plane (or dispatch it locally from whatever
    observes the supervisor's commit): the epoch loop unwinds at a step
    boundary — never mid-collective — checkpoint-fences, and exits
    :data:`~tpusystem_torch.parallel.recovery.RESIZED_EXIT` so the supervisor
    relaunches it under the new world spec::

        runtime.producer.register(elastic_consumer())
        try:
            ... epoch loop with runtime.sync() ...
        except WorldResizedError as resize:
            checkpointer.fence(identity)
            raise exit_for_restart(resize)      # exit 46

    Workers whose supervisor drives the restart directly
    (:meth:`~tpusystem_torch.parallel.supervisor.Supervisor.resize` SIGTERMs
    them) do not need this — the consumer is for jobs that learn of the
    commit on their own bus first and want the 46-coded drain.
    """
    from tpusystem_torch.parallel.recovery import WorldResizedError
    from tpusystem_torch.services.prodcon import Consumer
    consumer = Consumer('elastic')

    @consumer.handler
    def on_world_resized(event: WorldResized) -> None:
        raise WorldResizedError(event.epoch, tuple(event.members))

    return consumer


# ---------------------------------------------------------------------------
# hot resharding


def split_pieces(state: Any, mesh: Any, hosts: int) -> list[bytes]:
    """Serialize ``state`` as if ``mesh`` were spread over ``hosts``
    processes: per-host blobs carrying only that host's device pieces as
    :class:`~tpusystem_torch.checkpoint.memstore.ShardedLeaf` s, in
    :func:`~tpusystem_torch.checkpoint.memstore.serialize_state`'s leaf
    order; host ``h`` owns the ``h``-th contiguous slice of the mesh's
    ranks (a pod's host-major order), and host values (the threefry key)
    go to every host.

    Over a mesh of ranks it is a collective (every rank calls it): each
    rank's pieces of its placed leaves are gathered, so every rank returns
    every host's blob; with one host per rank, host ``h``'s blob is rank
    ``h``'s own :func:`~tpusystem_torch.checkpoint.memstore.
    serialize_state`. On a one-device mesh it splits over one host (every
    tensor leaf one whole piece; a tensor off the mesh's device contributes
    no piece). A rank count that ``hosts`` does not divide raises the
    reference's ``ValueError``.
    """
    import pickle

    import torch

    from tpusystem_torch.checkpoint.checkpointer import flatten_state
    from tpusystem_torch.checkpoint.memstore import ShardedLeaf
    ranks = [int(rank) for rank in mesh.ranks.reshape(-1)]
    if len(ranks) % hosts:
        raise ValueError(f'{len(ranks)} devices do not split over '
                         f'{hosts} hosts evenly')
    per_host = len(ranks) // hosts
    leaves = flatten_state(state)
    mine = [ShardedLeaf.from_tensor(leaf)
            if isinstance(leaf, torch.Tensor) and (
                mesh.distributed or leaf.device == mesh.device) else None
            for _, leaf in leaves]
    if mesh.distributed:
        everyone: list = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(everyone, mine)
        pieces = {rank: everyone[rank] for rank in ranks}
    else:
        pieces = {ranks[0]: mine}
    leaves_per_host: list[list] = []
    for host in range(hosts):
        owned = [pieces[rank] for rank in
                 ranks[host * per_host:(host + 1) * per_host]]
        held = []
        for index, (_, leaf) in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                held.append(leaf)
                continue
            merged = ShardedLeaf(tuple(leaf.shape), leaf.dtype, {})
            for rank_pieces in owned:
                if rank_pieces[index] is not None:
                    merged = merged.merged(rank_pieces[index])
            held.append(merged)
        leaves_per_host.append(held)
    return [pickle.dumps(held, protocol=pickle.HIGHEST_PROTOCOL)
            for held in leaves_per_host]


def collect_pieces(identity: str, *, rank: int, members, survivors,
                   store: Any = None, transport: Any = None,
                   buddy_of: Callable[[int], int | None] | None = None,
                   timeout: float = 10.0) -> list:
    """Gather every old-world host's hot pieces for an elastic reshard.

    For each member of the OLD world: this host's own pieces come from
    its supervisor's local slot (``store``); a *surviving* peer's pieces
    are fetched from its supervisor over the blob plane
    (``own:{member}:{identity}``); a *lost* host's pieces are pulled
    from its buddy's replica slot (``hot:{member}:{identity}``,
    ``buddy_of`` is the OLD pairing — the member segment keeps
    concurrent fetches key-distinct on this transport). Remote fetches
    run CONCURRENTLY (the reshard exists to beat the disk restore's
    wall clock; a 16-host world must not pay 15 serial round-trips, and
    an unreachable peer must cost one ``timeout``, not stack).
    Unfetchable contributions are skipped with a log — the caller's
    :func:`elastic_resume` detects incomplete coverage at placement
    time and falls back to disk. Transfer cost per contribution is that
    host's local shard bytes, not the global model.
    """
    from concurrent.futures import ThreadPoolExecutor

    from tpusystem_torch.checkpoint.memstore import unpack_hot
    survivors = set(survivors)
    entries = []
    plan: list[tuple[int, int, str, str]] = []   # (member, peer, key, what)
    for member in sorted(members):
        if member == rank:
            entry = store.newest(identity) if store is not None else None
            if entry is None:
                logger.warning('elastic: no local hot state for %r on rank '
                               '%d', identity, rank)
            else:
                entries.append(entry)
            continue
        if transport is None:
            continue
        if member in survivors:
            plan.append((member, member, f'own:{member}:{identity}',
                         'survivor'))
        else:
            buddy = buddy_of(member) if buddy_of is not None else None
            if buddy is None or buddy not in survivors:
                logger.warning(
                    'elastic: lost rank %d has no surviving buddy — its hot '
                    'pieces are unrecoverable (disk is the fallback)', member)
                continue
            if buddy == rank:
                # WE are the lost host's buddy: its pieces sit in our own
                # replica slot — no self-routed fetch
                entry = (store.newest(identity, replica=True)
                         if store is not None else None)
                if entry is None:
                    logger.warning('elastic: no local replica of lost rank '
                                   '%d\'s pieces for %r', member, identity)
                else:
                    entries.append(entry)
                continue
            plan.append((member, buddy, f'hot:{member}:{identity}',
                         'buddy replica'))

    def fetch(job: tuple[int, int, str, str]):
        member, peer, key, what = job
        try:
            return unpack_hot(transport.fetch_blob(peer, key,
                                                   timeout=timeout))
        except BlobError as error:
            logger.warning('elastic: no %s pieces for rank %d from rank %d '
                           '(%s); disk is the fallback', what, member, peer,
                           error)
            return None
    if plan:
        with ThreadPoolExecutor(max_workers=min(8, len(plan))) as pool:
            entries.extend(entry for entry in pool.map(fetch, plan)
                           if entry is not None)
    return entries


def elastic_resume(checkpointer: Any, identity: str, target: Any,
                   contributions, client: Any = None
                   ) -> tuple[Any, int, Any | None, str]:
    """Resume onto a RESIZED mesh, preferring merged hot pieces over disk.

    ``target`` is the train state already laid out for the NEW mesh (its
    tensors on the mesh's device; the restore writes into them);
    ``contributions`` is the piece set from
    :func:`collect_pieces` (or any iterable of
    :class:`~tpusystem_torch.checkpoint.memstore.HotState`). Returns
    ``(state, step, extras, source)`` with ``source`` in
    ``{'hot-reshard', 'disk'}``.

    The preference follows :func:`~tpusystem_torch.checkpoint.memstore.
    hot_resume`'s rung discipline — RAM wins only when it cannot lose
    information or integrity: contributions must agree on one step, that
    step must be >= the newest committed disk step, every leaf's pieces
    must cover the full array under the merge, and shapes/structure must
    match the target. Any failure logs and falls back to the disk
    checkpoint restored into the same target — which is why the chaos
    drill can demand bitwise equivalence between the two paths.
    """
    import pickle

    from tpusystem_torch.checkpoint.memstore import (deserialize_state,
                                                     merge_hot)
    entries = [entry for entry in contributions if entry is not None]
    hot = None
    if entries:
        try:
            hot = merge_hot(entries)
        except (ValueError, pickle.UnpicklingError) as error:
            logger.warning('elastic: hot pieces for %r did not merge (%s); '
                           'restoring from disk', identity, error)
    if hot is not None:
        disk_step = checkpointer.latest(identity)
        if disk_step is not None and hot.step < disk_step:
            logger.warning(
                'elastic: merged hot state for %r is stale (step %d < '
                'committed disk step %d); restoring from disk', identity,
                hot.step, disk_step)
            hot = None
    result = None
    if hot is not None:
        try:
            state = deserialize_state(hot.blob, target)
            result = (state, hot.step, hot.extras, 'hot-reshard')
        except (ValueError, pickle.UnpicklingError) as error:
            logger.warning('elastic: merged hot state for %r step %d failed '
                           'to reshard (%s); restoring from disk', identity,
                           hot.step, error)
    if result is None:
        state, step, extras = checkpointer.resume(identity, target)
        result = (state, step, extras, 'disk')
    mark = getattr(client, 'mark', None)
    if mark is not None:
        mark('restore', source=result[3], step=result[1])
    return result
