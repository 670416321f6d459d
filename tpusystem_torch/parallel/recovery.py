"""Elastic recovery policy, worker loss as a domain event with a decision:
the port of :mod:`tpusystem.parallel.recovery`.

The reference has no failure machinery beyond exceptions-as-events
(SURVEY.md §5 "failure detection / elastic recovery — absent"). The
recovery story composes three pieces:

1. **detect** — the control plane surfaces a crashed or silent host as a
   :class:`~tpusystem_torch.parallel.multihost.WorkerLost` event on every
   other host (socket death immediately; heartbeat timeout otherwise).
2. **decide** — the :func:`recovery_consumer` here turns that event into
   an :class:`WorkerLostError` raised on the host loop at the next
   ``runtime.sync()`` (remote events dispatch at drain time, so the error
   unwinds the epoch loop, never a collective mid-step).
3. **resume** — a device mesh cannot be resized live: recovery *is* restart.
   The job exits, the scheduler relaunches it, and the compilation
   pipeline's ``bring_epoch``/``restore_weights`` steps resume from the
   last committed checkpoint by identity hash (SURVEY.md §3.5) — the same
   path as an ordinary preemption.

Typical wiring::

    runtime.producer.register(recovery_consumer())
    try:
        for epoch in range(model.epoch, epochs):
            service.handle('iterate', model, loaders, metrics)
            runtime.sync()                  # WorkerLostError raises here
    except WorkerLostError as loss:
        repository.wait()                   # keep the last good checkpoint
        raise SystemExit(LOST_WORKER_EXIT)  # scheduler restarts -> resume

``policy='observe'`` logs instead of raising — for jobs that prefer to
finish the epoch on the survivors' data shards and stop at the agreed
early-stop point.

The port runs one process so far (:mod:`tpusystem_torch.runtime`), where no
peer can be lost. The launcher, the elastic protocol, the sentinel, the
serving fleet and the flight recorder that the exit codes below speak of are
the reference's (``tpusystem.parallel.Supervisor``, ``tpusystem.parallel.
elastic``, ``tpusystem.train.Sentinel``, ``tpusystem.serve.fleet``,
``tpusystem.observe.FlightRecorder``) and not ported yet (ROADMAP queue 1
items 5, 8, 9 and 10); so :func:`exit_for_restart` maps the exit code and
flushes no black box.
"""

from __future__ import annotations

import logging
import signal as signal_module

from tpusystem_torch.parallel.multihost import WorkerJoined, WorkerLost
from tpusystem_torch.services.prodcon import Consumer

logger = logging.getLogger('tpusystem.recovery')

# conventional exit codes a launcher maps to "restart me": 42 is a peer
# loss (the mesh must re-form), 43 a preemption of THIS host (SIGTERM from
# the scheduler); both resume from the last committed checkpoint. 44 is
# the sentinel's bounded give-up (DivergenceError): deliberately NOT in
# RESTART_EXITS — a blind relaunch of a deterministic divergence replays
# it; launchers should halt for triage (or cap automatic retries and
# adjust hyperparameters between attempts). 45 is emitted by the
# *launcher* side (:class:`tpusystem.parallel.Supervisor`) when the worker
# crash-loops: restartable exits kept arriving within seconds of launch,
# so relaunching has stopped making progress — halt for triage. 46 is the
# elastic-resize handshake (:mod:`tpusystem.parallel.elastic`): the
# supervisors agreed a NEW world size and this worker must be relaunched
# under the new world spec — restartable by definition (the relaunch IS
# the resize), and distinct from 42/43 so the timeline and ledger can
# tell a planned reshard from a fault. 47 is a deposed serving router
# (:class:`tpusystem.serve.fleet.RouterFenced`): a standby observed its
# missed lease renewals, fenced the term, and took over — deliberately
# NOT in RESTART_EXITS, because relaunching the old-term router would
# split-brain placements against the new incumbent; the supervisor
# halts it and the standby IS the restart. 1 is the generic non-restart
# failure (an unrecognized exception is a bug, not a recoverable fault —
# relaunching it forever would hide it).
LOST_WORKER_EXIT = 42
PREEMPTED_EXIT = 43
DIVERGED_EXIT = 44
CRASH_LOOP_EXIT = 45
RESIZED_EXIT = 46
ROUTER_FENCED_EXIT = 47
FAILURE_EXIT = 1
RESTART_EXITS = frozenset({LOST_WORKER_EXIT, PREEMPTED_EXIT, RESIZED_EXIT})


class WorkerLostError(RuntimeError):
    """A peer host died; the job should checkpoint-fence and restart.

    ``reason`` distinguishes the two detection paths — ``'socket'`` (the
    peer's connection died without a ``bye``: a crash or SIGKILL,
    detected immediately) vs ``'heartbeat'`` (the peer stopped
    heartbeating: alive-but-wedged, detected only after the liveness
    timeout). The two have different MTTR profiles — a socket death is
    seen in milliseconds, a heartbeat stall costs the full timeout before
    recovery even *starts* — so the ledger and recovery timeline record
    which one fired.
    """

    def __init__(self, rank: int, last_seen: float, reason: str = 'socket'):
        detail = ('socket death' if reason == 'socket'
                  else f'{reason} stall past the liveness timeout')
        super().__init__(
            f'worker {rank} lost to {detail} (last heartbeat at '
            f't={last_seen:.1f}); restart the job to resume from the last '
            'committed checkpoint')
        self.rank = rank
        self.last_seen = last_seen
        self.reason = reason


class Preempted(RuntimeError):
    """The scheduler is evicting this host (SIGTERM or maintenance notice).

    Raised on the host loop thread at the next ``runtime.sync()`` drain
    point — never from inside the signal handler, where the job could be
    mid-collective — so the epoch loop unwinds at a step boundary, fences
    an emergency checkpoint, and exits with :data:`PREEMPTED_EXIT`::

        try:
            ... epoch loop with runtime.sync() ...
        except (Preempted, WorkerLostError) as reason:
            checkpointer.save(identity, state.global_step, state,
                              extras=resume_extras(state, loader))
            checkpointer.fence(identity)        # durability receipt
            raise exit_for_restart(reason)
    """

    def __init__(self, signum: int):
        name = signal_module.Signals(signum).name
        super().__init__(
            f'preempted by {name}; checkpoint-fence and exit '
            f'{PREEMPTED_EXIT} so the scheduler restarts the job')
        self.signum = signum


class WorldResizedError(RuntimeError):
    """The supervisors agreed a new world size; this worker must restart
    under the new spec.

    Raised on the host loop at a drain point by
    :func:`tpusystem.parallel.elastic.elastic_consumer` when the elastic
    protocol (:class:`tpusystem.parallel.elastic.ElasticCoordinator`)
    commits a membership epoch while the worker is mid-run. Maps to
    :data:`RESIZED_EXIT` (46), which IS in :data:`RESTART_EXITS`: the
    relaunch is the resize — the supervisor re-execs the worker with the
    new world spec in its environment, the worker rebuilds the mesh at
    the agreed size and hot-reshards its state from the memstore tier
    (:func:`tpusystem.parallel.elastic.elastic_resume`).
    """

    def __init__(self, epoch: int, members: tuple):
        super().__init__(
            f'world resized to {len(members)} hosts (membership epoch '
            f'{epoch}, members {sorted(members)}); exit {RESIZED_EXIT} so '
            f'the supervisor relaunches under the new world spec')
        self.epoch = epoch
        self.members = tuple(members)


class DivergenceError(RuntimeError):
    """Training diverged beyond the sentinel's escalation ladder.

    Raised by :class:`tpusystem.train.Sentinel` when the bounded give-up is
    reached (skip → backoff → rollback all failed, or a cross-replica
    parity check flagged silent data corruption). Maps to
    :data:`DIVERGED_EXIT` (44) in the launcher contract — unlike 42/43 this
    is *not* an automatic-restart code: a deterministic divergence replays
    under a blind relaunch, so the launcher should halt for a human (or an
    automated sweep) to change something before retrying. An SDC parity
    failure also lands here: restart from the last committed checkpoint —
    which passed its parity check — after swapping out the suspect host.
    """

    def __init__(self, message: str, *, step: int | None = None):
        super().__init__(message)
        self.step = step


def exit_for_restart(reason: BaseException) -> SystemExit:
    """Map a recovery exception to its contract ``SystemExit``.

    ``raise exit_for_restart(error)`` ends the process with the exit code
    the launcher contract recognizes: :data:`RESTART_EXITS` (42 worker
    lost / 43 preempted / 46 resized) relaunch the job and resume from
    the last committed checkpoint (for 46: under the new world spec);
    :data:`DIVERGED_EXIT` (44, from :class:`DivergenceError`) halts for
    triage.

    Only the recovery exceptions map to contract codes. An exception
    from another layer can still opt into the contract by carrying an
    integer ``exit_code`` attribute (the serving router's
    :class:`~tpusystem.serve.fleet.RouterFenced` maps itself to
    :data:`ROUTER_FENCED_EXIT` this way — this module cannot import
    ``serve`` without a layering cycle). Anything else — a plain
    ``ValueError``, ``KeyboardInterrupt``, an assertion — is a *bug*,
    not a recoverable fault, and returns the generic
    :data:`FAILURE_EXIT`: mapping unknown exceptions to a restartable
    code (the old behavior) would relaunch a deterministic crash forever.

    The reference also flushes its installed ``FlightRecorder`` here;
    the port has none yet (ROADMAP queue 1 item 10).
    """
    if isinstance(reason, WorkerLostError):
        code = LOST_WORKER_EXIT
    elif isinstance(reason, Preempted):
        code = PREEMPTED_EXIT
    elif isinstance(reason, WorldResizedError):
        code = RESIZED_EXIT
    elif isinstance(reason, DivergenceError):
        code = DIVERGED_EXIT
    elif isinstance(getattr(reason, 'exit_code', None), int):
        code = reason.exit_code          # e.g. RouterFenced -> 47
    else:
        code = FAILURE_EXIT
    return SystemExit(code)


def recovery_consumer(policy: str = 'abort') -> Consumer:
    """Consumer deciding what worker loss means for this job.

    ``'abort'`` (default): raise :class:`WorkerLostError` from the drain
    point — the restart-resume cycle above. ``'observe'``: log and carry
    on (the survivors still agree any stop collectively).
    """
    if policy not in ('abort', 'observe'):
        raise ValueError(f"policy must be 'abort' or 'observe', got {policy!r}")
    consumer = Consumer('recovery')

    @consumer.handler
    def on_worker_lost(event: WorkerLost) -> None:
        if policy == 'abort':
            raise WorkerLostError(event.rank, event.last_seen, event.reason)
        logger.warning('worker %d lost (%s, last seen t=%.1f); continuing',
                       event.rank, event.reason, event.last_seen)

    @consumer.handler
    def on_worker_joined(event: WorkerJoined) -> None:
        logger.info('worker %d joined the control plane', event.rank)

    return consumer
