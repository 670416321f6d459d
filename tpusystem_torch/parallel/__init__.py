"""Parallelism and recovery: the port of :mod:`tpusystem.parallel`, as far
as one process goes (the one-process control plane and the recovery
policy). Meshes, sharding, collectives, pipelines, the TCP control plane,
the supervisor and elastic resizing are ROADMAP queue 1 items 8 and 9."""

from tpusystem_torch.parallel.multihost import (
    BLOB_CHUNK, BlobError, DistributedProducer, DistributedPublisher,
    Loopback, World, WorkerJoined, WorkerLost, agree, world,
)
from tpusystem_torch.parallel.recovery import (CRASH_LOOP_EXIT, DIVERGED_EXIT,
                                               FAILURE_EXIT, LOST_WORKER_EXIT,
                                               PREEMPTED_EXIT, RESIZED_EXIT,
                                               RESTART_EXITS, DivergenceError,
                                               Preempted, WorkerLostError,
                                               WorldResizedError,
                                               exit_for_restart,
                                               recovery_consumer)

__all__ = ['World', 'world', 'agree', 'Loopback',
           'DistributedProducer', 'DistributedPublisher',
           'WorkerLost', 'WorkerJoined',
           'WorkerLostError', 'recovery_consumer', 'LOST_WORKER_EXIT',
           'Preempted', 'PREEMPTED_EXIT', 'RESTART_EXITS', 'exit_for_restart',
           'DivergenceError', 'DIVERGED_EXIT', 'CRASH_LOOP_EXIT',
           'RESIZED_EXIT', 'WorldResizedError',
           'FAILURE_EXIT', 'BlobError', 'BLOB_CHUNK']
