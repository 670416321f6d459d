"""Parallelism and recovery: the port of :mod:`tpusystem.parallel`, as far
as one process on one device goes: meshes and sharding policies in their
one-device form (a placement is "move to the mesh's device"), the
one-process control plane, the recovery policy and the :class:`Supervisor`.
Meshes over more than one device, collectives, pipelines, the TCP control
plane and elastic resizing are ROADMAP queue 1 item 9."""

from tpusystem_torch.parallel.mesh import (
    AXES, DATA, EXPERT, FSDP, MODEL, SEQ, STAGE,
    Mesh, MeshSpec, batch_sharding, replicated, single_device_mesh,
    stacked_batch_sharding,
)
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
from tpusystem_torch.parallel.supervisor import Supervisor
from tpusystem_torch.parallel.sharding import (FullyShardedDataParallel,
                                               ShardingPolicy)

__all__ = ['MeshSpec', 'single_device_mesh', 'batch_sharding', 'replicated',
           'stacked_batch_sharding',
           'ShardingPolicy', 'FullyShardedDataParallel',
           'AXES', 'DATA', 'FSDP', 'MODEL', 'SEQ', 'EXPERT', 'STAGE', 'Mesh',
           'World', 'world', 'agree', 'Loopback',
           'DistributedProducer', 'DistributedPublisher',
           'WorkerLost', 'WorkerJoined',
           'WorkerLostError', 'recovery_consumer', 'LOST_WORKER_EXIT',
           'Preempted', 'PREEMPTED_EXIT', 'RESTART_EXITS', 'exit_for_restart',
           'DivergenceError', 'DIVERGED_EXIT', 'CRASH_LOOP_EXIT',
           'RESIZED_EXIT', 'WorldResizedError',
           'FAILURE_EXIT', 'BlobError', 'BLOB_CHUNK', 'Supervisor']
