"""Parallelism and recovery: the port of :mod:`tpusystem.parallel`, as far
as one device a process goes: meshes and sharding policies in their
one-device form (a placement is "move to the mesh's device"), the control
plane of one process or many (the TCP hub, transports and deputy), the
chaos harness, the recovery policy, elastic membership and the
:class:`Supervisor`. Meshes over more than one device, device collectives,
pipelines and resharding across devices are ROADMAP queue 1 item 9."""

from tpusystem_torch.parallel.mesh import (
    AXES, DATA, EXPERT, FSDP, MODEL, SEQ, STAGE,
    Mesh, MeshSpec, batch_sharding, replicated, single_device_mesh,
    stacked_batch_sharding,
)
from tpusystem_torch.parallel.multihost import (
    BLOB_CHUNK, BlobError, CollectiveTimeout, ControlPlaneFailover,
    DistributedProducer, DistributedPublisher, Hub, Loopback, TcpTransport,
    World, WorkerJoined, WorkerLost, agree, connect, world,
)
from tpusystem_torch.parallel.chaos import (ChaosHub, ChaosTransport,
                                            CorruptBatch, CorruptGrads,
                                            DieAtStep, Faults, FlipParamBit,
                                            PreemptionWave, WorkerKilled)
from tpusystem_torch.parallel.elastic import (ELASTIC_ENV, ElasticCoordinator,
                                              ElasticPolicy, ResizeDecision,
                                              collect_pieces,
                                              elastic_consumer,
                                              elastic_resume)
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
           'World', 'world', 'connect', 'agree', 'Hub', 'Loopback',
           'ControlPlaneFailover', 'CollectiveTimeout',
           'TcpTransport', 'DistributedProducer', 'DistributedPublisher',
           'WorkerLost', 'WorkerJoined',
           'WorkerLostError', 'recovery_consumer', 'LOST_WORKER_EXIT',
           'Preempted', 'PREEMPTED_EXIT', 'RESTART_EXITS', 'exit_for_restart',
           'DivergenceError', 'DIVERGED_EXIT', 'CRASH_LOOP_EXIT',
           'RESIZED_EXIT', 'WorldResizedError',
           'FAILURE_EXIT', 'BlobError', 'BLOB_CHUNK', 'Supervisor',
           'ELASTIC_ENV', 'ElasticCoordinator', 'ElasticPolicy',
           'ResizeDecision', 'collect_pieces', 'elastic_consumer',
           'elastic_resume',
           'Faults', 'ChaosTransport', 'ChaosHub', 'DieAtStep', 'WorkerKilled',
           'PreemptionWave', 'CorruptGrads', 'CorruptBatch', 'FlipParamBit']
