"""Parallelism and recovery: the port of :mod:`tpusystem.parallel`: meshes
over the ranks of a ``torch.distributed`` process group (one device a
rank; one device without a group), the collectives over a mesh axis, the
sharding policies (data parallelism and FSDP placing ``DTensor`` pieces),
the control plane of one process or many (the TCP hub, transports and
deputy), the chaos harness, the recovery policy, elastic membership, the
:class:`Supervisor`, tensor parallelism (``overlap``, ``schedule``: the
decomposed TP rings, the FSDP prefetch and the planners) and the pipelines
(``pipeline``: GPipe and 1F1B over ``stage``); sequence parallelism is
:mod:`tpusystem_torch.ops.ring`, expert parallelism
:class:`tpusystem_torch.ops.moe.MoEMLP` on a mesh (its exchanges over
``expert``: ``collectives.all_to_all`` and ``ragged_all_to_all``) and
table parallelism :class:`tpusystem_torch.recsys.ShardedEmbedding`."""

from tpusystem_torch.parallel.mesh import (
    AXES, DATA, EXPERT, FSDP, MODEL, SEQ, STAGE,
    Mesh, MeshSpec, PartitionSpec, batch_sharding, replicated,
    scan_carry_constraint, single_device_mesh, stacked_batch_sharding,
)
from tpusystem_torch.parallel.multihost import (
    BLOB_CHUNK, BlobError, CollectiveTimeout, ControlPlaneFailover,
    DistributedProducer, DistributedPublisher, Hub, Loopback, TcpTransport,
    World, WorkerJoined, WorkerLost, agree, connect, world,
)
from tpusystem_torch.parallel.collectives import (
    all_gather, all_reduce_mean, all_reduce_sum, all_to_all, axis_index,
    axis_size, pp_hop, reduce_scatter, replica_checksums, ring_allgather,
    ring_reducescatter, ring_shift, ring_shift_chunked,
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
from tpusystem_torch.parallel.sharding import (DataParallel,
                                               FullyShardedDataParallel,
                                               ShardingPolicy, TensorParallel)
from tpusystem_torch.parallel.pipeline import (PipelineParallel,
                                               compose_stacked_rules,
                                               pipeline_apply, pipeline_train)
from tpusystem_torch.parallel.overlap import (allgather_matmul,
                                              allgather_plan,
                                              matmul_reducescatter,
                                              reducescatter_plan, tp_ffn,
                                              tp_swiglu)
from tpusystem_torch.parallel.schedule import (DecodeTpPlan, FsdpPlan,
                                               MoePlan, OverlapSchedule,
                                               PpPlan, decode_tp_plan,
                                               fsdp_plan, moe_plan, pp_plan,
                                               resolve_schedule,
                                               schedule_applicable,
                                               scheduled_ffn,
                                               scheduled_swiglu)

__all__ = ['MeshSpec', 'single_device_mesh', 'batch_sharding', 'replicated',
           'scan_carry_constraint', 'stacked_batch_sharding',
           'ShardingPolicy', 'DataParallel', 'FullyShardedDataParallel',
           'TensorParallel', 'PipelineParallel', 'compose_stacked_rules',
           'pipeline_apply', 'pipeline_train', 'PartitionSpec',
           'all_reduce_sum', 'all_reduce_mean', 'all_gather', 'reduce_scatter',
           'all_to_all', 'ring_shift', 'ring_shift_chunked', 'pp_hop',
           'ring_allgather', 'ring_reducescatter', 'axis_index', 'axis_size',
           'replica_checksums',
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
           'PreemptionWave', 'CorruptGrads', 'CorruptBatch', 'FlipParamBit',
           'allgather_matmul', 'matmul_reducescatter',
           'allgather_plan', 'reducescatter_plan', 'tp_ffn', 'tp_swiglu',
           'OverlapSchedule', 'FsdpPlan', 'fsdp_plan', 'resolve_schedule',
           'PpPlan', 'pp_plan', 'MoePlan', 'moe_plan',
           'DecodeTpPlan', 'decode_tp_plan',
           'schedule_applicable', 'scheduled_ffn', 'scheduled_swiglu']
