"""Observability: the port of :mod:`tpusystem.observe`.

Events, logging, TensorBoard, experiment tracking, the span tracer, the
flight recorder, latency histograms and the profiler. The consumers wire
onto one producer — stdlib logging summaries, document-store metric
persistence, TensorBoard scalars — so the trainer never knows its
observers. Every module but ``profile`` (``torch.profiler`` in place of
``jax.profiler``) is the reference's, copied.

Hot-path rule (SURVEY.md §7.3): every payload on the bus is already a
materialized host value — consumers never touch device tensors, so one epoch
has exactly one device→host sync per phase (``metrics.compute()``).
"""

from tpusystem_torch.observe.events import (AnomalyDetected, BackoffApplied,
                                            CapacityArbitrated, Iterated,
                                            JobAdmitted, JobHalted,
                                            JobPreempted, RecoveryTimeline,
                                            ReplicaDiverged, RequestAdmitted,
                                            RequestCompleted, RequestEvicted,
                                            RolledBack, ServeStepped,
                                            StepTimed, Trained, Validated,
                                            WorkerExited, WorkerRelaunched)
from tpusystem_torch.observe.flight import FlightRecorder
from tpusystem_torch.observe.ledger import EventLedger, LedgerDivergence
from tpusystem_torch.observe.logs import logging_consumer
from tpusystem_torch.observe.metrics import (Histogram, ServeLatency,
                                             serve_metrics_consumer)
# the trace MODULE must import before profile's trace FUNCTION: importing
# a submodule binds it as a package attribute, and the later function
# import deliberately wins — `observe.trace` stays the device-profiler
# context manager it has always been. Span tracing is reached as
# `observe.Tracer` (preferred) or `from tpusystem_torch.observe.trace
# import ...`; NOT via attribute access on the package (`import
# tpusystem_torch.observe.trace; tpusystem_torch.observe.trace.Tracer`
# resolves the shadowing function and fails — the price of keeping the old
# name).
from tpusystem_torch.observe.trace import Span, TraceContext, Tracer
from tpusystem_torch.observe.profile import (ProfilerBusy, StepTimer,
                                             annotate, step_span, trace)
from tpusystem_torch.observe.tensorboard import (SummaryWriter,
                                                 tensorboard_consumer)
from tpusystem_torch.observe.tracking import (
    checkpoint_consumer, experiment, metrics_store, models_store,
    modules_store, iterations_store, repository, tracking_consumer,
)

__all__ = [
    'Trained', 'Validated', 'Iterated', 'StepTimed',
    'AnomalyDetected', 'BackoffApplied', 'RolledBack', 'ReplicaDiverged',
    'WorkerExited', 'WorkerRelaunched', 'RecoveryTimeline',
    'RequestAdmitted', 'RequestEvicted', 'RequestCompleted', 'ServeStepped',
    'JobAdmitted', 'JobPreempted', 'JobHalted', 'CapacityArbitrated',
    'logging_consumer', 'SummaryWriter', 'tensorboard_consumer',
    'tracking_consumer', 'checkpoint_consumer', 'experiment',
    'metrics_store', 'models_store',
    'modules_store', 'iterations_store', 'repository',
    'EventLedger', 'LedgerDivergence', 'StepTimer', 'annotate', 'step_span',
    'trace', 'ProfilerBusy',
    'Tracer', 'Span', 'TraceContext',
    'Histogram', 'ServeLatency', 'serve_metrics_consumer',
    'FlightRecorder',
]
