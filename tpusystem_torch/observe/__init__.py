"""Observability: the port of :mod:`tpusystem.observe`, as far as it goes.

The canonical training events and the event ledger are ported. The logging,
TensorBoard, experiment-tracking and checkpoint consumers, the span tracer,
the flight recorder and ``observe/profile.py`` are not (ROADMAP queue 1
item 10).

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
from tpusystem_torch.observe.ledger import EventLedger, LedgerDivergence

__all__ = [
    'Trained', 'Validated', 'Iterated', 'StepTimed',
    'AnomalyDetected', 'BackoffApplied', 'RolledBack', 'ReplicaDiverged',
    'WorkerExited', 'WorkerRelaunched', 'RecoveryTimeline',
    'RequestAdmitted', 'RequestEvicted', 'RequestCompleted', 'ServeStepped',
    'JobAdmitted', 'JobPreempted', 'JobHalted', 'CapacityArbitrated',
    'EventLedger', 'LedgerDivergence',
]
