"""Experiment-tracking storage: the port of :mod:`tpusystem.storage`.

The reference persists experiment state (model rows, module metadata, metric
curves, loader configs) through a ports-and-adapters boundary: ``attrs``
records + ABCs in ``examples/tinysys/tinysys/ports/`` and TinyDB tables in
``examples/tinysys/tinysys/adapters/``. Here the same boundary is part of
the framework: typed records + port protocols
(:mod:`tpusystem_torch.storage.ports`) and a zero-dependency JSON document
store (:mod:`tpusystem_torch.storage.documents`) backing the default
adapters (:mod:`tpusystem_torch.storage.adapters`).

Multi-process note: storage is a *host-side, rank-0 concern* — consumer
placement (:mod:`tpusystem_torch.runtime`) routes storage consumers to one
process so a job never writes the same row N times.
"""

from tpusystem_torch.storage.documents import DocumentStore
from tpusystem_torch.storage.ports import (
    Experiment, Experiments, Iteration, Iterations, Metric, Metrics,
    Model, Models, Module, Modules, structure, unstructure,
)
from tpusystem_torch.storage.adapters import (
    DocumentExperiments, DocumentIterations, DocumentMetrics,
    DocumentModels, DocumentModules,
)

__all__ = [
    'DocumentStore',
    'Experiment', 'Model', 'Module', 'Metric', 'Iteration',
    'Experiments', 'Models', 'Modules', 'Metrics', 'Iterations',
    'DocumentExperiments', 'DocumentModels', 'DocumentModules',
    'DocumentMetrics', 'DocumentIterations',
    'structure', 'unstructure',
]
