"""Document-store adapters for the storage ports (the port of
:mod:`tpusystem.storage.adapters`).

Reference parity: the TinyDB adapters
(``examples/tinysys/tinysys/adapters/*.py``) including the latest-hash
upsert semantics of ``Modules.put`` (``adapters/modules.py:33-41``) and the
phase-keyed upsert of ``Iterations.put`` (``adapters/iterations.py:22-29``).
"""

from __future__ import annotations

from tpusystem_torch.storage.documents import DocumentStore, where
from tpusystem_torch.storage import ports
from tpusystem_torch.storage.ports import (
    Experiment, Iteration, Metric, Model, Module, structure, unstructure,
)


class DocumentExperiments(ports.Experiments):
    def __init__(self, store: DocumentStore) -> None:
        self.table = store.table('experiments')

    def create(self, experiment: Experiment) -> int:
        existing = self.table.get(where(name=experiment.name))
        if existing is not None:
            return existing['id']
        payload = unstructure(experiment)
        payload['id'] = self.table.insert(payload)
        self.table.update({'id': payload['id']}, where(name=experiment.name))
        return payload['id']

    def get(self, name: str) -> Experiment | None:
        payload = self.table.get(where(name=name))
        return structure(payload, Experiment) if payload else None

    def list(self) -> list[Experiment]:
        return [structure(payload, Experiment) for payload in self.table.all()]

    def remove(self, name: str) -> None:
        self.table.remove(where(name=name))


class DocumentModels(ports.Models):
    def __init__(self, store: DocumentStore) -> None:
        self.table = store.table('models')

    def create(self, model: Model) -> None:
        if self.read(model.hash, model.experiment) is None:
            self.table.insert(unstructure(model))

    def read(self, hash: str, experiment: str) -> Model | None:
        payload = self.table.get(where(hash=hash, experiment=experiment))
        return structure(payload, Model) if payload else None

    def update(self, model: Model) -> None:
        matched = self.table.update(
            {'epoch': model.epoch}, where(hash=model.hash, experiment=model.experiment))
        if not matched:
            self.table.insert(unstructure(model))

    def delete(self, hash: str, experiment: str) -> None:
        self.table.remove(where(hash=hash, experiment=experiment))

    def list(self, experiment: str) -> list[Model]:
        return [structure(payload, Model)
                for payload in self.table.search(where(experiment=experiment))]


class DocumentModules(ports.Modules):
    def __init__(self, store: DocumentStore) -> None:
        self.table = store.table('modules')

    def put(self, module: Module) -> None:
        rows = self.table.search(where(model=module.model, kind=module.kind))
        if rows and rows[-1]['hash'] == module.hash:
            # bump only the *latest* row: earlier rows with the same hash are
            # history (hyperparameters changed away and back) and must keep
            # the epochs at which they were recorded
            self.table.update_last(
                {'epoch': module.epoch},
                where(model=module.model, kind=module.kind, hash=module.hash))
        else:
            self.table.insert(unstructure(module))

    def list(self, model: str) -> list[Module]:
        return [structure(payload, Module)
                for payload in self.table.search(where(model=model))]


class DocumentMetrics(ports.Metrics):
    def __init__(self, store: DocumentStore) -> None:
        self.table = store.table('metrics')

    def add(self, metric: Metric) -> None:
        self.table.insert(unstructure(metric))

    def list(self, model: str) -> list[Metric]:
        return [structure(payload, Metric)
                for payload in self.table.search(where(model=model))]

    def clear(self, model: str) -> None:
        self.table.remove(where(model=model))


class DocumentIterations(ports.Iterations):
    def __init__(self, store: DocumentStore) -> None:
        self.table = store.table('iterations')

    def put(self, iteration: Iteration) -> None:
        rows = self.table.search(where(model=iteration.model, phase=iteration.phase))
        if rows and rows[-1]['hash'] == iteration.hash:
            self.table.update_last(
                {'epoch': iteration.epoch},
                where(model=iteration.model, phase=iteration.phase,
                      hash=iteration.hash))
        else:
            self.table.insert(unstructure(iteration))

    def list(self, model: str) -> list[Iteration]:
        return [structure(payload, Iteration)
                for payload in self.table.search(where(model=model))]
