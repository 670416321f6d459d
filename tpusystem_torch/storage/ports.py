"""Ports: typed records + abstract storage interfaces (the port of
:mod:`tpusystem.storage.ports`).

Reference parity: ``examples/tinysys/tinysys/ports/{models,modules,metrics,
iterations,experiments}.py`` define ``attrs`` records and ABCs; services and
consumers depend only on these, adapters implement them. Here the records
are stdlib dataclasses and ``structure``/``unstructure`` replace cattrs.

All records key on the **registry hash** (deterministic identity —
:func:`tpusystem_torch.registry.gethash`), so rows written on one host
are meaningful to every other host and to post-hoc analysis tools.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, TypeVar

R = TypeVar('R')


def unstructure(record: Any) -> dict[str, Any]:
    """Record -> plain JSON-ready dict."""
    return dataclasses.asdict(record)


def structure(payload: dict[str, Any], kind: type[R]) -> R:
    """Plain dict -> record, ignoring unknown keys (forward compatibility)."""
    names = {f.name for f in dataclasses.fields(kind)}
    return kind(**{key: value for key, value in payload.items() if key in names})


@dataclass
class Experiment:
    """A named collection of model runs (``ports/experiments.py:11-25``)."""
    name: str
    id: int | None = None


@dataclass
class Model:
    """One trainable entity inside an experiment: its identity hash and the
    last completed epoch (``ports/models.py:20-41``)."""
    hash: str
    experiment: str
    epoch: int = 0


@dataclass
class Module:
    """Captured metadata of a network/criterion/optimizer attached to a
    model row (``ports/modules.py:14-25``)."""
    model: str                      # owning model's hash
    kind: str                       # 'nn' | 'criterion' | 'optimizer' | ...
    hash: str | None
    name: str
    arguments: dict[str, Any] = field(default_factory=dict)
    epoch: int = 0


@dataclass
class Metric:
    """One scalar metric point (``ports/metrics.py:11-19``)."""
    model: str
    name: str
    value: float
    epoch: int
    phase: str


@dataclass
class Iteration:
    """Data-pipeline configuration used for a phase at an epoch
    (``ports/iterations.py:12-23``)."""
    model: str
    phase: str
    hash: str | None
    name: str
    arguments: dict[str, Any] = field(default_factory=dict)
    epoch: int = 0


class Experiments(ABC):
    @abstractmethod
    def create(self, experiment: Experiment) -> int: ...

    @abstractmethod
    def get(self, name: str) -> Experiment | None: ...

    @abstractmethod
    def list(self) -> list[Experiment]: ...

    @abstractmethod
    def remove(self, name: str) -> None: ...


class Models(ABC):
    @abstractmethod
    def create(self, model: Model) -> None: ...

    @abstractmethod
    def read(self, hash: str, experiment: str) -> Model | None: ...

    @abstractmethod
    def update(self, model: Model) -> None: ...

    @abstractmethod
    def delete(self, hash: str, experiment: str) -> None: ...

    @abstractmethod
    def list(self, experiment: str) -> list[Model]: ...


class Modules(ABC):
    @abstractmethod
    def put(self, module: Module) -> None:
        """Upsert: when the latest stored row for (model, kind) carries the
        same hash, update its epoch in place; otherwise insert a new row —
        the reference's dedupe contract (``adapters/modules.py:33-41``),
        which records *when hyperparameters changed* rather than one row per
        epoch."""

    @abstractmethod
    def list(self, model: str) -> list[Module]: ...


class Metrics(ABC):
    @abstractmethod
    def add(self, metric: Metric) -> None: ...

    @abstractmethod
    def list(self, model: str) -> list[Metric]: ...

    @abstractmethod
    def clear(self, model: str) -> None: ...


class Iterations(ABC):
    @abstractmethod
    def put(self, iteration: Iteration) -> None:
        """Upsert keyed by (model, phase) with the same latest-hash dedupe as
        :meth:`Modules.put` (``adapters/iterations.py:22-29``)."""

    @abstractmethod
    def list(self, model: str) -> list[Iteration]: ...
