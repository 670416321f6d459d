"""Structural contracts between services and implementations (the twin of
``examples/tinysys/tinysys/domain.py``): services depend on these
protocols, never on concrete classes, so any aggregate satisfying
``Model`` trains under the same service handlers.
"""

from __future__ import annotations

from typing import Any, Iterator, Protocol, runtime_checkable


@runtime_checkable
class Model(Protocol):
    """What the training service needs from an aggregate."""
    id: Any
    epoch: int
    phase: str

    def fit(self, inputs, targets) -> tuple[Any, Any]: ...
    def evaluate(self, inputs, targets) -> tuple[Any, Any]: ...


@runtime_checkable
class Loader(Protocol):
    def __iter__(self) -> Iterator[tuple]: ...
    def __len__(self) -> int: ...


@runtime_checkable
class Metrics(Protocol):
    def update(self, loss, predictions, targets) -> None: ...
    def compute(self) -> dict[str, float]: ...
    def reset(self) -> None: ...
