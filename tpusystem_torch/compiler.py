"""Aggregate compilation pipeline: the port of :mod:`tpusystem.compiler`.

Building an aggregate is a staged process: construct the module tree on its
device, draw or load its weights, assemble the criterion, optimizer and
train state, then restore state from a checkpoint keyed by the aggregate's
identity. Each stage may need runtime facts (the device, the seed, the
checkpoint store, the resume epoch) that only exist at composition time — so
steps are DI-injected callables, mirroring the reference ``Compiler``
(``torchsystem/compiler.py:105-168``).

Chaining contract: the first step receives ``compile(*args)``'s arguments; a
step returning a tuple is splatted into the next step; any other value is
passed as the single argument. A step returning ``None`` is treated as a
side-effect stage: the next step receives the latest produced value — or the
original ``compile(*args, **kwargs)`` arguments when no step has produced a
value yet. This is a deliberate cleanup of the reference's falsy-result quirk
(``torchsystem/compiler.py:164`` re-sends the original args whenever a step
returns *any* falsy value; here only ``None`` passes through).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, Generic, TypeVar

from tpusystem_torch.depends import Depends as Depends  # re-export
from tpusystem_torch.depends import Provider, inject

T = TypeVar('T')

_PENDING = object()  # no step has produced a value yet


def compile(function: Callable) -> Callable:
    """Return ``function`` itself: the port's steps run eagerly over its
    hand-written kernels, so there is nothing to lower. The reference
    binds ``jax.jit`` here (``tpusystem/compiler.py:38``), and the upstream
    TorchSystem ``torch.compile``; the port uses neither."""
    return function


class Compiler(Generic[T]):
    """DI-aware pipeline of build steps producing a compiled aggregate."""

    def __init__(self, *, provider: Provider | None = None) -> None:
        self.steps: list[Callable] = []
        self.provider = provider or Provider()

    @property
    def dependency_overrides(self) -> dict:
        """Override table for late-binding runtime facts into steps.

        Example::

            compiler.dependency_overrides[device] = lambda: 'cuda'
        """
        return self.provider.dependency_overrides

    def step(self, callable: Callable) -> Callable:
        """Register a pipeline stage (decorator). Returns the injected fn."""
        injected = inject(self.provider)(callable)
        self.steps.append(injected)
        return injected

    def compile(self, *args, **kwargs) -> T | Any | None:
        """Run the pipeline; the last stage's product is the aggregate."""
        current: Any = _PENDING
        for step in self.steps:
            if current is _PENDING:
                produced = step(*args, **kwargs)
            elif isinstance(current, tuple):
                produced = step(*current)
            else:
                produced = step(current)
            if produced is not None:
                current = produced
        return None if current is _PENDING else current
