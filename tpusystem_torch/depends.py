"""Dependency-injection kernel: the port of :mod:`tpusystem.depends`.

FastAPI-style late-bound dependency injection: a parameter whose default is
``Depends(factory)`` is filled at call time by invoking ``factory`` (or the
override registered for it on the :class:`Provider`). Generator factories are
treated as managed resources — the value yielded is injected and the generator
is resumed once more for teardown after the call returns.

Behavioral parity with the reference DI kernel
(``torchsystem/depends.py:26-86``), with two deliberate extensions:

* dependencies may themselves declare ``Depends(...)`` parameters and are
  resolved recursively;
* a factory resolved more than once within a single call is invoked exactly
  once (per-call memoization), so e.g. a device provider shared by several
  dependencies yields one device object.

In the port this kernel is how runtime facts — the ``torch.device`` a model
is built on, the seed, the host/process topology, checkpoint stores — reach
services and compiler steps without the domain code importing them.
"""

from __future__ import annotations

from collections.abc import Callable, Generator
from contextlib import ExitStack, contextmanager
from inspect import signature
from functools import wraps
from typing import Any


class Provider:
    """Holds the dependency override table.

    Overrides are keyed by the *original* factory callable, exactly like the
    reference contract (``torchsystem/depends.py:26-31``): services, buses and
    compilers expose ``dependency_overrides`` mapping factory -> replacement.
    """

    def __init__(self) -> None:
        self.dependency_overrides: dict[Callable, Callable] = {}

    def override(self, dependency: Callable, override: Callable) -> None:
        self.dependency_overrides[dependency] = override


class Dependency:
    """Marker wrapper produced by :func:`Depends`."""

    __slots__ = ('factory',)

    def __init__(self, factory: Callable) -> None:
        self.factory = factory

    def __repr__(self) -> str:  # pragma: no cover
        return f'Depends({getattr(self.factory, "__name__", self.factory)!r})'


def Depends(factory: Callable) -> Any:
    """Declare a parameter default as an injected dependency.

    The factory may return a plain value or be a generator function; in the
    generator case the first yielded value is injected and the generator is
    finalized (resumed once) after the wrapped call returns, giving
    deterministic resource cleanup (reference contract
    ``torchsystem/depends.py:57-77``).
    """
    return Dependency(factory)


@contextmanager
def _managed(generator: Generator):
    try:
        value = next(generator)
        yield value
    finally:
        next(generator, None)


def _materialize(factory: Callable, provider: Provider, stack: ExitStack,
                 cache: dict[Callable, Any]) -> Any:
    """Invoke a dependency factory, recursively resolving its own deps."""
    factory = provider.dependency_overrides.get(factory, factory)
    if factory in cache:
        return cache[factory]
    bound, _ = _bind(factory, provider, stack, cache, (), {})
    produced = factory(*bound.args, **bound.kwargs)
    if isinstance(produced, Generator):
        produced = stack.enter_context(_managed(produced))
    cache[factory] = produced
    return produced


def _bind(function: Callable, provider: Provider, stack: ExitStack,
          cache: dict[Callable, Any], args: tuple, kwargs: dict):
    parameters = signature(function).parameters
    bound = signature(function).bind_partial(*args, **kwargs)
    for name, parameter in parameters.items():
        if name not in bound.arguments and isinstance(parameter.default, Dependency):
            bound.arguments[name] = _materialize(
                parameter.default.factory, provider, stack, cache)
    return bound, stack


def resolve(function: Callable, provider: Provider, *args, **kwargs):
    """Bind ``function``'s injected parameters; returns (bound_args, exit_stack).

    The caller is responsible for entering/closing the returned
    :class:`~contextlib.ExitStack` around the actual call so generator
    dependencies tear down afterwards.
    """
    stack = ExitStack()
    return _bind(function, provider, stack, {}, args, kwargs)


def inject(provider: Provider) -> Callable[[Callable], Callable]:
    """Decorator: resolve ``Depends`` parameters of the wrapped callable at
    every call, honoring the provider's current overrides (late binding)."""

    def decorator(function: Callable) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            bound, stack = resolve(function, provider, *args, **kwargs)
            with stack:
                return function(*bound.args, **bound.kwargs)
        return wrapper
    return decorator
