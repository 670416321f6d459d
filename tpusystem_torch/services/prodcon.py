"""Type-routed event bus: Producer -> Consumers (the port of
:mod:`tpusystem.services.prodcon`).

Domain occurrences ("Trained", "Validated", "Iterated") are dataclass events
dispatched to every registered consumer; each consumer routes by the event's
*type name* through a configurable name generator (default PascalCase ->
kebab-lower). A handler annotated ``ModelTrained | ModelEvaluated`` is
registered for every member of the union — both ``typing.Union`` and PEP-604
forms (reference parity ``torchsystem/services/prodcon.py:77-241``).

This in-process bus is the degenerate single-host case of the control plane:
:class:`tpusystem_torch.parallel.multihost.DistributedProducer` carries the
same API (in one process so far), so training code is the same on one card
and on many. Consumers must only ever touch *materialized* host values —
never device tensors that would force a sync inside the hot loop.
"""

from __future__ import annotations

import types
import typing
from collections.abc import Callable
from dataclasses import dataclass
from inspect import signature
from re import sub
from typing import Any

from tpusystem_torch.depends import Depends as Depends
from tpusystem_torch.depends import Provider, inject


def _pascal_to_kebab(name: str) -> str:
    return sub(r'(?<!^)(?=[A-Z])', '-', name).lower()


def _union_members(annotation: Any) -> tuple | None:
    """Members of a union annotation, or None when not a union.

    Handles ``typing.Union[A, B]``, PEP-604 ``A | B``, and parameterized
    generics (whose origin is registered instead).
    """
    if isinstance(annotation, types.UnionType):
        return typing.get_args(annotation)
    if typing.get_origin(annotation) is typing.Union:
        return typing.get_args(annotation)
    return None


class Consumer:
    """Routes events to handlers keyed by generated type name."""

    def __init__(
        self,
        name: str | None = None,
        *,
        provider: Provider | None = None,
        generator: Callable[[str], str] = _pascal_to_kebab,
    ) -> None:
        self.name = name
        self.handlers: dict[str, list[Callable[[Any], None]]] = {}
        self.types: dict[str, Any] = {}
        self.generator = generator
        self.provider = provider or Provider()

    @property
    def dependency_overrides(self) -> dict:
        return self.provider.dependency_overrides

    def register(self, annotation: Any, handler: Callable[..., None]) -> Callable[..., None]:
        """Register ``handler`` for ``annotation``; unions register every member."""
        members = _union_members(annotation)
        if members is not None:
            injected = handler
            for member in members:
                injected = self.register(member, handler)
            return injected
        origin = typing.get_origin(annotation)
        if origin is not None:
            return self.register(origin, handler)
        key = self.generator(annotation.__name__)
        self.types[key] = annotation
        injected = inject(self.provider)(handler)
        self.handlers.setdefault(key, []).append(injected)
        return injected

    def handler(self, wrapped: Callable[..., None]) -> Callable[..., None]:
        """Decorator: route by the **first parameter's annotation**."""
        parameters = signature(wrapped).parameters
        if not parameters:
            raise TypeError(
                f'consumer handler {wrapped.__name__!r} needs a first parameter '
                'annotated with the event type(s) it consumes')
        first = next(iter(parameters.values()))
        annotation = first.annotation
        if annotation is first.empty:
            raise TypeError(
                f'consumer handler {wrapped.__name__!r} first parameter must be '
                'annotated with the event type(s) it consumes')
        if isinstance(annotation, str):
            # PEP 563 (`from __future__ import annotations`) stringizes
            # annotations; resolve only the routing parameter so unrelated
            # unresolvable annotations (TYPE_CHECKING-only imports, locals)
            # don't break registration.
            function = getattr(wrapped, '__func__', wrapped)
            annotation = eval(annotation, getattr(function, '__globals__', {}))  # noqa: S307
        return self.register(annotation, wrapped)

    def consume(self, message: Any) -> None:
        """Invoke all handlers for the message's type; unknown types are ignored."""
        key = self.generator(message.__class__.__name__)
        for handler in self.handlers.get(key, []):
            handler(message)


class Producer:
    """Fans events out to every registered consumer, synchronously, in order.

    ``taps`` observe every dispatched message before routing — the hook used
    by :class:`tpusystem_torch.observe.EventLedger` to hash-chain the event stream
    for cross-host divergence detection.
    """

    def __init__(self) -> None:
        self.consumers: list[Consumer] = []
        self.taps: list[Callable[[Any], None]] = []

    def register(self, *consumers: Consumer) -> None:
        self.consumers.extend(consumers)

    def dispatch(self, message: Any) -> None:
        for tap in self.taps:
            tap(message)
        for consumer in self.consumers:
            consumer.consume(message)


def event(cls: type) -> type:
    """Declare an event message (a plain dataclass)."""
    return dataclass(cls)
