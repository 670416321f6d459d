"""Topic-routed message bus: Publisher -> Subscribers (the port of
:mod:`tpusystem.services.pubsub`).

Where the Consumer routes by event *type*, a ``Subscriber`` routes by
*topic* string — the natural shape for metric streams (``'loss'``,
``'accuracy'``) where many handlers observe the same scalar channel.
Handler exceptions propagate to the publisher, which is the designed
early-stopping signal path (reference parity
``torchsystem/services/pubsub.py:73-222``; exception propagation pinned by
``tests/test_pubsub.py:25-37``).

``receive`` is safely re-entrant: a handler may re-route a message to
another topic on the same subscriber.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

from tpusystem_torch.depends import Depends as Depends
from tpusystem_torch.depends import Provider, inject


class Subscriber:
    """Holds topic -> handler-list routing with DI-injected handlers."""

    def __init__(
        self,
        name: str | None = None,
        *,
        provider: Provider | None = None,
    ) -> None:
        self.name = name
        self.provider = provider or Provider()
        self.handlers: dict[str, list[Callable[..., None]]] = {}

    @property
    def dependency_overrides(self) -> dict:
        return self.provider.dependency_overrides

    def register(self, topic: str, wrapped: Callable[..., None]) -> None:
        """Attach an injected handler to a topic."""
        self.handlers.setdefault(topic, []).append(inject(self.provider)(wrapped))

    def subscribe(self, *topics: str) -> Callable[[Callable], Callable]:
        """Decorator registering a handler on one or more topics."""
        def decorator(wrapped: Callable[..., None]) -> Callable[..., None]:
            for topic in topics:
                self.register(topic, wrapped)
            return wrapped
        return decorator

    def receive(self, message: Any, topic: str) -> None:
        """Run every handler subscribed to ``topic`` with ``message``."""
        for handler in self.handlers.get(topic, []):
            handler(message)


class Publisher:
    """Delivers (message, topic) to every registered subscriber."""

    def __init__(self) -> None:
        self.subscribers: list[Subscriber] = []

    def register(self, *subscribers: Subscriber) -> None:
        self.subscribers.extend(subscribers)

    def publish(self, message: Any, topic: str) -> None:
        """Route to subscribers; handler exceptions propagate to the caller
        (early-stop signal path)."""
        for subscriber in self.subscribers:
            subscriber.receive(message, topic)
