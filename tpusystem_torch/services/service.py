"""Named command handlers (the service layer entry point): the port of
:mod:`tpusystem.services.service`.

A ``Service`` registers stateless domain operations under names generated
from the handler function's name (default: snake_case -> kebab-case) and
executes them by name — CQS-style dispatch usable from code, a CLI, or a
REST surface. Handlers are DI-injected so runtime facts (the device,
data loaders, metric stores) bind late and swap cleanly in tests.

Reference parity: ``torchsystem/services/service.py:70-153`` — kebab name
generation, handlers remain directly callable after registration, ``handle``
raises ``KeyError`` for unknown actions.
"""

from __future__ import annotations

from collections.abc import Callable
from re import sub
from typing import Any

from tpusystem_torch.depends import Depends as Depends
from tpusystem_torch.depends import Provider, inject


class Service:
    """Registry of injected command handlers addressable by generated name."""

    def __init__(
        self,
        name: str | None = None,
        *,
        provider: Provider | None = None,
        generator: Callable[[str], str] = lambda name: sub(r'_', '-', name),
    ) -> None:
        self.name = name
        self.handlers: dict[str, Callable[..., Any]] = {}
        self.generator = generator
        self.provider = provider or Provider()

    @property
    def dependency_overrides(self) -> dict:
        """Late-binding override table (see :class:`tpusystem_torch.depends.Provider`)."""
        return self.provider.dependency_overrides

    def handler(self, wrapped: Callable[..., Any]) -> Callable[..., Any]:
        """Register ``wrapped`` under ``generator(wrapped.__name__)``.

        The returned callable is the injected version and is also usable
        directly (``train(model, loader)`` keeps working).
        """
        injected = inject(self.provider)(wrapped)
        self.handlers[self.generator(wrapped.__name__)] = injected
        return injected

    def handle(self, action: str, *arguments: Any) -> Any:
        """Invoke the handler registered under ``action``.

        Raises:
            KeyError: when no handler exists for the action.
        """
        handler = self.handlers.get(action)
        if not handler:
            raise KeyError(f'Handler not found for action: {action}')
        return handler(*arguments)
