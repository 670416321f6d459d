"""The orchestrator's crash journal: RouterJournal discipline, new
identity namespace.

The gang orchestrator makes placement and arbitration *decisions* —
which tenant owns which devices, who is mid-shrink, what capacity debt
is owed back on ebb. Losing those to an orchestrator SIGKILL and
re-deciding them from scratch is exactly the double-resize hazard the
Router's journal was built to prevent for handoffs, so the orchestrator
rides the same machinery verbatim: digest-framed pickle (a torn copy
reads as :exc:`~tpusystem_torch.serve.failover.JournalCorrupt`, i.e. absent),
a journal-owned monotonic tick, term-fenced store steps
(``term * 1_000_000 + tick`` — a deposed orchestrator's late pushes can
never overwrite its successor's), cadence-gated replication with
log-once degrade. Only the *identity namespace* is new:
``orch:{name}`` beside ``router:{name}`` and ``journal:{identity}``,
so the three planes never collide in one memstore.

Arbitration writes are journaled **two-phase**: the orchestrator
replicates a ``phase='decided'`` record *before* executing a resize and
a ``phase='done'`` record after — so recovery finds either a completed
decision to re-apply idempotently or an in-flight one to *finish*,
never a blank that would tempt it to re-decide (see
:meth:`tpusystem_torch.orchestrator.gang.Orchestrator.recover`).
"""

from __future__ import annotations

from typing import Any

from tpusystem_torch.serve.failover import (JournalCorrupt, RouterJournal,
                                            recover_router_journal)

__all__ = ['orchestrator_identity', 'OrchestratorJournal',
           'recover_orchestrator_journal', 'JournalCorrupt']


def orchestrator_identity(name: str = 'orchestrator') -> str:
    """The memstore identity an orchestrator's journal travels under —
    its own namespace (``orch:{name}``) beside ``router:{name}`` and
    ``journal:{identity}``, riding the identical push/replicate/buddy
    machinery."""
    return f'orch:{name}'


class OrchestratorJournal(RouterJournal):
    """:class:`~tpusystem_torch.serve.failover.RouterJournal` under the
    orchestrator's identity namespace. The schema is the orchestrator's
    business (:meth:`tpusystem_torch.orchestrator.gang.Orchestrator.snapshot`
    builds the state dict); this class inherits the framing, tick, term
    fencing, and degrade disciplines unchanged."""

    def __init__(self, name: str = 'orchestrator', *, client: Any = None,
                 cadence: int = 1) -> None:
        super().__init__(name, client=client, cadence=cadence)
        self.identity = orchestrator_identity(name)


def recover_orchestrator_journal(name: str,
                                 clients: Any) -> tuple[int, dict] | None:
    """Fetch and verify the newest orchestrator journal for ``name``
    from the first client with an intact copy — ``clients`` in
    preference order, :func:`~tpusystem_torch.serve.failover.recover_journal`'s
    contract: a corrupt copy logs and falls through, never restores."""

    class _Scoped:
        """Adapter presenting ``router_identity``-keyed fetches under
        the orchestrator namespace, so the recover loop is reused
        byte-for-byte."""

        def __init__(self, client: Any) -> None:
            self.client = client

        def fetch(self, identity: str) -> Any:
            name_part = identity.split(':', 1)[1]
            return self.client.fetch(orchestrator_identity(name_part))

    return recover_router_journal(
        name, [None if client is None else _Scoped(client)
               for client in clients])
