"""Multi-tenant gang orchestration on one physical mesh: the port of
:mod:`tpusystem.orchestrator`, copied (host logic: a :class:`Submesh` is a
tuple of device indices, and runners are anything with ``poll`` and
``resize``).

One device pool, N jobs (train, serve fleet, recsys, periodic eval) as
isolated tenants — each under its own supervisor tree and control-plane
namespace, with journaled preemptive capacity arbitration between them
and a seeded cross-tenant chaos certifier over the lot. See
the reference's ROADMAP item 4 and docs/api/.

Layout mirrors the serve package's split:

* :mod:`~tpusystem_torch.orchestrator.namespace` — blast-radius isolation:
  scoped consumers, tenant buses, leak audits, namespaced TB writers.
* :mod:`~tpusystem_torch.orchestrator.gang` — specs, the carve planner, the
  :class:`Orchestrator` with two-phase journaled arbitration and
  SIGKILL recovery, the :class:`SupervisedRunner` adapter.
* :mod:`~tpusystem_torch.orchestrator.journal` — the RouterJournal discipline
  under the ``orch:{name}`` identity namespace.
* :mod:`~tpusystem_torch.orchestrator.certify` — the fleet-of-jobs chaos
  drill (seeded tenant × component × kill-tick).
"""

from tpusystem_torch.orchestrator.certify import (TenantCertifyReport,
                                                  TenantHarness,
                                                  certify_tenants)
from tpusystem_torch.orchestrator.gang import (CapacityError, JobSpec,
                                               Orchestrator, Submesh,
                                               SupervisedRunner, Tenant, carve,
                                               halt_reason)
from tpusystem_torch.orchestrator.journal import (OrchestratorJournal,
                                                  orchestrator_identity,
                                                  recover_orchestrator_journal)
from tpusystem_torch.orchestrator.namespace import (LeakAudit,
                                                    NamespacedWriter,
                                                    ScopedConsumer, TenantBus,
                                                    scoped, subject_of)

__all__ = [
    'CapacityError', 'JobSpec', 'Submesh', 'carve', 'Tenant',
    'Orchestrator', 'SupervisedRunner', 'halt_reason',
    'OrchestratorJournal', 'orchestrator_identity',
    'recover_orchestrator_journal',
    'ScopedConsumer', 'scoped', 'subject_of', 'TenantBus', 'LeakAudit',
    'NamespacedWriter',
    'TenantHarness', 'TenantCertifyReport', 'certify_tenants',
]
