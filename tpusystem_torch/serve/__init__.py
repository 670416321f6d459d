"""Serving tier of the port: :mod:`tpusystem.serve` on one device.

Layers, bottom up:

* :class:`PagedKVCache` (+ ``adopt_prefill`` / ``write_tables``) — the
  host-side block pool free list, block tables and radix prefix index
  (:mod:`tpusystem_torch.serve.kvcache`);
* :class:`Engine` — the fixed-shape decode step with admit/evict row
  churn, sampled and grammar-masked rows, prefix sharing, speculative rows,
  and the disaggregated pair ``export_prefill`` / ``admit_prefilled``
  (:mod:`tpusystem_torch.serve.engine`);
* :class:`Scheduler` / :class:`Request` — prefill/decode phase packing
  under a token budget, deadlines, shedding and the ``prefill_only`` role
  (:mod:`tpusystem_torch.serve.scheduler`);
* :class:`InferenceService` / :class:`FleetClient` — the command/event bus
  front door (:mod:`tpusystem_torch.serve.service`);
* the failover layer — request journals, token-prefix replay, the step
  watchdog, watermarks and :class:`ServingReplica`
  (:mod:`tpusystem_torch.serve.failover`);
* the fleet — the health-checked :class:`Router` over replicas, with
  retries, hedging, fleet shedding, autoscale, role split and router
  takeover (:mod:`tpusystem_torch.serve.fleet`);
* disaggregated prefill/decode — KV hand-offs over the blob plane
  (:mod:`tpusystem_torch.serve.disagg`);
* :func:`certify_fleet` — seeded fleet chaos certification
  (:mod:`tpusystem_torch.serve.certify`).

The names are the reference's, in its order, but for ``pool_shardings``,
which exists only for meshes (ROADMAP queue 1, 9c. Tensor parallelism).
"""

from tpusystem_torch.serve.certify import (CertifyReport, FleetHarness,
                                           certify_fleet)
from tpusystem_torch.serve.disagg import (HandoffCorrupt, KVHandoff,
                                          KVStripStore, RoleMismatch,
                                          fetch_handoff, kv_namespace,
                                          pack_handoff, unpack_handoff)
from tpusystem_torch.serve.engine import (Admission, Engine, SamplingParams,
                                          Saturated, StepReport,
                                          UnseededSampling,
                                          engine_unsupported_reason,
                                          prefill_bucket)
from tpusystem_torch.serve.failover import (EngineStalled, JournalCorrupt,
                                            ReplayReport, RequestJournal,
                                            RouterJournal, ServingReplica,
                                            StepWatchdog, Watermarks,
                                            journal_identity,
                                            recover_journal,
                                            recover_router_journal, replay,
                                            router_identity)
from tpusystem_torch.serve.fleet import (AutoscalePolicy, FleetSaturated,
                                         FleetTick, NoHealthyReplica,
                                         ReplicaDead, ReplicaHandle,
                                         RoutePolicy, Router, RouterFenced,
                                         RouterLease)
from tpusystem_torch.serve.kvcache import (TRASH_BLOCK, PagedKVCache,
                                           adopt_prefill, write_tables)
from tpusystem_torch.serve.scheduler import (Completion, QueueFull, Request,
                                             Scheduler, Tick, serve_levers)
from tpusystem_torch.serve.service import FleetClient, InferenceService

__all__ = ['Engine', 'Admission', 'StepReport', 'Saturated',
           'SamplingParams', 'UnseededSampling',
           'engine_unsupported_reason', 'prefill_bucket',
           'PagedKVCache', 'TRASH_BLOCK', 'adopt_prefill', 'write_tables',
           'Scheduler', 'Request', 'Completion', 'Tick', 'serve_levers',
           'QueueFull', 'InferenceService', 'FleetClient',
           'EngineStalled', 'JournalCorrupt', 'RequestJournal',
           'ReplayReport', 'ServingReplica', 'StepWatchdog', 'Watermarks',
           'journal_identity', 'recover_journal', 'replay',
           'RouterJournal', 'router_identity', 'recover_router_journal',
           'Router', 'RouterFenced', 'RouterLease',
           'ReplicaHandle', 'RoutePolicy', 'AutoscalePolicy',
           'FleetTick', 'ReplicaDead', 'NoHealthyReplica', 'FleetSaturated',
           'KVHandoff', 'KVStripStore', 'HandoffCorrupt', 'RoleMismatch',
           'kv_namespace', 'pack_handoff', 'unpack_handoff', 'fetch_handoff',
           'CertifyReport', 'FleetHarness', 'certify_fleet']
