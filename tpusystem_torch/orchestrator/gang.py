"""Gang-scheduling N jobs on one physical mesh, as isolated tenants.

The subsystems this repo has grown — supervised training, the serving
fleet, recsys, periodic eval — each assume they own the whole mesh. The
:class:`Orchestrator` removes that assumption: it carves one device set
into virtual submeshes (:func:`carve`), runs each job as a
:class:`Tenant` behind its own runner (its supervisor tree — the full
42/43/44/45/46/47/1 exit contract of :mod:`tpusystem_torch.parallel.
recovery`), and arbitrates capacity between them. Three disciplines
carry the robustness story:

* **Blast radius** — a tenant that exits outside
  :data:`~tpusystem_torch.parallel.recovery.RESTART_EXITS` (a 44 divergence,
  a 45 crash-loop, a 47 fencing, a plain 1) is *halted*: its devices
  return to the free pool, a typed ``JobHalted`` narrates the verdict,
  and nothing else happens — the other tenants' runners, buses
  (:mod:`tpusystem_torch.orchestrator.namespace`), and device sets are never
  touched. Restartable exits (42/43/46) are the supervisor tree's
  business; the orchestrator deliberately does not react to them.
* **Preemptive arbitration** — :meth:`Orchestrator.request_capacity`
  fills a burst from the free pool first, then shrinks the
  lowest-priority *elastic* tenant through its runner's resize seam
  (the ``Supervisor.resize()`` / exit-46 path — the shrunk trainer
  resumes token-exact from hot shards and the move is reversible:
  :meth:`release_capacity` pays the recorded debt back on ebb, "never
  leave a chip idle" in both directions). Every decision is journaled
  **two-phase** (``decided`` before any resize executes, ``done``
  after) under the RouterJournal discipline
  (:mod:`tpusystem_torch.orchestrator.journal`), so an orchestrator SIGKILL
  mid-arbitration recovers placements, priorities, debts, AND the
  in-flight resize — and *finishes* it instead of re-deciding.
* **Certification** — :mod:`tpusystem_torch.orchestrator.certify` drills the
  whole story under seeded chaos: kill one (tenant × component ×
  kill-tick) draw, assert every other tenant's outputs are bitwise
  undisturbed.

Priority convention: **larger ``priority`` wins capacity**. The donor
search walks running elastic tenants from the smallest priority up and
never shrinks a tenant to satisfy an equal-or-lower-priority requester.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

from tpusystem_torch.parallel.recovery import (CRASH_LOOP_EXIT,
                                               DIVERGED_EXIT, RESTART_EXITS,
                                               ROUTER_FENCED_EXIT)
from tpusystem_torch.orchestrator.journal import (OrchestratorJournal,
                                                  recover_orchestrator_journal)
from tpusystem_torch.orchestrator.namespace import TenantBus

logger = logging.getLogger('tpusystem_torch.orchestrator')

__all__ = ['CapacityError', 'JobSpec', 'Submesh', 'carve', 'Tenant',
           'Orchestrator', 'SupervisedRunner', 'halt_reason']

# the typed vocabulary JobHalted speaks — the non-restartable half of
# the exit table (docs/multihost.md#restart-exit-code-table)
_HALT_REASONS = {DIVERGED_EXIT: 'diverged', CRASH_LOOP_EXIT: 'crash-loop',
                 ROUTER_FENCED_EXIT: 'fenced', 1: 'failure'}


def halt_reason(code: int) -> str:
    """The typed verdict for a non-restartable exit code."""
    return _HALT_REASONS.get(code, f'exit-{code}')


class CapacityError(RuntimeError):
    """The mesh cannot satisfy a placement or arbitration request —
    typed so callers degrade (queue the job, refuse the burst) instead
    of crashing the orchestrator."""


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant's contract with the orchestrator.

    ``chips`` is the preferred submesh size; ``min_chips`` the floor an
    arbitration shrink may take it to. A spec with ``min_chips <
    chips`` is *elastic* — eligible as an arbitration donor (its runner
    must honor ``resize``); ``min_chips == chips`` pins the job.
    ``priority``: larger wins capacity (a burst never shrinks an
    equal-or-higher-priority tenant).
    """

    name: str
    kind: str                     # 'train' | 'serve' | 'recsys' | 'eval'...
    priority: int
    chips: int
    min_chips: int = 0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError('a job needs a non-empty name')
        if self.chips < 1:
            raise ValueError(f'job {self.name!r} needs chips >= 1, got '
                             f'{self.chips}')
        min_chips = self.min_chips or self.chips
        if not 1 <= min_chips <= self.chips:
            raise ValueError(
                f'job {self.name!r} needs 1 <= min_chips <= chips, got '
                f'min_chips={self.min_chips} chips={self.chips}')
        object.__setattr__(self, 'min_chips', min_chips)

    @property
    def elastic(self) -> bool:
        return self.min_chips < self.chips


@dataclasses.dataclass(frozen=True)
class Submesh:
    """A virtual slice of the physical mesh: an ordered tuple of device
    ids (opaque to the orchestrator — ranks, CUDA device indices, host
    names). Contiguity is :func:`carve`'s policy, not a field."""

    devices: tuple

    def __post_init__(self) -> None:
        object.__setattr__(self, 'devices', tuple(self.devices))
        if len(set(self.devices)) != len(self.devices):
            raise ValueError(f'submesh has duplicate devices: '
                             f'{self.devices}')

    def __len__(self) -> int:
        return len(self.devices)


def carve(capacity: Any, specs: list[JobSpec]) -> dict[str, Submesh]:
    """Carve a device list into contiguous submeshes, one per spec, in
    priority order (highest first — ties keep submission order, so the
    placement is deterministic for a given spec list). Raises
    :exc:`CapacityError` when the specs oversubscribe ``capacity``;
    whatever is left stays in the orchestrator's free pool."""
    devices = list(capacity)
    if len(set(devices)) != len(devices):
        raise ValueError(f'capacity has duplicate devices: {devices}')
    names = [spec.name for spec in specs]
    if len(set(names)) != len(names):
        raise ValueError(f'duplicate job names: {names}')
    wanted = sum(spec.chips for spec in specs)
    if wanted > len(devices):
        raise CapacityError(
            f'{wanted} chips requested across {len(specs)} jobs but the '
            f'mesh has {len(devices)} — trim specs or shrink chips toward '
            f'min_chips')
    placements: dict[str, Submesh] = {}
    cursor = 0
    for spec in sorted(specs, key=lambda spec: -spec.priority):
        placements[spec.name] = Submesh(
            tuple(devices[cursor:cursor + spec.chips]))
        cursor += spec.chips
    return placements


@dataclasses.dataclass
class Tenant:
    """One admitted job at runtime: its spec, its current submesh, the
    runner driving its supervisor tree, its scoped bus, and the
    orchestrator's view of its lifecycle (``running`` → ``done`` |
    ``halted``)."""

    spec: JobSpec
    submesh: Submesh
    runner: Any
    bus: TenantBus | None = None
    state: str = 'running'
    exit_code: int | None = None

    @property
    def name(self) -> str:
        return self.spec.name


class Orchestrator:
    """The gang orchestrator: one device pool, N isolated tenants,
    journaled capacity arbitration.

    Runners are anything with the two-method seam the drills and the
    :class:`SupervisedRunner` adapter implement:

    * ``poll() -> int | None`` — the job's final exit code, or None
      while it runs. Restartable codes (42/43/46) are invisible here by
      design: the tenant's own supervisor tree absorbs them and
      ``poll`` keeps returning None until the tree gives a *final*
      verdict.
    * ``resize(devices: tuple) -> None`` — re-gang onto a new submesh
      (only called on elastic tenants; the exit-46 path).

    ``client`` is the memstore plane the journal replicates to (a
    :class:`~tpusystem_torch.checkpoint.memstore.MemStore` in drills, a
    MemStoreClient on a pod, None to journal nothing). One orchestrator
    instance is single-threaded by contract — its lock only guards the
    arbitration critical section against runner callbacks.
    """

    def __init__(self, capacity: Any, *, name: str = 'orchestrator',
                 client: Any = None, cadence: int = 1,
                 producer: Any = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        devices = tuple(capacity)
        if len(set(devices)) != len(devices):
            raise ValueError(f'capacity has duplicate devices: {devices}')
        self.name = name
        self.capacity = devices
        self.free: list = list(devices)
        self.tenants: dict[str, Tenant] = {}
        self.producer = producer
        self.journal = OrchestratorJournal(name, client=client,
                                           cadence=cadence)
        self.clock = clock
        self.seq = 0                  # arbitration sequence number
        self.debts: list[dict] = []   # grow-back ledger, LIFO on release
        self.inflight: dict | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------- admission

    def admit(self, spec: JobSpec, runner: Any,
              submesh: Submesh | None = None) -> Tenant:
        """Admit one job: take its chips from the free pool (or seat it
        on an explicit ``submesh`` — the :func:`carve` path), wire its
        :class:`~tpusystem_torch.orchestrator.namespace.TenantBus`, narrate
        ``JobAdmitted``."""
        if spec.name in self.tenants:
            raise ValueError(f'job {spec.name!r} is already admitted')
        if submesh is None:
            if spec.chips > len(self.free):
                raise CapacityError(
                    f'job {spec.name!r} wants {spec.chips} chips but only '
                    f'{len(self.free)} are free')
            submesh = Submesh(tuple(self.free[:spec.chips]))
        missing = [device for device in submesh.devices
                   if device not in self.free]
        if missing:
            raise CapacityError(
                f'job {spec.name!r} asked for devices not in the free '
                f'pool: {missing}')
        self.free = [device for device in self.free
                     if device not in set(submesh.devices)]
        bus = (TenantBus(self.producer, spec.name)
               if self.producer is not None else None)
        tenant = Tenant(spec, submesh, runner, bus=bus)
        self.tenants[spec.name] = tenant
        self._checkpoint()
        self._narrate_admitted(tenant)
        return tenant

    def _narrate_admitted(self, tenant: Tenant) -> None:
        if self.producer is None:
            return
        from tpusystem_torch.observe.events import JobAdmitted
        self.producer.dispatch(JobAdmitted(
            job=tenant.name, kind=tenant.spec.kind,
            priority=tenant.spec.priority, chips=len(tenant.submesh)))

    # ------------------------------------------------------- lifecycle

    def step(self) -> list[Tenant]:
        """Poll every running tenant once; returns the tenants whose
        lifecycle changed this step. Exit contract: ``0`` retires the
        tenant (``done``, devices freed); a code in
        :data:`~tpusystem_torch.parallel.recovery.RESTART_EXITS` is the
        supervisor tree's business (still ``running``); anything else
        halts ONLY that tenant — devices freed, typed ``JobHalted``,
        every other tenant untouched (the blast-radius contract the
        certifier drills bitwise)."""
        changed = []
        for tenant in list(self.tenants.values()):
            if tenant.state != 'running':
                continue
            code = tenant.runner.poll()
            if code is None or code in RESTART_EXITS:
                continue
            tenant.exit_code = code
            tenant.state = 'done' if code == 0 else 'halted'
            self.free.extend(tenant.submesh.devices)
            tenant.submesh = Submesh(())
            changed.append(tenant)
            if tenant.state == 'halted':
                reason = halt_reason(code)
                logger.warning(
                    'tenant %r halted (%s, exit %d); its devices return '
                    'to the pool and no other tenant is touched',
                    tenant.name, reason, code)
                if self.producer is not None:
                    from tpusystem_torch.observe.events import JobHalted
                    self.producer.dispatch(JobHalted(
                        job=tenant.name, code=code, reason=reason))
        if changed:
            self._checkpoint()
        self.journal.observe_tick(self.snapshot)
        return changed

    # ----------------------------------------------------- arbitration

    def request_capacity(self, requester: str, chips: int = 1) -> tuple:
        """Grant ``chips`` more devices to ``requester``: free pool
        first, then shrink the lowest-priority elastic tenant below the
        requester through its resize seam. Returns the granted device
        tuple; raises :exc:`CapacityError` when no donor can cover the
        remainder (the caller's burst is refused typed, never partially
        applied).

        The decision is journaled ``phase='decided'`` BEFORE any resize
        executes and ``phase='done'`` after both sides re-gang — the
        recovery contract (:meth:`recover`) that makes a SIGKILL
        mid-arbitration finish the move instead of re-deciding it."""
        with self._lock:
            started = self.clock()
            tenant = self._running(requester)
            if chips < 1:
                raise ValueError(f'request_capacity needs chips >= 1, '
                                 f'got {chips}')
            taken_free = tuple(self.free[:chips])
            donor, donor_devices = None, ()
            if len(taken_free) < chips:
                need = chips - len(taken_free)
                donor = self._donor(tenant, need)
                donor_devices = donor.submesh.devices[-need:]
            decision = {
                'seq': self.seq, 'kind': 'grant', 'requester': requester,
                'donor': donor.name if donor is not None else None,
                'devices': taken_free + tuple(donor_devices),
                'donor_devices': tuple(donor_devices),
                'donor_after': tuple(
                    device for device in (donor.submesh.devices
                                          if donor is not None else ())
                    if device not in set(donor_devices)),
                'requester_after': (tenant.submesh.devices + taken_free
                                    + tuple(donor_devices)),
            }
            self.seq += 1
            self.inflight = decision
            self._checkpoint(flush=True)      # 'decided' hits the plane
            self._execute(decision)
            granted = decision['devices']
            seconds = self.clock() - started
            self._narrate_arbitrated(decision, seconds)
            return granted

    def release_capacity(self, requester: str) -> int:
        """The ebb: pay ``requester``'s most recent capacity debt back
        to its donor (LIFO — the reverse order the bursts arrived in).
        Returns the number of devices returned (0 = no debt). The
        grow-back is journaled two-phase exactly like the grant."""
        with self._lock:
            started = self.clock()
            for index in range(len(self.debts) - 1, -1, -1):
                debt = self.debts[index]
                if debt['from'] == requester:
                    break
            else:
                return 0
            tenant = self._running(requester)
            donor = self.tenants.get(debt['to'])
            devices = tuple(debt['devices'])
            decision = {
                'seq': self.seq, 'kind': 'release', 'requester': requester,
                'donor': debt['to'], 'devices': devices,
                'donor_after': ((donor.submesh.devices + devices)
                                if donor is not None
                                and donor.state == 'running' else ()),
                'requester_after': tuple(
                    device for device in tenant.submesh.devices
                    if device not in set(devices)),
                'debt_index': index,
            }
            self.seq += 1
            self.inflight = decision
            self._checkpoint(flush=True)
            self._execute(decision)
            seconds = self.clock() - started
            self._narrate_arbitrated(decision, seconds)
            return len(devices)

    def _running(self, name: str) -> Tenant:
        tenant = self.tenants.get(name)
        if tenant is None or tenant.state != 'running':
            raise CapacityError(
                f'job {name!r} is not a running tenant '
                f'({"unknown" if tenant is None else tenant.state})')
        return tenant

    def _donor(self, requester: Tenant, chips: int) -> Tenant:
        """The lowest-priority running elastic tenant strictly below
        the requester with ``chips`` of headroom above its floor."""
        candidates = sorted(
            (tenant for tenant in self.tenants.values()
             if tenant.state == 'running'
             and tenant.spec.elastic
             and tenant.spec.priority < requester.spec.priority
             and len(tenant.submesh) - chips >= tenant.spec.min_chips),
            key=lambda tenant: tenant.spec.priority)
        if not candidates:
            raise CapacityError(
                f'no donor for {chips} more chip(s): free pool is empty '
                f'and no lower-priority elastic tenant has headroom '
                f'above its min_chips floor')
        return candidates[0]

    def _execute(self, decision: dict) -> None:
        """Apply a journaled decision: resize the donor down (or up, on
        a release — the exit-46 path either way), move the devices,
        resize the requester, journal ``done``. Also the recovery
        re-entry point: :meth:`recover` calls it verbatim for an
        in-flight ``decided`` record, which is why it reads every fact
        from the decision instead of re-deriving any."""
        devices = set(decision['devices'])
        donor = (self.tenants.get(decision['donor'])
                 if decision['donor'] else None)
        tenant = self.tenants.get(decision['requester'])
        if donor is not None and donor.state == 'running':
            donor.submesh = Submesh(tuple(decision['donor_after']))
            donor.runner.resize(donor.submesh.devices)
            if self.producer is not None and decision['kind'] == 'grant':
                from tpusystem_torch.observe.events import JobPreempted
                self.producer.dispatch(JobPreempted(
                    job=donor.name,
                    chips=len(decision.get('donor_devices',
                                           decision['devices'])),
                    to=decision['requester']))
        self.free = [device for device in self.free
                     if device not in devices]
        if decision['kind'] == 'release':
            # devices leave the requester; a dead donor's share goes
            # back to the pool instead of vanishing
            if donor is None or donor.state != 'running':
                self.free.extend(decision['devices'])
            index = decision.get('debt_index')
            if index is not None and index < len(self.debts):
                del self.debts[index]
        else:
            if decision['donor']:
                self.debts.append({
                    'from': decision['requester'],
                    'to': decision['donor'],
                    'devices': tuple(decision.get(
                        'donor_devices', decision['devices']))})
        if tenant is not None and tenant.state == 'running':
            tenant.submesh = Submesh(tuple(decision['requester_after']))
            resize = getattr(tenant.runner, 'resize', None)
            if resize is not None:
                resize(tenant.submesh.devices)
        self.inflight = None
        self._checkpoint(flush=True)          # 'done' hits the plane

    def _narrate_arbitrated(self, decision: dict, seconds: float) -> None:
        if self.producer is None:
            return
        from tpusystem_torch.observe.events import CapacityArbitrated
        self.producer.dispatch(CapacityArbitrated(
            kind=decision['kind'], requester=decision['requester'],
            donor=decision['donor'], chips=len(decision['devices']),
            seconds=seconds))

    # the AutoscalePolicy seam: a Router wired with these callables
    # bursts through the orchestrator instead of assuming spare chips
    def capacity_hooks(self, job: str, *, chips: int = 1
                       ) -> tuple[Callable, Callable]:
        """``(provision, release)`` closures for
        :class:`~tpusystem_torch.serve.fleet.AutoscalePolicy` wiring: the
        fleet's grow verdict becomes :meth:`request_capacity`, its
        shrink verdict :meth:`release_capacity`."""

        def provision(**_ignored: Any) -> tuple:
            return self.request_capacity(job, chips)

        def release(**_ignored: Any) -> int:
            return self.release_capacity(job)

        return provision, release

    # ----------------------------------------------------- persistence

    def snapshot(self) -> dict:
        """The journal payload: pure-host state, everything a fresh
        orchestrator needs to take over without re-deciding anything."""
        return {
            'capacity': self.capacity,
            'free': tuple(self.free),
            'placements': {name: tenant.submesh.devices
                           for name, tenant in self.tenants.items()},
            'specs': {name: dataclasses.asdict(tenant.spec)
                      for name, tenant in self.tenants.items()},
            'states': {name: (tenant.state, tenant.exit_code)
                       for name, tenant in self.tenants.items()},
            'debts': [dict(debt) for debt in self.debts],
            'inflight': dict(self.inflight) if self.inflight else None,
            'seq': self.seq,
            'term': self.journal.term,
        }

    def _checkpoint(self, flush: bool = False) -> None:
        if self.journal.client is None:
            return
        if flush:
            self.journal.tick += 1
            self.journal.replicate(self.snapshot())
        else:
            self.journal.observe_tick(self.snapshot)

    def recover(self, clients: Any, runners: dict[str, Any]) -> bool:
        """Rebuild this (fresh, empty) orchestrator from the newest
        intact journal on ``clients`` — placements, priorities, debts,
        sequence — under a bumped term so the predecessor's late pushes
        are fenced. ``runners`` re-attaches each surviving tenant by
        name (a name with no runner recovers as state-only — pollable
        never, resizable never — which is still enough to finish an
        in-flight decision's bookkeeping).

        An in-flight ``decided`` record is *completed* via the same
        :meth:`_execute` path the live orchestrator runs — the recorded
        plan, not a fresh decision — closing the SIGKILL-mid-arbitration
        window. Returns True when a journal was recovered."""
        if self.tenants:
            raise RuntimeError('recover() needs a fresh orchestrator — '
                               'this one already has tenants')
        recovered = recover_orchestrator_journal(self.name, clients)
        if recovered is None:
            return False
        tick, state = recovered
        self.journal.tick = tick
        self.journal.term = int(state.get('term', 0)) + 1
        self.capacity = tuple(state['capacity'])
        self.free = list(state['free'])
        self.seq = int(state['seq'])
        self.debts = [dict(debt) for debt in state.get('debts', [])]
        for name, spec_fields in state['specs'].items():
            spec = JobSpec(**spec_fields)
            tenant_state, exit_code = state['states'][name]
            tenant = Tenant(
                spec, Submesh(tuple(state['placements'][name])),
                runners.get(name, _StateOnlyRunner()),
                bus=(TenantBus(self.producer, name)
                     if self.producer is not None else None),
                state=tenant_state, exit_code=exit_code)
            self.tenants[name] = tenant
        inflight = state.get('inflight')
        if inflight is not None:
            logger.warning(
                'orchestrator %r recovered an in-flight %s decision '
                '(seq %d, %s -> %s); completing it from the journal '
                'without re-deciding', self.name, inflight['kind'],
                inflight['seq'], inflight['donor'], inflight['requester'])
            self.inflight = dict(inflight)
            self._execute(self.inflight)
        else:
            self._checkpoint(flush=True)      # stamp the new term
        return True


class _StateOnlyRunner:
    """A recovered tenant whose runner did not survive: pollable
    forever-running, resize is a narrated no-op. Keeps recovery's
    bookkeeping total without inventing a process."""

    def poll(self) -> None:
        return None

    def resize(self, devices: tuple) -> None:
        logger.warning('state-only runner asked to resize to %d '
                       'device(s); re-attach a real runner', len(devices))


class SupervisedRunner:
    """Adapter from the orchestrator's runner seam to one
    :class:`~tpusystem_torch.parallel.Supervisor` tree.

    ``run()`` (blocking — the supervisor's restart loop) is driven on a
    daemon thread; ``poll`` reports its final exit code. ``resize``
    re-gangs the worker through
    :meth:`~tpusystem_torch.parallel.Supervisor.resize` with a fresh
    :class:`~tpusystem_torch.parallel.elastic.ResizeDecision` env — the
    exit-46 path; epochs advance monotonically per runner.
    """

    def __init__(self, supervisor: Any, member: int = 0, *,
                 epoch: int = 0) -> None:
        self.supervisor = supervisor
        self.member = member
        self.epoch = epoch
        self.code: int | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> 'SupervisedRunner':
        def drive() -> None:
            self.code = self.supervisor.run()

        self._thread = threading.Thread(
            target=drive, name=f'orchestrator-runner-{self.member}',
            daemon=True)
        self._thread.start()
        return self

    def poll(self) -> int | None:
        return self.code

    def resize(self, devices: tuple) -> None:
        from tpusystem_torch.parallel.elastic import ResizeDecision
        self.epoch += 1
        decision = ResizeDecision(self.epoch, tuple(devices))
        self.supervisor.resize(env=decision.env(self.member))
