"""Cross-tenant chaos certification: kill one tenant's component, prove
every OTHER tenant never noticed.

:func:`~tpusystem_torch.serve.certify.certify_fleet` certifies one fleet
against an undisturbed twin. This module lifts that drill one level to
the gang orchestrator's headline invariant — **blast radius**:

    for a seeded (tenant × component × kill-tick) draw, every
    *non-victim* tenant's final outputs (losses, token streams) are
    **bitwise-identical** to an undisturbed reference run, no tenant
    hangs, nothing settles twice, and no event crosses a tenant
    namespace; the victim itself either recovers bitwise or degrades
    **typed** (a halt verdict from the exit table, or a
    :data:`~tpusystem_torch.serve.certify._DEGRADED_REASONS`-style reason on
    individual outputs).

All three draws come from one ``random.Random(seed)``
(:func:`~tpusystem_torch.parallel.chaos.pick_tenant_chaos`), so the seed IS
the scenario — tier-1 pins a handful, the dryrun stage adds more, and a
red run replays exactly from the seed in its failure message.

The harness seam (:class:`TenantHarness`) keeps the certifier
environment-agnostic, like :class:`~tpusystem_torch.serve.certify.
FleetHarness` before it: jobs are any drivers with ``step()`` /
``idle`` / ``outputs()``, kills are thunks, and the leak witness is
whatever the harness wires (typically
:class:`~tpusystem_torch.orchestrator.namespace.LeakAudit` rows registered
through each tenant's bus).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from tpusystem_torch.parallel.chaos import TenantChaosPick, pick_tenant_chaos

logger = logging.getLogger('tpusystem_torch.orchestrator.certify')

__all__ = ['TenantHarness', 'TenantCertifyReport', 'certify_tenants']

# victim-output reasons that count as a typed degrade rather than a
# completion — the serve certifier's vocabulary plus the orchestrator's
# halt verdicts (docs/multihost.md#restart-exit-code-table)
_DEGRADED_REASONS = ('expired', 'shed', 'cancelled', 'diverged',
                     'crash-loop', 'fenced', 'failure', 'halted')


@dataclasses.dataclass
class TenantHarness:
    """One certifiable fleet-of-jobs.

    ``jobs`` maps tenant name -> driver. A driver exposes:

    * ``step()`` — advance the job one tick (a training step, a fleet
      router tick, a supervisor poll);
    * ``idle`` — True once the job finished its scripted work;
    * ``outputs() -> dict[key, (reason, tokens)]`` — the job's final
      observable record: losses keyed by step, completions keyed by
      request id — any ``(reason, value-tuple)`` shape, compared
      bitwise against the reference;
    * optionally ``duplicates`` (keys settled more than once) and
      ``verdict`` (the victim's typed terminal verdict, e.g.
      ``'halted'``/``'diverged'``, or None while healthy).

    ``kills`` maps tenant -> {component -> kill thunk}; every tenant
    must wire the SAME component set, so the seeded component draw is
    meaningful whichever tenant is the victim. ``advance`` runs once
    per drain tick (fake clocks breathe without real sleeps);
    ``leaks`` returns the cross-namespace deliveries witnessed so far
    (:class:`~tpusystem_torch.orchestrator.namespace.LeakAudit` rows) —
    MUST stay empty."""

    jobs: dict[str, Any]
    kills: dict[str, dict[str, Callable[[], Any]]]
    advance: Callable[[], None] | None = None
    leaks: Callable[[], list] | None = None


@dataclasses.dataclass
class TenantCertifyReport:
    """One cross-tenant certification verdict; the seed replays it."""

    seed: int
    tenant: str                      # the victim tenant
    component: str                   # the component killed inside it
    step: int                        # the drain tick it died after
    exact: int                       # non-victim outputs bitwise-equal
    victim_exact: bool               # victim recovered bitwise
    victim_verdict: Any              # or its typed degrade verdict
    degraded: list                   # victim keys that failed typed
    mismatches: list                 # (tenant, key, why) — MUST be empty
    duplicates: list                 # (tenant, key) settled twice
    hung: list                       # tenants never idle in max_steps
    leaked: list                     # cross-namespace deliveries

    @property
    def ok(self) -> bool:
        victim_ok = self.victim_exact or self.victim_verdict is not None
        return victim_ok and not (self.mismatches or self.duplicates
                                  or self.hung or self.leaked)

    def summary(self) -> str:
        verdict = 'PASS' if self.ok else 'FAIL'
        victim = ('bitwise' if self.victim_exact
                  else f'degraded:{self.victim_verdict}')
        return (f'[{verdict}] seed={self.seed} '
                f'kill={self.tenant}/{self.component}@tick{self.step}: '
                f'{self.exact} non-victim outputs exact, victim {victim} '
                f'({len(self.degraded)} typed-degraded keys), '
                f'{len(self.mismatches)} mismatched, '
                f'{len(self.duplicates)} duplicated, '
                f'{len(self.hung)} hung, {len(self.leaked)} leaked')


def _drain(harness: TenantHarness, pick: TenantChaosPick | None,
           max_steps: int) -> dict:
    """Round-robin every job to idle, firing the pick's kill after its
    tick. The tick is the *drain loop's* (one pass over all jobs), so
    the kill lands at the same global moment whichever tenant it hits."""
    fired = pick is None
    ticks = 0
    for _ in range(max_steps):
        busy = [name for name, job in harness.jobs.items() if not job.idle]
        if not busy and fired:
            break
        for name in busy:
            harness.jobs[name].step()
        ticks += 1
        if not fired and ticks >= pick.step:
            fired = True
            logger.info('chaos: killing %r inside tenant %r after tick %d',
                        pick.component, pick.tenant, ticks)
            harness.kills[pick.tenant][pick.component]()
        if harness.advance is not None:
            harness.advance()
    hung = sorted(name for name, job in harness.jobs.items()
                  if not job.idle)
    outputs = {name: dict(job.outputs())
               for name, job in harness.jobs.items()}
    duplicates = sorted(
        (name, key) for name, job in harness.jobs.items()
        for key in getattr(job, 'duplicates', ()) or ())
    verdicts = {name: getattr(job, 'verdict', None)
                for name, job in harness.jobs.items()}
    leaked = list(harness.leaks()) if harness.leaks is not None else []
    return dict(outputs=outputs, hung=hung, duplicates=duplicates,
                verdicts=verdicts, leaked=leaked)


def certify_tenants(build: Callable[[], TenantHarness], *, seed: int,
                    components: tuple[str, ...] | None = None,
                    lo: int = 1, hi: int = 8,
                    max_steps: int = 10_000) -> TenantCertifyReport:
    """Certify one seeded cross-tenant chaos scenario against an
    undisturbed twin.

    ``build()`` constructs a fresh :class:`TenantHarness` — called
    twice, once for the reference (never killed; it MUST drain clean or
    the harness itself is broken) and once for chaos, so the two runs
    start bit-identical. The victim draw is
    :func:`~tpusystem_torch.parallel.chaos.pick_tenant_chaos` over the
    harness's tenant names (sorted) and the shared component set;
    ``lo >= 1`` keeps the kill after every job has started. Returns a
    :class:`TenantCertifyReport`; red runs replay from ``seed`` alone.
    """
    if lo < 1:
        raise ValueError('lo must be >= 1: the kill lands after every '
                         'tenant has taken its first step, or start-up '
                         'itself races the chaos')
    reference = _drain(build(), None, max_steps)
    if reference['hung']:
        raise RuntimeError(
            f'the UNDISTURBED reference run never drained '
            f'({reference["hung"]}) — fix the harness before certifying '
            f'chaos against it')
    harness = build()
    tenants = tuple(sorted(harness.jobs))
    if sorted(harness.kills) != list(tenants):
        raise ValueError(
            f'kills must cover every tenant: jobs {list(tenants)} vs '
            f'kills {sorted(harness.kills)}')
    shared = {name: tuple(sorted(kills))
              for name, kills in harness.kills.items()}
    if len(set(shared.values())) != 1:
        raise ValueError(
            f'every tenant must wire the SAME component set so the '
            f'seeded component draw is meaningful for any victim; got '
            f'{shared}')
    available = (tuple(components) if components
                 else next(iter(shared.values())))
    missing = [name for name in available
               if name not in next(iter(shared.values()))]
    if missing:
        raise ValueError(f'harness has no kill thunk for {missing}; '
                         f'wired: {next(iter(shared.values()))}')
    pick = pick_tenant_chaos(seed, tenants, available, lo=lo, hi=hi)
    chaos = _drain(harness, pick, max_steps)

    mismatches: list = []
    degraded: list = []
    victim_missing: list = []
    exact = 0
    victim_exact = True
    victim_verdict = chaos['verdicts'].get(pick.tenant)
    for name in tenants:
        expected = reference['outputs'].get(name, {})
        observed = chaos['outputs'].get(name, {})
        victim = name == pick.tenant
        if not victim and set(observed) != set(expected):
            extra = sorted(set(observed) - set(expected))
            lost = sorted(set(expected) - set(observed))
            mismatches.append((name, '(keys)',
                               f'non-victim output keys diverged: '
                               f'+{extra} -{lost}'))
        for key, expected_row in expected.items():
            observed_row = observed.get(key)
            if observed_row is None:
                if victim:
                    victim_exact = False
                    victim_missing.append(key)
                else:
                    mismatches.append((name, key, 'missing under chaos'))
                continue
            reason, tokens = observed_row
            expected_reason, expected_tokens = expected_row
            if (reason, tuple(tokens)) == (expected_reason,
                                           tuple(expected_tokens)):
                if not victim:
                    exact += 1
                continue
            if victim:
                victim_exact = False
                if reason in _DEGRADED_REASONS:
                    degraded.append(key)    # a truthful typed downgrade
                else:
                    mismatches.append((name, key,
                                       f'untyped divergence: {reason!r} '
                                       f'vs {expected_reason!r}'))
            else:
                mismatches.append((name, key,
                                   f'non-victim output diverged: '
                                   f'{reason!r} vs {expected_reason!r} '
                                   f'or tokens differ'))
    if victim_missing:
        # a missing output is excused ONLY by the driver's own typed
        # verdict (a halt, a divergence) — never inferred, else a
        # silently dropped result would read as a degrade
        if victim_verdict is not None:
            degraded.extend(victim_missing)
        else:
            mismatches.extend(
                (pick.tenant, key, 'missing without a typed verdict')
                for key in victim_missing)
    if not victim_exact and degraded and victim_verdict is None:
        # per-key typed degrades are themselves a verdict
        victim_verdict = 'degraded'

    report = TenantCertifyReport(
        seed=seed, tenant=pick.tenant, component=pick.component,
        step=pick.step, exact=exact, victim_exact=victim_exact,
        victim_verdict=victim_verdict, degraded=sorted(degraded),
        mismatches=mismatches, duplicates=chaos['duplicates'],
        hung=chaos['hung'], leaked=chaos['leaked'])
    logger.info('%s', report.summary())
    return report
