"""Randomized fleet chaos certification: the port of
:mod:`tpusystem.serve.certify` (kill anything, lose nothing).

The serving drills each exercise ONE failure mode at a time — a replica
SIGKILL, a wedged step, a torn handoff, a router crash. This module is the closing
argument: :func:`certify_fleet` runs a mixed greedy / seeded-sampled /
streamed workload against a full fleet while killing a **uniformly-chosen
component at a uniformly-chosen tick** (router, warm standby, prefill
replica, decode replica, supervisor plane — whatever the harness wires),
then checks the one invariant every robustness PR has been building
toward:

    every accepted request either completes **bitwise-token-exact**
    against an undisturbed reference fleet, or fails **typed** within
    its own deadline — no hung requests, no duplicate completions, no
    silent drops, and ``trace_count == 1`` on every surviving engine
    (chaos never buys a retrace).

Both draws come from one ``random.Random(seed)``
(:func:`~tpusystem_torch.parallel.chaos.pick_chaos`), so a seed IS the
scenario: tier-1 pins a handful of seeds, the dryrun stage adds more,
and a red run replays exactly from the seed in its failure message —
the :class:`~tpusystem_torch.parallel.chaos.Faults` discipline lifted to the
whole fleet.

The harness seam (:class:`FleetHarness`) keeps the certifier
environment-agnostic: the same protocol certifies scripted fake
replicas on a fake clock (tier-1, zero sleeps) and real engines under
real process kills (the dryrun). ``kills['router']`` is the takeover
thunk — it abandons the incumbent and returns the standby Router that
fenced the lease and :meth:`~tpusystem_torch.serve.fleet.Router.recover`\\ ed
the journal; every other component's thunk returns None and the
incumbent keeps serving around the wound.

The port's engines compile nothing and have no ``trace_count``: the
retrace check reads it only where an engine has one.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from tpusystem_torch.parallel.chaos import ChaosPick, pick_chaos
from tpusystem_torch.serve.engine import Saturated, UnseededSampling
from tpusystem_torch.serve.fleet import FleetSaturated, NoHealthyReplica, Router
from tpusystem_torch.serve.scheduler import QueueFull

logger = logging.getLogger('tpusystem_torch.serve.certify')

__all__ = ['CertifyReport', 'FleetHarness', 'certify_fleet']

# the front door's typed refusals: a request turned away HERE was never
# accepted, so the completion invariant does not apply to it — but the
# refusal set itself must match the reference run (submission happens
# before the kill tick, against identical fleet state)
_TYPED_REFUSALS = (FleetSaturated, NoHealthyReplica, QueueFull, Saturated,
                   UnseededSampling)

# terminal reasons that are a typed degrade rather than a normal
# completion: a chaos run may downgrade a request to one of these (its
# deadline expired while the fleet healed, the brownout shed it, a
# client cancelled) without violating certification — the caller got a
# truthful typed verdict, not silence and not a wrong answer
_DEGRADED_REASONS = ('expired', 'shed', 'cancelled')


@dataclasses.dataclass
class FleetHarness:
    """One certifiable fleet: the router, the workload, and the kills.

    ``workload`` is a list of fresh :class:`~tpusystem_torch.serve.Request`
    objects (mixed greedy / seeded-sampled; ids must be stable across
    :func:`certify_fleet`'s two builds — the reference run matches by
    id). ``kills`` maps component name -> kill thunk; the ``'router'``
    thunk performs the takeover (fence the lease, build the standby,
    :meth:`~tpusystem_torch.serve.fleet.Router.recover`) and returns the
    successor ``Router`` — or ``(Router, takeover_report)`` to surface
    the recovery counts in the :class:`CertifyReport` — while every
    other thunk (kill a replica handle, wedge the journal plane, no-op
    the standby) returns None. ``advance`` runs once per drain tick
    (advance a fake clock so leases, deadlines and heartbeats breathe
    without real sleeps)."""

    router: Router
    workload: list
    kills: dict[str, Callable[[], Any]]
    advance: Callable[[], None] | None = None


@dataclasses.dataclass
class CertifyReport:
    """One certification verdict — everything needed to replay a red
    run is in the first two fields (the seed is the scenario)."""

    seed: int
    component: str                   # the victim pick_chaos chose
    step: int                        # the router tick it died after
    accepted: int                    # requests past the front door
    refused: dict                    # id -> typed refusal class name
    completed: int                   # bitwise-exact vs the reference
    degraded: list                   # ids that failed typed (allowed)
    takeover: dict | None            # RouterTakeover counts, router kills
    mismatches: list                 # (id, why) — MUST be empty
    duplicates: list                 # ids settled more than once
    hung: list                       # ids never settled in max_steps
    retraced: list                   # (replica, trace_count) != 1

    @property
    def ok(self) -> bool:
        return not (self.mismatches or self.duplicates or self.hung
                    or self.retraced)

    def summary(self) -> str:
        verdict = 'PASS' if self.ok else 'FAIL'
        return (f'[{verdict}] seed={self.seed} kill={self.component}'
                f'@tick{self.step}: {self.completed} exact, '
                f'{len(self.degraded)} typed-degraded, '
                f'{len(self.refused)} refused, '
                f'{len(self.mismatches)} mismatched, '
                f'{len(self.duplicates)} duplicated, {len(self.hung)} hung, '
                f'{len(self.retraced)} retraced')


def _submit_all(router: Router, workload: list) -> tuple[list, dict]:
    """Front-door pass: every request goes in before any kill (the
    harness floor ``lo >= 1`` guarantees it), so the refusal set is a
    pure function of the fleet's initial state — identical across the
    reference and chaos runs by construction."""
    accepted: list = []
    refused: dict = {}
    for request in workload:
        try:
            router.submit(request)
        except _TYPED_REFUSALS as refusal:
            refused[request.id] = type(refusal).__name__
        else:
            accepted.append(request)
    return accepted, refused


def _drain(harness: FleetHarness, pick: ChaosPick | None,
           max_steps: int) -> dict:
    """Run one fleet to idle, firing the pick's kill after its tick;
    returns the run's full observation record."""
    router = harness.router
    accepted, refused = _submit_all(router, harness.workload)
    settled: dict[str, int] = {}     # id -> times seen terminal
    streamed: dict[str, list] = {}   # id -> tokens off FleetTick.emitted
    takeover = None
    fired = pick is None
    for _ in range(max_steps):
        if router.idle and fired:
            break
        tick = router.step()
        for request_id, tokens in tick.emitted.items():
            bucket = streamed.setdefault(request_id, [])
            if isinstance(tokens, (list, tuple)):
                bucket.extend(int(token) for token in tokens)
            else:
                bucket.append(int(tokens))
        for request_id in tick.completed:
            settled[request_id] = settled.get(request_id, 0) + 1
        for completion, _slack in tick.shed:
            request_id = completion.request.id
            settled[request_id] = settled.get(request_id, 0) + 1
        if not fired and router.ticks >= pick.step:
            fired = True
            logger.info('chaos: killing %r after tick %d', pick.component,
                        router.ticks)
            successor = harness.kills[pick.component]()
            if isinstance(successor, tuple):
                successor, takeover = successor
            if isinstance(successor, Router):
                router = successor   # the standby is the fleet now
        if harness.advance is not None:
            harness.advance()
    hung = sorted(request.id for request in accepted
                  if request.id not in router.results)
    return dict(router=router, accepted=accepted, refused=refused,
                results=dict(router.results), settled=settled,
                streamed=streamed, takeover=takeover, hung=hung)


def _stream_ok(streamed: list, final: list) -> bool:
    """The streamed transcript must be an order-preserving subsequence
    of the final tokens (a hot reroute skips re-emitting its prefix, a
    takeover resumes mid-stream — but chaos may never stream a token
    the completion does not contain, in an order it does not)."""
    position = 0
    for token in streamed:
        try:
            position = final.index(token, position) + 1
        except ValueError:
            return False
    return True


def certify_fleet(build: Callable[[], FleetHarness], *, seed: int,
                  components: tuple[str, ...] | None = None,
                  lo: int = 1, hi: int = 8,
                  max_steps: int = 10_000) -> CertifyReport:
    """Certify one seeded chaos scenario against an undisturbed twin.

    ``build()`` constructs a fresh :class:`FleetHarness` — called twice,
    once for the reference fleet (never killed) and once for the chaos
    fleet, so the two runs start bit-identical. The victim and its kill
    tick come from :func:`~tpusystem_torch.parallel.chaos.pick_chaos(seed)`
    over ``components`` (default: every key of the harness's ``kills``);
    ``lo >= 1`` keeps the kill after submission, so acceptance itself is
    never racy. Returns a :class:`CertifyReport`; red runs replay from
    ``seed`` alone.
    """
    if lo < 1:
        raise ValueError('lo must be >= 1: the kill lands after the '
                         'workload is accepted, or acceptance itself races')
    reference = _drain(build(), None, max_steps)
    if reference['hung']:
        raise RuntimeError(
            f'the UNDISTURBED reference fleet never drained '
            f'({reference["hung"]}) — fix the harness before certifying '
            f'chaos against it')
    harness = build()
    available = tuple(components) if components else tuple(harness.kills)
    missing = [name for name in available if name not in harness.kills]
    if missing:
        raise ValueError(f'harness has no kill thunk for {missing}; '
                         f'wired: {sorted(harness.kills)}')
    pick = pick_chaos(seed, available, lo=lo, hi=hi)
    chaos = _drain(harness, pick, max_steps)

    mismatches: list = []
    duplicates = sorted(request_id
                        for request_id, count in chaos['settled'].items()
                        if count > 1)
    if set(chaos['refused']) != set(reference['refused']):
        mismatches.append(('(front door)',
                           f'refusals diverged: chaos '
                           f'{sorted(chaos["refused"])} vs reference '
                           f'{sorted(reference["refused"])}'))
    completed = 0
    degraded: list = []
    for request in chaos['accepted']:
        request_id = request.id
        completion = chaos['results'].get(request_id)
        if completion is None:
            continue                 # already in hung
        expected = reference['results'].get(request_id)
        if expected is None:
            mismatches.append((request_id, 'settled under chaos but never '
                                           'in the reference'))
            continue
        if (completion.reason in _DEGRADED_REASONS
                and completion.reason != expected.reason):
            # a typed downgrade: allowed, but only truthfully — expiry
            # requires the request to actually carry a deadline
            if (completion.reason == 'expired'
                    and getattr(request, 'deadline', None) is None):
                mismatches.append((request_id,
                                   'expired without a deadline'))
                continue
            degraded.append(request_id)
            continue
        if completion.reason != expected.reason:
            mismatches.append((request_id,
                               f'reason {completion.reason!r} != reference '
                               f'{expected.reason!r}'))
            continue
        if list(completion.tokens) != list(expected.tokens):
            mismatches.append((request_id,
                               f'tokens diverged at length '
                               f'{len(completion.tokens)} vs '
                               f'{len(expected.tokens)}'))
            continue
        stream = chaos['streamed'].get(request_id, [])
        if not _stream_ok(stream, list(completion.tokens)):
            mismatches.append((request_id,
                               'streamed transcript is not a subsequence '
                               'of the completion'))
            continue
        completed += 1

    retraced: list = []
    for handle in chaos['router'].handles:
        if not handle.healthy:
            continue                 # the victim may hold a stale count
        engine = getattr(handle.scheduler, 'engine', None)
        count = getattr(engine, 'trace_count', None)
        if count is not None and count != 1:
            retraced.append((handle.name, count))

    report = CertifyReport(
        seed=seed, component=pick.component, step=pick.step,
        accepted=len(chaos['accepted']), refused=dict(chaos['refused']),
        completed=completed, degraded=degraded, takeover=chaos['takeover'],
        mismatches=mismatches, duplicates=duplicates, hung=chaos['hung'],
        retraced=retraced)
    logger.info('%s', report.summary())
    return report
