"""Divergence sentinel: the port of :mod:`tpusystem.train.sentinel`.

Three layers, cheapest first, as in the reference:

1. **On-card detection** (:class:`Guard`, given to
   ``build_train_step(..., guard=Guard())``): loss and global-grad-norm
   finiteness plus an EMA grad-norm spike z-score, computed on the card by
   the step itself. The statistics ride :class:`~tpusystem_torch.train.state.
   HealthStats` on the state. On a bad step the optimizer update is
   suppressed by :func:`tpusystem_torch.train.optim.masked_update`: params
   and moments untouched, no host sync.
2. **Host-side policy** (:class:`Sentinel`): reads the per-step health rows
   at the phase's one sync and escalates — skip (already done on the card)
   → LR backoff through ``HealthStats.lr_scale`` → rollback to the last
   committed checkpoint *before* the anomaly with a skip-window over the
   offending cursor range → bounded give-up
   (:class:`~tpusystem_torch.parallel.recovery.DivergenceError`, exit code
   44). Every transition is a domain event
   (:mod:`tpusystem_torch.observe.events`).
3. **SDC parity** (:meth:`Sentinel.check_parity`): bit checksums of every
   parameter on each replica of a data-parallel mesh
   (:func:`tpusystem_torch.parallel.collectives.replica_checksums`),
   compared across replicas before a checkpoint commits.

Typical wiring::

    guard = Guard(zmax=6.0)
    step = build_train_step(apply_fn, criterion, optimizer, guard=guard)
    state = guard.arm(init_state(module, optimizer))
    sentinel = Sentinel(checkpointer=ckpt, identity=identity, loader=loader,
                        producer=runtime.producer, model=model)
    for epoch in range(epochs):
        for batch in loader:
            state, (_, loss) = step(state, *batch)   # no host sync here
        state = sentinel.review(state)      # phase cadence: ONE host sync
        ckpt.save(identity, int(state.step), state,
                  extras=resume_extras(state, loader))

(With ``build_multi_step(..., guard=True)`` the dispatch returns the
``[N, 4]`` per-step health rows — pass them to ``review(state, health)``.)
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from tpusystem_torch.parallel.recovery import DivergenceError
from tpusystem_torch.registry import register
from tpusystem_torch.train.optim import global_norm
from tpusystem_torch.train.state import HealthStats, TrainState

logger = logging.getLogger('tpusystem_torch.sentinel')

__all__ = ['Guard', 'Sentinel', 'HEALTH_COLUMNS', 'HEALTH_OK', 'HEALTH_LOSS',
           'HEALTH_GNORM', 'HEALTH_Z', 'DivergenceError']

# layout of HealthStats.last / the per-step health rows
HEALTH_COLUMNS = ('ok', 'loss', 'gnorm', 'zscore')
HEALTH_OK, HEALTH_LOSS, HEALTH_GNORM, HEALTH_Z = range(4)


@register
class Guard:
    """On-card anomaly detector — the ``guard=`` recipe of a train step.

    A registered entity like the optimizers: its hyperparameters enter the
    experiment's identity hash.

    Args:
        ema: decay of the grad-norm EMAs (bias-corrected at read time).
        zmax: spike threshold in robust standard deviations — a *finite*
            step whose global grad norm sits more than ``zmax`` sigmas above
            the EMA mean is suppressed like a non-finite one.
        warmup: healthy steps folded into the EMAs before the spike detector
            arms (finiteness checks are always armed).
        spike_floor: relative sigma floor (fraction of the EMA mean).
    """

    def __init__(self, ema: float = 0.98, zmax: float = 6.0,
                 warmup: int = 20, spike_floor: float = 0.05):
        self.ema = ema
        self.zmax = zmax
        self.warmup = warmup
        self.spike_floor = spike_floor

    def arm(self, state: TrainState) -> TrainState:
        """Attach fresh :class:`HealthStats` on the state's device
        (idempotent); returns the state."""
        if state.health is None:
            state.health = HealthStats.create(state.device)
        return state

    @torch.no_grad()
    def judge(self, health: HealthStats, loss, grads: list,
              params: list | None = None) -> torch.Tensor:
        """One step's verdict ``ok`` (a bool tensor), ``health`` updated in
        place: the reference's ``judge`` (``sentinel.py:123-160``), branch
        free on the card. The global norm is the optimizer's float32
        :func:`~tpusystem_torch.train.optim.global_norm` (``params`` keyed
        like ``grads``, for scanned stacks). Anomalous steps fold into
        neither the EMAs nor the warmup count."""
        gnorm = global_norm(grads, params).float()
        loss = torch.as_tensor(loss).float()
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        safe_gnorm = torch.where(torch.isfinite(gnorm), gnorm,
                                 torch.zeros_like(gnorm))
        # the decay and its complement as the reference's float32 values,
        # held as Python floats (a float32 tensor rounds a Python scalar
        # operand to float32): no host-to-device copy in the step
        decay = float(np.float32(self.ema))
        keep = float(np.float32(1.0) - np.float32(self.ema))
        # bias-corrected EMA read (Adam-style): EMAs start at zero
        bias = 1.0 - torch.pow(decay, torch.clamp(health.count,
                                                  min=1).float())
        mean = health.ema_norm / bias
        variance = torch.clamp(health.ema_sq / bias - mean ** 2, min=0.0)
        sigma = torch.sqrt(variance + (self.spike_floor * mean) ** 2 + 1e-12)
        zscore = (safe_gnorm - mean) / sigma
        armed = health.count >= self.warmup
        spike = armed & finite & (zscore > self.zmax)
        ok = finite & ~spike
        health.ema_norm.copy_(torch.where(
            ok, decay * health.ema_norm + keep * safe_gnorm,
            health.ema_norm))
        health.ema_sq.copy_(torch.where(
            ok, decay * health.ema_sq + keep * safe_gnorm ** 2,
            health.ema_sq))
        health.last.copy_(torch.stack([ok.float(), loss, gnorm, zscore]))
        health.count += ok.int()
        health.bad_steps += 1 - ok.int()
        return ok


class Sentinel:
    """Host-side escalation policy over the guarded step's health rows
    (``tpusystem/train/sentinel.py:163-361``, copied).

    Reads per-step health rows at the phase-cadence sync point and walks
    the ladder: count skipped steps → LR backoff → rollback+skip-window →
    bounded give-up. All thresholds are measured over a sliding ``window``
    of the most recently reviewed steps.

    Args:
        checkpointer: :class:`tpusystem_torch.checkpoint.Checkpointer` for
            the rollback rung (None disables rollback).
        identity: checkpoint identity (registry hash) of the run.
        loader: the data loader; on rollback its *current* cursor is kept
            (never rewound) — the PaLM skip-window over the offending
            batches.
        producer: event bus every transition is published on.
        model: host-side aggregate (or identity string) carried in events.
        window: sliding window (in reviewed steps) the thresholds count over.
        backoff_after: bad steps in the window before LR backoff level 1;
            level ``n+1`` needs ``backoff_after * (n+1)``.
        backoff_factor: per-level multiplier applied to ``lr_scale``.
        max_backoffs: backoff levels before the ladder stops deepening.
        recover_after: consecutive healthy steps before ``lr_scale`` resets
            to 1.0.
        rollback_after: bad steps in the window that trigger rollback to the
            newest committed checkpoint *preceding* the first bad step.
        max_rollbacks: rollbacks before the bounded give-up.
        on_backoff: optional hook ``(level, scale) -> None``.
    """

    def __init__(self, *, checkpointer: Any = None, identity: str | None = None,
                 loader: Any = None, producer: Any = None, model: Any = None,
                 window: int = 32, backoff_after: int = 2,
                 backoff_factor: float = 0.5, max_backoffs: int = 4,
                 recover_after: int = 32, rollback_after: int = 6,
                 max_rollbacks: int = 2,
                 on_backoff: Callable[[int, float], None] | None = None):
        self.checkpointer = checkpointer
        self.identity = identity
        self.loader = loader
        self.producer = producer
        self.model = model
        self.window = window
        self.backoff_after = backoff_after
        self.backoff_factor = backoff_factor
        self.max_backoffs = max_backoffs
        self.recover_after = recover_after
        self.rollback_after = rollback_after
        self.max_rollbacks = max_rollbacks
        if checkpointer is not None and identity is None:
            raise ValueError(
                'Sentinel(checkpointer=...) needs identity= too — the '
                'rollback rung restores by identity, and discovering that '
                'at rollback time would crash the recovery path itself')
        self.on_backoff = on_backoff
        self.rollbacks = 0
        self.level = 0
        self._recent: deque[tuple[int, bool]] = deque(maxlen=window)
        self._streak = 0

    def _emit(self, event: Any) -> None:
        if self.producer is not None:
            self.producer.dispatch(event)

    def _subject(self) -> Any:
        return self.model if self.model is not None else self.identity

    def review(self, state: TrainState, health: Any = None) -> TrainState:
        """Digest the health rows since the last review; escalate if needed.

        ``health`` is a ``[n, 4]`` stack of per-step rows (what
        ``build_multi_step(..., guard=True)`` returns) or None to read the
        most recent row, ``state.health.last``. This call is the one
        device→host sync of the phase. Returns the state (rescaled or
        rolled back in place); raises :class:`DivergenceError` when the
        ladder is exhausted.
        """
        if health is None:
            if state.health is None:
                raise ValueError('state has no health stats: build the step '
                                 'with guard= and arm the state (Guard.arm)')
            health = state.health.last
        if isinstance(health, torch.Tensor):
            health = health.detach().cpu().numpy()
        rows = np.atleast_2d(np.asarray(health, np.float32))
        end = int(state.step)
        first_step = end - len(rows) + 1
        for offset, row in enumerate(rows):
            at = first_step + offset
            ok = bool(row[HEALTH_OK] >= 0.5)
            self._recent.append((at, ok))
            if ok:
                self._streak += 1
                continue
            self._streak = 0
            loss, gnorm = float(row[HEALTH_LOSS]), float(row[HEALTH_GNORM])
            kind = ('nonfinite' if not (np.isfinite(loss) and np.isfinite(gnorm))
                    else 'spike')
            logger.warning('anomalous step %d (%s): loss=%g grad_norm=%g '
                           'z=%.2f — update suppressed', at, kind, loss,
                           gnorm, float(row[HEALTH_Z]))
            from tpusystem_torch.observe.events import AnomalyDetected
            self._emit(AnomalyDetected(model=self._subject(), step=at,
                                       kind=kind, loss=loss, gnorm=gnorm,
                                       zscore=float(row[HEALTH_Z])))
        bad = [at for at, ok in self._recent if not ok]
        if len(bad) >= self.rollback_after and self.checkpointer is not None:
            return self._rollback(state, first_bad=min(bad), step=end)
        if (bad and len(bad) >= self.backoff_after * (self.level + 1)
                and self.level < self.max_backoffs):
            self.level += 1
            return self._apply_scale(state, self.backoff_factor ** self.level,
                                     step=end)
        if self.level and self._streak >= self.recover_after:
            self.level = 0
            # the healthy streak outlived the window's memory of the burst:
            # forget it, or the stale bad steps would re-trigger a backoff
            # on the very next review
            self._recent.clear()
            return self._apply_scale(state, 1.0, step=end)
        return state

    def _apply_scale(self, state: TrainState, scale: float,
                     step: int) -> TrainState:
        from tpusystem_torch.observe.events import BackoffApplied
        state.health.lr_scale.fill_(scale)
        logger.warning('sentinel backoff level %d: lr_scale=%g at step %d',
                       self.level, scale, step)
        self._emit(BackoffApplied(model=self._subject(), step=step,
                                  level=self.level, scale=scale))
        if self.on_backoff is not None and self.level:
            # the hook sees backoffs only; the recovery reset (level 0,
            # scale 1.0) is built-in and announced by the event alone
            self.on_backoff(self.level, scale)
        return state

    def _rollback(self, state: TrainState, first_bad: int,
                  step: int) -> TrainState:
        if self.rollbacks >= self.max_rollbacks:
            raise DivergenceError(
                f'divergence persists after {self.rollbacks} rollback(s): '
                f'{len([1 for _, ok in self._recent if not ok])} bad steps '
                f'in the last {len(self._recent)} at step {step}', step=step)
        committed = self.checkpointer.committed(self.identity)
        candidates = [at for at in committed if at < first_bad]
        if not candidates:
            raise DivergenceError(
                f'no committed checkpoint predates the anomaly at step '
                f'{first_bad} (committed: {committed or "none"})',
                step=step)
        target = max(candidates)
        # restored into the live tensors in place: the checkpointed
        # lr_scale (saved before the burst) comes back with them, so the
        # host ladder resets to match
        restored = self.checkpointer.restore(self.identity, state,
                                             epoch=target)
        self.level = 0
        # PaLM skip-window: the loader is NOT rewound — training continues
        # from the current cursor, so the batches consumed between the
        # rollback target and now are skipped, never replayed
        extras = self.checkpointer.extras(self.identity, target)
        window = {'from': (extras or {}).get('cursor'),
                  'to': self.loader.state() if self.loader is not None else None}
        # steps after the target are a dead branch now: discard them so
        # post-rollback saves cannot collide with stale step numbers
        self.checkpointer.discard_after(self.identity, target)
        self.rollbacks += 1
        self._recent.clear()
        self._streak = 0
        logger.warning('sentinel rollback #%d: step %d -> %d, skip-window %s',
                       self.rollbacks, step, target, window)
        from tpusystem_torch.observe.events import RolledBack
        self._emit(RolledBack(model=self._subject(), step=step,
                              to_step=target, window=window))
        return restored

    def check_parity(self, state: TrainState | Any, mesh, *,
                     axis: str = 'data', raise_on_mismatch: bool = True):
        """Cross-replica parity check of data-parallel params
        (``sentinel.py:362``).

        Checksums every param leaf per ``axis`` replica (order-independent
        bit checksums, gathered over ``axis``: :func:`~tpusystem_torch.
        parallel.collectives.replica_checksums`) and compares rows. Run it
        at checkpoint cadence, *before* the save: a replica corrupted by an
        SDC is flagged here instead of contaminating the checkpoint. Every
        rank of the mesh calls it (the checksums are a collective).

        Returns None when all replicas agree; on a mismatch emits
        :class:`~tpusystem_torch.observe.events.ReplicaDiverged` and raises
        :class:`DivergenceError` (or, with ``raise_on_mismatch=False``,
        returns ``(bad_replicas, bad_leaves)``). A strict majority
        attributes the minority replicas; without one (two replicas, or an
        even split) every replica of the disagreeing column is reported.
        """
        from tpusystem_torch.parallel import collectives
        params = state.params if isinstance(state, TrainState) else state
        matrix, paths = collectives.replica_checksums(params, mesh,
                                                      axis=axis)
        if bool(np.all(matrix == matrix[0])):
            return None
        bad_replicas: set[int] = set()
        bad_leaves: list[str] = []
        for column in range(matrix.shape[1]):
            values, counts = np.unique(matrix[:, column], return_counts=True)
            if len(values) == 1:
                continue
            bad_leaves.append(paths[column])
            if np.sum(counts == counts.max()) > 1:
                # no strict majority: attribution is ambiguous, so every
                # replica is reported rather than one side of the tie
                bad_replicas.update(range(matrix.shape[0]))
                continue
            majority = values[np.argmax(counts)]
            bad_replicas.update(
                int(r) for r in np.nonzero(matrix[:, column] != majority)[0])
        step = int(state.step) if isinstance(state, TrainState) else None
        replicas = sorted(bad_replicas)
        logger.error('cross-replica parity FAILED: replica(s) %s diverge on '
                     '%d leaf/leaves (e.g. %s)', replicas, len(bad_leaves),
                     bad_leaves[:3])
        from tpusystem_torch.observe.events import ReplicaDiverged
        self._emit(ReplicaDiverged(model=self._subject(), step=step,
                                   replicas=replicas, leaves=bad_leaves))
        if raise_on_mismatch:
            raise DivergenceError(
                f'silent data corruption: replica(s) {replicas} on mesh axis '
                f'{axis!r} diverge on {len(bad_leaves)} param leaf/leaves '
                f'(e.g. {bad_leaves[:3]}); do NOT checkpoint — restart from '
                f'the last committed step', step=step)
        return replicas, bad_leaves
