"""Mergeable latency histograms: percentiles without a sorted array.
The port of :mod:`tpusystem.observe.metrics`, copied.

The serving and recovery layers have narrated latency as mean-only
scalars (``serve/ttft_seconds`` charts each admission; ``tok_s`` is a
sliding mean) — useless for a tail-latency claim. This module is the
metric plane done the way production serving systems do it (HDR
histogram style):

* **log-bucketed** — bucket boundaries grow geometrically
  (``floor * (1 + resolution) ** k``), so a fixed bucket count covers
  microseconds to minutes at a bounded *relative* error: any percentile
  read is within one bucket's relative resolution of the exact
  sorted-array answer (pinned by test).
* **exact counts, mergeable in any order** — a histogram is a counter
  per bucket; merging is counter addition, which is commutative and
  associative, so per-host histograms folded in ANY host order yield
  identical percentiles (pinned by test) — the property that makes
  fleet-wide p99 from per-replica shards correct by construction.
* **tiny on the wire** — :meth:`Histogram.state` is a dict of ints, so
  per-host shards ride the event/blob plane at phase cadence without
  shipping samples.

:func:`serve_metrics_consumer` feeds the three headline distributions —
TTFT, per-token decode seconds, recovery seconds — from the events the
serving/fleet/supervisor layers already dispatch, and charts
p50/p95/p99 to TensorBoard. The reference's ``bench.py`` prints the same
percentiles as its ``serve_ttft_p50_p99`` row.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

from tpusystem_torch.observe.events import (EngineRestarted, RecoveryTimeline,
                                      RequestAdmitted, RequestCompleted)
from tpusystem_torch.services.prodcon import Consumer, Depends

__all__ = ['Histogram', 'ServeLatency', 'serve_metrics_consumer']


class Histogram:
    """Log-bucketed latency histogram with exact counts.

    Args:
        resolution: relative bucket width — a percentile read is within
            this fraction of the exact sorted-array answer (default 5%).
        floor: values at or below it share bucket 0 (absolute precision
            floor; latencies under a microsecond are all "instant").

    ``add``/``merge``/``percentile`` are the whole surface; ``state()``/
    ``from_state()`` round-trip the counters for the wire.
    """

    def __init__(self, resolution: float = 0.05,
                 floor: float = 1e-6) -> None:
        if not 0.0 < resolution < 1.0:
            raise ValueError(f'resolution must be in (0, 1), got {resolution}')
        if floor <= 0.0:
            raise ValueError(f'floor must be positive, got {floor}')
        self.resolution = resolution
        self.floor = floor
        self._log_growth = math.log1p(resolution)
        self.counts: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def _index(self, value: float) -> int:
        if value <= self.floor:
            return 0
        return 1 + int(math.log(value / self.floor) / self._log_growth)

    def _bounds(self, index: int) -> tuple[float, float]:
        if index <= 0:
            return (0.0, self.floor)
        growth = 1.0 + self.resolution
        return (self.floor * growth ** (index - 1),
                self.floor * growth ** index)

    def add(self, value: float, n: int = 1) -> None:
        value = float(value)
        index = self._index(value)
        self.counts[index] = self.counts.get(index, 0) + n
        self.count += n
        self.total += value * n
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def merge(self, other: 'Histogram') -> 'Histogram':
        """Fold another histogram in (in place). Counter addition is
        commutative, so any merge order yields identical percentiles —
        the property the fleet aggregation relies on."""
        if (other.resolution != self.resolution
                or other.floor != self.floor):
            raise ValueError(
                f'histograms must share bucketing to merge: '
                f'({self.resolution}, {self.floor}) vs '
                f'({other.resolution}, {other.floor})')
        for index, n in other.counts.items():
            self.counts[index] = self.counts.get(index, 0) + n
        self.count += other.count
        self.total += other.total
        for bound in ('min', 'max'):
            theirs = getattr(other, bound)
            if theirs is not None:
                mine = getattr(self, bound)
                fold = min if bound == 'min' else max
                setattr(self, bound,
                        theirs if mine is None else fold(mine, theirs))
        return self

    @classmethod
    def merged(cls, shards: Iterable['Histogram']) -> 'Histogram':
        """A fresh histogram folding every shard (order-independent)."""
        out: Histogram | None = None
        for shard in shards:
            if out is None:
                out = cls(shard.resolution, shard.floor)
            out.merge(shard)
        return out if out is not None else cls()

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (``q`` in [0, 1]) to within one
        bucket's relative resolution: the geometric midpoint of the
        bucket holding the rank, clamped to the observed min/max so a
        one-sample histogram reads back its sample."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f'q must be in [0, 1], got {q}')
        if not self.count:
            raise ValueError('empty histogram has no percentiles')
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for index in sorted(self.counts):
            seen += self.counts[index]
            if seen >= rank:
                low, high = self._bounds(index)
                mid = math.sqrt(max(low, self.floor * 1e-3) * high) \
                    if index > 0 else 0.0
                return min(max(mid, self.min), self.max)
        return self.max                                   # unreachable

    def summary(self) -> dict:
        """The headline row: count, mean, p50/p95/p99, max."""
        if not self.count:
            return {'count': 0}
        return {'count': self.count,
                'mean': self.total / self.count,
                'p50': self.percentile(0.50),
                'p95': self.percentile(0.95),
                'p99': self.percentile(0.99),
                'max': self.max}

    # ------------------------------------------------------------- wire

    def state(self) -> dict:
        """JSON-able counters for the wire (phase-cadence shipping)."""
        return {'resolution': self.resolution, 'floor': self.floor,
                'counts': dict(self.counts), 'count': self.count,
                'total': self.total, 'min': self.min, 'max': self.max}

    @classmethod
    def from_state(cls, state: dict) -> 'Histogram':
        out = cls(state['resolution'], state['floor'])
        out.counts = {int(index): int(n)
                      for index, n in state['counts'].items()}
        out.count = int(state['count'])
        out.total = float(state['total'])
        out.min = state['min']
        out.max = state['max']
        return out


class ServeLatency:
    """The three serving latency distributions, fed from bus events.

    * ``ttft`` — submit → first token, from ``RequestAdmitted.ttft``;
    * ``per_token`` — whole-life seconds over produced tokens, from
      ``RequestCompleted`` (the delivered-latency a user feels);
    * ``recovery`` — engine rebuild + replay / detect → first-step, from
      ``EngineRestarted`` and ``RecoveryTimeline``.

    Attach with :meth:`consumer` (chartless) or through
    :func:`serve_metrics_consumer` (charted). Per-host instances merge
    with ``Histogram.merge`` for the fleet-wide view.
    """

    def __init__(self, resolution: float = 0.05) -> None:
        self.ttft = Histogram(resolution)
        self.per_token = Histogram(resolution)
        self.recovery = Histogram(resolution)

    def observe(self, event: Any) -> None:
        if isinstance(event, RequestAdmitted):
            self.ttft.add(event.ttft)
        elif isinstance(event, RequestCompleted):
            if event.produced:
                self.per_token.add(event.seconds / event.produced)
        elif isinstance(event, EngineRestarted):
            self.recovery.add(event.seconds)
        elif isinstance(event, RecoveryTimeline):
            self.recovery.add(event.seconds)


def serve_metrics_consumer(latency: ServeLatency | None = None,
                           cadence: int = 16) -> Consumer:
    """Consumer charting the latency percentiles to TensorBoard.

    Every ``cadence`` admissions it charts ``serve/ttft_p50|p95|p99``
    and ``serve/token_seconds_p50|p99`` against the admission counter
    (requests have no global step — the tensorboard.py convention);
    recovery percentiles chart per restart (rare events). The writer
    enters through the same :func:`tpusystem_torch.observe.tensorboard.writer`
    dependency seam as every other chart. Pass ``latency`` to share the
    histograms with a bench/report path.
    """
    from tpusystem_torch.observe.tensorboard import SummaryWriter, writer
    consumer = Consumer('serve-metrics')
    state = latency or ServeLatency()
    admits = [0]
    restarts = [0]

    @consumer.handler
    def on_admitted(event: RequestAdmitted,
                    board: SummaryWriter = Depends(writer)) -> None:
        state.observe(event)
        admits[0] += 1
        if admits[0] % cadence:
            return
        for q, tag in ((0.50, 'p50'), (0.95, 'p95'), (0.99, 'p99')):
            board.add_scalar(f'serve/ttft_{tag}',
                             state.ttft.percentile(q), admits[0])
        if state.per_token.count:
            board.add_scalar('serve/token_seconds_p50',
                             state.per_token.percentile(0.50), admits[0])
            board.add_scalar('serve/token_seconds_p99',
                             state.per_token.percentile(0.99), admits[0])

    @consumer.handler
    def on_completed(event: RequestCompleted) -> None:
        state.observe(event)

    @consumer.handler
    def on_recovery(event: EngineRestarted | RecoveryTimeline,
                    board: SummaryWriter = Depends(writer)) -> None:
        state.observe(event)
        restarts[0] += 1
        board.add_scalar('serve/recovery_p50',
                         state.recovery.percentile(0.50), restarts[0])
        board.add_scalar('serve/recovery_p99',
                         state.recovery.percentile(0.99), restarts[0])

    return consumer
