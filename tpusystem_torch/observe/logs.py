"""Logging consumer — epoch/phase summaries via stdlib logging. The port
of :mod:`tpusystem.observe.logs`, copied.

Reference parity: ``examples/tinysys/tinysys/services/logging.py:16-32``.
"""

from __future__ import annotations

import logging

from tpusystem_torch.observe.events import Iterated, StepTimed, Trained, Validated
from tpusystem_torch.services.prodcon import Consumer


def logging_consumer(logger: logging.Logger | None = None) -> Consumer:
    """Consumer printing one summary line per phase/epoch/timing event."""
    log = logger or logging.getLogger('tpusystem_torch')
    consumer = Consumer('logging')

    def describe(metrics: dict[str, float]) -> str:
        return ', '.join(f'{name}: {value:.4f}' for name, value in metrics.items())

    @consumer.handler
    def on_trained(event: Trained) -> None:
        log.info('epoch %s train      | %s',
                 getattr(event.model, 'epoch', '?'), describe(event.metrics))

    @consumer.handler
    def on_validated(event: Validated) -> None:
        log.info('epoch %s evaluation | %s',
                 getattr(event.model, 'epoch', '?'), describe(event.metrics))

    @consumer.handler
    def on_iterated(event: Iterated) -> None:
        log.info('epoch %s done       | model %s',
                 getattr(event.model, 'epoch', '?'), event.model.id)

    @consumer.handler
    def on_timed(event: StepTimed) -> None:
        log.info('epoch %s %s: %.1f steps/s (%d steps in %.2fs)',
                 getattr(event.model, 'epoch', '?'), event.phase,
                 event.steps_per_second, event.steps, event.seconds)

    return consumer
