"""Training service: iterate / train / validate (the twin of
``examples/tinysys/tinysys/services/training.py``): the epoch choreography
as named, DI-injected handlers, with one event per phase on the producer.
The hot loop advances the step and reads nothing back; throughput timing
brackets the whole phase (:class:`tpusystem_torch.observe.StepTimer`), and
batches land on the mesh's device through the aggregate's ``shard_batch``.
"""

from __future__ import annotations

from tpusystem_torch.depends import Depends, Provider
from tpusystem_torch.observe import StepTimer
from tpusystem_torch.observe.events import Iterated, Trained, Validated
from tpusystem_torch.services import Producer, Service
from tpusystem_torch.train import grouped_batches

provider = Provider()
service = Service(provider=provider)
producer = Producer()


def steps_per_dispatch() -> int:
    """Train/validate steps per host dispatch (override at the composition
    root; N > 1 runs N steps per ``fit_many`` call — events/metrics keep
    phase cadence)."""
    return 1


@service.handler
def iterate(model, loaders, metrics) -> None:
    """One epoch: train phase, validation phase, epoch edge + event."""
    train(model, loaders['train'], metrics)
    metrics.reset()
    validate(model, loaders['evaluation'], metrics)
    metrics.reset()
    try:
        model.epoch += 1                  # fires onepoch() -> events.commit()
    finally:
        # The epoch edge may unwind an early-stop exception; the Iterated
        # event must still go out or the stopping epoch — the one most worth
        # keeping — would never reach the store/checkpoint consumers.
        producer.dispatch(Iterated(model, loaders))


@service.handler
def train(model, loader, metrics,
          dispatch: int = Depends(steps_per_dispatch)) -> None:
    model.phase = 'train'
    timer = StepTimer(producer).start()
    loss = None
    if dispatch == 1 or not hasattr(model, 'fit_many'):
        # per-batch path — the Model protocol's surface (fit/shard_batch)
        for batch in loader:
            inputs, targets = model.shard_batch(batch)
            predictions, loss = model.fit(inputs, targets)
            metrics.update(loss, predictions, targets)
    else:
        # N steps per host dispatch (aggregate-level fit_many)
        for batch_stack in grouped_batches(loader, dispatch):
            inputs, targets = model.shard_batches(batch_stack)
            predictions, loss = model.fit_many(inputs, targets)
            metrics.update(loss, predictions, targets)
    results = metrics.compute()           # the one device->host read
    timer.stop(model, 'train', steps=len(loader), result=loss)
    producer.dispatch(Trained(model, results))


@service.handler
def validate(model, loader, metrics,
             dispatch: int = Depends(steps_per_dispatch)) -> None:
    model.phase = 'evaluation'
    timer = StepTimer(producer).start()
    loss = None
    if dispatch == 1 or not hasattr(model, 'evaluate_many'):
        for batch in loader:
            inputs, targets = model.shard_batch(batch)
            predictions, loss = model.evaluate(inputs, targets)
            metrics.update(loss, predictions, targets)
    else:
        for batch_stack in grouped_batches(loader, dispatch):
            inputs, targets = model.shard_batches(batch_stack)
            predictions, loss = model.evaluate_many(inputs, targets)
            metrics.update(loss, predictions, targets)
    results = metrics.compute()
    timer.stop(model, 'evaluation', steps=len(loader), result=loss)
    producer.dispatch(Validated(model, results))
