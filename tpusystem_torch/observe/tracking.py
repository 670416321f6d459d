"""Experiment-tracking consumer: metrics, metadata, and weights persistence.
The port of :mod:`tpusystem.observe.tracking`, copied.

Reference parity: ``examples/tinysys/tinysys/services/storage.py`` — fully
event-driven tracking. ``Trained``/``Validated`` persist the metric values;
``Iterated`` advances the model row's epoch and records registry metadata
for the aggregate's constituent modules and the phase loaders. Weight
snapshots live in the separate :func:`checkpoint_consumer` (collective
sharded saves must run on every host; the metadata stores here are
``primary_only``).

Conventions:
* the aggregate's ``id`` is its registry hash (string);
* an aggregate may expose ``modules() -> dict[kind, object]`` returning its
  registered parts (network, criterion, optimizer); kinds are free-form;
* ``Iterated.loaders`` may be a ``dict[phase, loader]`` of registered
  loaders.

All dependencies are DI seams overridden at the composition root — tests
inject fakes exactly like the reference's
``examples/tinysys/tests/test_storage.py:33-66``.
"""

from __future__ import annotations

from typing import Any

from tpusystem_torch.observe.events import Iterated, Trained, Validated
from tpusystem_torch.registry import getarguments, gethash, getname
from tpusystem_torch.services.prodcon import Consumer, Depends
from tpusystem_torch.storage import ports


def experiment() -> str:
    """Name of the current experiment (override at composition root)."""
    return 'default'


def metrics_store() -> ports.Metrics:
    raise NotImplementedError('override the metrics store dependency')


def models_store() -> ports.Models:
    raise NotImplementedError('override the models store dependency')


def modules_store() -> ports.Modules:
    raise NotImplementedError('override the modules store dependency')


def iterations_store() -> ports.Iterations:
    raise NotImplementedError('override the iterations store dependency')


def repository() -> Any:
    """Weight repository (:class:`tpusystem_torch.checkpoint.Repository`)."""
    raise NotImplementedError('override the repository dependency')


def _metadata(obj: Any) -> tuple[str | None, str, dict]:
    """(hash, name, arguments) for a registered object; unregistered objects
    degrade to their class name (the reference raises — degrading keeps
    tracking usable for ad-hoc parts)."""
    try:
        return gethash(obj), getname(obj), getarguments(obj)
    except AttributeError:
        return None, obj.__class__.__name__, {}


def tracking_consumer() -> Consumer:
    consumer = Consumer('tracking')

    @consumer.handler
    def handle_metrics(event: Trained | Validated,
                       metrics: ports.Metrics = Depends(metrics_store)) -> None:
        phase = 'train' if isinstance(event, Trained) else 'evaluation'
        for name, value in event.metrics.items():
            metrics.add(ports.Metric(
                model=str(event.model.id), name=name, value=float(value),
                epoch=getattr(event.model, 'epoch', 0), phase=phase))

    @consumer.handler
    def handle_epoch(event: Iterated,
                     models: ports.Models = Depends(models_store),
                     name: str = Depends(experiment)) -> None:
        models.update(ports.Model(
            hash=str(event.model.id), experiment=name,
            epoch=getattr(event.model, 'epoch', 0)))

    @consumer.handler
    def handle_modules(event: Iterated,
                       modules: ports.Modules = Depends(modules_store)) -> None:
        parts = getattr(event.model, 'modules', None)
        if not callable(parts):
            return
        epoch = getattr(event.model, 'epoch', 0)
        for kind, part in parts().items():
            digest, alias, arguments = _metadata(part)
            modules.put(ports.Module(
                model=str(event.model.id), kind=kind, hash=digest,
                name=alias, arguments=arguments, epoch=epoch))

    @consumer.handler
    def handle_iterations(event: Iterated,
                          iterations: ports.Iterations = Depends(iterations_store)) -> None:
        if not isinstance(event.loaders, dict):
            return
        epoch = getattr(event.model, 'epoch', 0)
        for phase, loader in event.loaders.items():
            digest, alias, arguments = _metadata(loader)
            iterations.put(ports.Iteration(
                model=str(event.model.id), phase=str(phase), hash=digest,
                name=alias, arguments=arguments, epoch=epoch))

    return consumer


def checkpoint_consumer() -> Consumer:
    """Weight snapshots on every ``Iterated`` edge.

    Deliberately separate from :func:`tracking_consumer`: sharded checkpoint
    saves are *collective* (each host writes the array shards it owns), so
    this consumer must register on **every** host, while the metadata stores
    above are ``primary_only``. Registering it primary-only on a pod would
    deadlock rank 0 on the save barrier."""
    consumer = Consumer('checkpoint')

    @consumer.handler
    def save_weights(event: Iterated,
                     weights: Any = Depends(repository)) -> None:
        weights.store(event.model)

    return consumer
