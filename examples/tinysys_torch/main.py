"""tinysys_torch composition root (the twin of ``examples/tinysys/main.py``).

Register types, override dependencies, wire producer->consumers, build
parts, compile the aggregate, drive epochs. :class:`tpusystem_torch.Runtime`
is the one-process control plane (a no-op Loopback), the storage and
TensorBoard consumers register ``primary_only``, and the early-stop verdict
goes through ``runtime.should_stop`` each epoch, as on the reference.

Run: ``python main.py [epochs] [--device cpu]`` from this directory (the
CUDA card unless ``--device`` says otherwise).
"""

from __future__ import annotations

import contextlib
import logging
import pathlib
import sys

import torch

from tpusystem_torch import Runtime
from tpusystem_torch.checkpoint import Repository
from tpusystem_torch.data import Loader, SyntheticDigits
from tpusystem_torch.models import MLP
from tpusystem_torch.observe import (checkpoint_consumer, logging_consumer,
                                     tensorboard_consumer, tracking_consumer)
from tpusystem_torch.observe import tensorboard as tb
from tpusystem_torch.observe import tracking
from tpusystem_torch.parallel import MeshSpec
from tpusystem_torch.storage import (DocumentIterations, DocumentMetrics,
                                     DocumentModels, DocumentModules,
                                     DocumentStore)
from tpusystem_torch.train import Adam, CrossEntropyLoss

from tinysys_torch.metrics import ClassifierMetrics
from tinysys_torch.services import compilation, training

ROOT = pathlib.Path(__file__).parent / 'data'
BATCH = 64


def main(epochs: int = 10, device=None) -> None:
    """Train to ``epochs`` (resuming a stored run) on ``device``: the card
    of ``MeshSpec(data=-1).build()`` when None, else that device."""
    logging.basicConfig(level=logging.INFO, format='%(message)s', force=True)
    runtime = Runtime(ledger=True)

    # --- storage + observability wiring (primary host only) ---------------
    store = DocumentStore(ROOT / 'experiments.json')
    repository = Repository(ROOT / 'weights')
    overrides = {
        tracking.metrics_store: lambda: DocumentMetrics(store),
        tracking.models_store: lambda: DocumentModels(store),
        tracking.modules_store: lambda: DocumentModules(store),
        tracking.iterations_store: lambda: DocumentIterations(store),
        tracking.repository: lambda: repository,
        tb.writer: lambda: tb.SummaryWriter(ROOT / 'tensorboard'),
    }
    for consumer in (tracking_consumer(), tensorboard_consumer()):
        consumer.dependency_overrides.update(overrides)
        runtime.producer.register(consumer, primary_only=True)
    # checkpoint saves run on every host, unlike the metadata stores above
    saver = checkpoint_consumer()
    saver.dependency_overrides[tracking.repository] = lambda: repository
    runtime.producer.register(saver)
    runtime.producer.register(logging_consumer())
    training.producer = runtime.producer   # handlers dispatch on the runtime bus
    # 8 steps per host dispatch: the per-batch Python cost is paid once per
    # 8 batches (events/metrics keep phase cadence)
    training.provider.override(training.steps_per_dispatch, lambda: 8)

    # --- compilation pipeline overrides -----------------------------------
    compilation.provider.override(compilation.models,
                                  lambda: DocumentModels(store))
    compilation.provider.override(compilation.repository, lambda: repository)
    # data-parallel over every device of the job: the card, or the device
    # asked for
    mesh = MeshSpec(data=-1).build(
        None if device is None else [torch.device(device)])
    compilation.provider.override(compilation.mesh, lambda: mesh)
    compilation.provider.override(compilation.batch_size, lambda: BATCH)

    # --- build + compile the aggregate ------------------------------------
    placed = mesh.device
    network = MLP(features=(256, 128), classes=10, dropout=0.1, device=placed)
    classifier = compilation.compiler.compile(
        network, CrossEntropyLoss(), Adam(lr=1e-3))

    loaders = {
        'train': Loader(SyntheticDigits(samples=4096), batch_size=BATCH,
                        shuffle=True, seed=1, device=placed),
        'evaluation': Loader(SyntheticDigits(samples=1024, train=False),
                             batch_size=BATCH, device=placed),
    }
    metrics = ClassifierMetrics()

    # --- epoch loop, agreed early stop ------------------------------------
    print(f'training {classifier.id} from epoch {classifier.epoch}')
    try:
        for _ in range(classifier.epoch, epochs):
            wants_stop = False
            try:
                training.service.handle('iterate', classifier, loaders,
                                        metrics)
            except StopIteration:
                wants_stop = True
            runtime.sync()
            if runtime.should_stop(wants_stop):
                print('early stop agreed across hosts')
                break
    finally:
        # LIFO stack: each close runs even if an earlier one (or the async
        # checkpoint wait) raises
        with contextlib.ExitStack() as cleanup:
            cleanup.callback(runtime.close)
            cleanup.callback(store.close)
            repository.close()   # waits for pending async saves, then releases


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('epochs', nargs='?', type=int, default=10)
    parser.add_argument('--device', default=None,
                        help="e.g. 'cpu' (default: the CUDA card)")
    arguments = parser.parse_args(sys.argv[1:])
    main(arguments.epochs, device=arguments.device)
