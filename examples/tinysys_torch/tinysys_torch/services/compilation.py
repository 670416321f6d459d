"""Aggregate compilation pipeline (the twin of
``examples/tinysys/tinysys/services/compilation.py``): build -> move to
device -> warm up -> bring epoch -> restore weights. "Move to device"
places the train state on the injected *mesh*'s device; the warm-up runs
one evaluation step on a production-shaped batch, so the first batch's
one-time costs (library handles, first launches) move here — the port's
steps are eager, there is nothing to lower; create-or-resume reads the
experiment store by the aggregate's identity hash and refuses epoch
regressions; restore loads the checkpoint into the state in place.
"""

from __future__ import annotations

import torch

from tpusystem_torch.compiler import Compiler, Depends
from tpusystem_torch.depends import Provider
from tpusystem_torch.parallel import single_device_mesh
from tpusystem_torch.storage import ports

from ..classifier import Classifier

provider = Provider()
compiler = Compiler[Classifier](provider=provider)


def mesh():
    """The device mesh (override at the composition root)."""
    return single_device_mesh()


def sample_inputs():
    """A shape-defining sample batch."""
    return torch.zeros((1, 28, 28), dtype=torch.float32)


def batch_size() -> int:
    """The production batch size (override to match the loaders at the
    composition root)."""
    return 64


def models() -> ports.Models:
    raise NotImplementedError('override the models store dependency')


def experiment() -> str:
    return 'default'


def repository():
    raise NotImplementedError('override the repository dependency')


@compiler.step
def build_classifier(network, criterion, optimizer) -> Classifier:
    return Classifier(network, criterion, optimizer)


@compiler.step
def place_on_mesh(classifier: Classifier,
                  device_mesh=Depends(mesh),
                  sample=Depends(sample_inputs)) -> Classifier:
    classifier.place(sample, device_mesh)
    return classifier


@compiler.step
def warm_compile(classifier: Classifier,
                 sample=Depends(sample_inputs),
                 size: int = Depends(batch_size)) -> Classifier:
    """One evaluation step on a production-shaped batch: the counterpart
    of the reference's XLA warm-up. It leaves the state as it was."""
    inputs = torch.zeros((size, *sample.shape[1:]), dtype=sample.dtype)
    targets = torch.zeros((size,), dtype=torch.int32)
    inputs, targets = classifier.shard_batch((inputs, targets))
    classifier._eval_step(classifier.state, inputs, targets)
    return classifier


@compiler.step
def bring_epoch(classifier: Classifier,
                store: ports.Models = Depends(models),
                name: str = Depends(experiment)) -> Classifier:
    """Create-or-resume by identity (``compilation.py:41-57``): an existing
    row resumes at its recorded epoch; a fresh aggregate gets a row at 0."""
    row = store.read(str(classifier.id), name)
    if row is None:
        store.create(ports.Model(hash=str(classifier.id), experiment=name,
                                 epoch=0))
        return classifier
    if row.epoch < classifier.epoch:
        raise ValueError(
            f'epoch regression: store has {row.epoch}, aggregate at '
            f'{classifier.epoch}')
    classifier.epoch = row.epoch
    return classifier


@compiler.step
def restore_weights(classifier: Classifier,
                    weights=Depends(repository)) -> Classifier:
    if classifier.epoch > 0:
        weights.restore(classifier)
    return classifier
