"""The whole host slice, both packages side by side, on the CPU.

A twin ``Recommender`` aggregate in each package is built by a ``Compiler``
whose steps take their facts by ``Depends`` (the reference: the seed of
``init_state``; the port: the device and the reference's weights, carried
by ``params_from_jax``). A ``Service``'s ``train`` handler trains
``dlrm_tiny`` three SGD steps on ``SyntheticClicks(samples=96, vocabs=(64,
32), seed=0)`` and ends the phase with one ``Trained`` on a one-process
``Runtime``'s producer, which ``evaluation_consumer`` answers with
``RecsysEvaluated`` over the holdout. The event types arrive in the same
order, the ledgers give one digest, the per-step losses agree within 1e-5,
the holdout loss within 1e-5 and the AUC within one of its 512 buckets
(``tests/test_torch_recsys.py``'s tolerance), and an enqueued
``StopIteration`` unwinds out of the epoch assignment in both.
"""

import numpy as np
import pytest
import torch

import tpusystem
import tpusystem_torch
from tpusystem import train as jtrain
from tpusystem.data import Loader as JaxLoader
from tpusystem.data import SyntheticClicks as JaxClicks
from tpusystem.models import dlrm_tiny as jax_dlrm_tiny
from tpusystem.observe.events import RecsysEvaluated as JRecsysEvaluated
from tpusystem.observe.events import Trained as JTrained
from tpusystem.recsys import RecsysEvaluator as JaxEvaluator
from tpusystem.recsys import evaluation_consumer as jax_evaluation_consumer
from tpusystem.registry import gethash as jax_gethash
from tpusystem.services import Consumer as JConsumer
from tpusystem.services import Service as JService
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.data import Loader, SyntheticClicks
from tpusystem_torch.models import dlrm_tiny
from tpusystem_torch.observe.events import RecsysEvaluated, Trained
from tpusystem_torch.recsys import RecsysEvaluator, evaluation_consumer
from tpusystem_torch.registry import gethash
from tpusystem_torch.services import Consumer, Service

CLICKS = dict(samples=96, vocabs=(64, 32), seed=0)
BATCH, LR, SEED = 32, 0.5, 0


class JaxRecommender(tpusystem.Aggregate):
    """The reference's aggregate: the flax DLRM, its step and state."""

    def __init__(self, network, criterion, optimizer, state):
        super().__init__()
        self.network, self.state = network, state
        self.epoch = 0
        self._step = jtrain.build_train_step(jtrain.flax_apply(network),
                                             criterion, optimizer)

    @property
    def id(self):
        return jax_gethash(self.network)

    def fit(self, features, labels):
        self.state, (_, loss) = self._step(self.state, features, labels)
        return loss

    def onepoch(self):
        self.events.commit()


class Recommender(tpusystem_torch.Aggregate):
    """The port's aggregate: the DLRM a child module, the step in place."""

    def __init__(self, network, criterion, optimizer, state):
        super().__init__()
        self.network, self.state = network, state
        self.epoch = 0
        self._step = ttrain.build_train_step(ttrain.module_apply(network),
                                             criterion, optimizer)

    @property
    def id(self):
        return gethash(self.network)

    def fit(self, features, labels):
        self.state, (_, loss) = self._step(self.state, features, labels)
        return loss

    def onepoch(self):
        self.events.commit()


def _jax_model():
    compiler = tpusystem.Compiler()

    def seed():
        raise NotImplementedError

    @compiler.step
    def build(factory):
        return factory()

    @compiler.step
    def assemble(network, seed=tpusystem.Depends(seed)):
        optimizer = jtrain.SGD(lr=LR)
        sample = JaxClicks(**CLICKS)[np.arange(2)][0]
        return JaxRecommender(network, jtrain.BCEWithLogitsLoss(), optimizer,
                              jtrain.init_state(network, optimizer, sample,
                                                rng=seed))

    compiler.dependency_overrides[seed] = lambda: SEED
    return compiler.compile(jax_dlrm_tiny)


def _port_model(reference_params):
    compiler = tpusystem_torch.Compiler()

    def device():
        raise NotImplementedError

    def weights():
        raise NotImplementedError

    @compiler.step
    def build(factory, device=tpusystem_torch.Depends(device)):
        return factory(device=device)

    @compiler.step
    def carry(network, weights=tpusystem_torch.Depends(weights)):
        network.load_state_dict(weights)   # no return: network passes on

    @compiler.step
    def assemble(network):
        optimizer = ttrain.SGD(lr=LR)
        return Recommender(network, ttrain.BCEWithLogitsLoss(), optimizer,
                           ttrain.init_state(network, optimizer, rng=SEED))

    compiler.dependency_overrides[device] = lambda: 'cpu'
    compiler.dependency_overrides[weights] = lambda: params_from_jax(
        reference_params)
    return compiler.compile(dlrm_tiny)


def _drive(pkg, model, batches, evaluator, consumer, service, events):
    """One train phase through ``pkg``'s host layers; returns the events'
    names (and whether they carry ``model``) in order, the losses, the
    evaluation, the ledger and the stop verdicts."""
    trained_type, evaluated_type, evaluation_consumer_of = events
    seen, losses = [], []
    with pkg.Runtime(ledger=True) as runtime:
        collector = consumer()
        for kind in (trained_type, evaluated_type):
            collector.register(kind, seen.append)
        runtime.producer.register(collector, evaluation_consumer_of(
            evaluator, producer=runtime.producer, subject=model.id))
        trainer = service()

        @trainer.handler
        def train(model, batches):
            for features, labels in batches:
                losses.append(float(model.fit(features, labels)))
            runtime.producer.dispatch(trained_type(model,
                                                   {'loss': losses[-1]}))
            model.epoch += 1
            runtime.sync()
            return runtime.should_stop(False)

        stop = trainer.handle('train', model, batches)
        model.events.enqueue(StopIteration)
        with pytest.raises(StopIteration):
            model.epoch += 1
        return dict(names=[(type(event).__name__, event.model is model)
                           for event in seen],
                    metrics=seen[-1].metrics, losses=losses, stop=stop,
                    epoch=model.epoch,
                    ledger=(runtime.ledger.count, runtime.ledger.digest),
                    verdict=runtime.should_stop(True))


def test_the_host_slice_trains_and_evaluates_like_the_reference():
    reference = _jax_model()
    port = _port_model(reference.state.params)
    holdout = dict(CLICKS, train=False)
    want = _drive(tpusystem, reference,
                  JaxLoader(JaxClicks(**CLICKS), BATCH, shuffle=True,
                            seed=SEED),
                  JaxEvaluator(reference.network,
                               JaxLoader(JaxClicks(**holdout), BATCH)),
                  JConsumer, JService,
                  (JTrained, JRecsysEvaluated, jax_evaluation_consumer))
    got = _drive(tpusystem_torch, port,
                 Loader(SyntheticClicks(**CLICKS), BATCH, shuffle=True,
                        seed=SEED, device='cpu'),
                 RecsysEvaluator(port.network, Loader(
                     SyntheticClicks(**holdout), BATCH, device='cpu')),
                 Consumer, Service,
                 (Trained, RecsysEvaluated, evaluation_consumer))
    assert got['names'] == want['names'] == [('Trained', True),
                                              ('RecsysEvaluated', True)]
    assert got['ledger'] == want['ledger'] and got['ledger'][0] == 2
    assert len(got['losses']) == 3
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-5,
                               atol=1e-5)
    assert got['losses'][-1] < got['losses'][0]
    assert sorted(got['metrics']) == sorted(want['metrics']) == ['auc',
                                                                'loss']
    assert all(type(value) is float for value in got['metrics'].values())
    assert abs(got['metrics']['loss'] - want['metrics']['loss']) <= 1e-5
    assert abs(got['metrics']['auc'] - want['metrics']['auc']) <= 1 / 512
    for result in (got, want):
        assert result['stop'] is False and result['verdict'] is True
        assert result['epoch'] == 2
    assert port.id == jax_gethash(reference.network)
    assert isinstance(port, torch.nn.Module)
