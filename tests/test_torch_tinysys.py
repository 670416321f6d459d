"""The tinysys application on the port (``examples/tinysys_torch``).

Twins of ``tests/test_example_tinysys.py`` (the end-to-end run twice, slow
as the reference's is, on the CPU; the early-stop ``Iterated`` drill), then
the two examples side by side: each package's compiler pipeline builds its
``Classifier`` (the port's from the reference's initial weights, carried
over by ``params_from_jax``), and one epoch of three train steps and one
evaluation step through each package's ``training`` service gives the same
losses within 1e-5, the same registry hash and the same experiment-store
rows (names, phases, epochs).
"""

from __future__ import annotations

import importlib.util
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / 'examples' / 'tinysys_torch'
REFERENCE = ROOT / 'examples' / 'tinysys'
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def tinysys_main(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(EXAMPLE))
    spec = importlib.util.spec_from_file_location('tinysys_torch_main',
                                                  EXAMPLE / 'main.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, 'ROOT', tmp_path)
    return module


@pytest.mark.slow
def test_trains_tracks_and_resumes(tinysys_main, capsys):
    tinysys_main.main(epochs=2, device='cpu')
    out = capsys.readouterr().out
    assert 'from epoch 0' in out

    store_path = tinysys_main.ROOT / 'experiments.json'
    assert store_path.exists()

    from tpusystem_torch.storage import (DocumentMetrics, DocumentModels,
                                         DocumentStore)
    store = DocumentStore(store_path)
    models = DocumentModels(store).list('default')
    assert len(models) == 1 and models[0].epoch == 2
    rows = DocumentMetrics(store).list(models[0].hash)
    assert {row.name for row in rows} == {'loss', 'accuracy'}
    assert any(row.phase == 'evaluation' for row in rows)

    checkpoints = list((tinysys_main.ROOT / 'weights').iterdir())
    assert len(checkpoints) == 1  # one identity directory

    # --- second run resumes at the stored epoch, trains the remainder -----
    tinysys_main.main(epochs=3, device='cpu')
    out = capsys.readouterr().out
    assert 'from epoch 2' in out
    store = DocumentStore(store_path)
    models = DocumentModels(store).list('default')
    assert models[0].epoch == 3


def test_early_stop_epoch_still_dispatches_iterated(monkeypatch):
    """The epoch edge may unwind an early-stop exception; the Iterated event
    (store-row advance + checkpoint) must go out regardless — the stopping
    epoch is the one most worth keeping."""
    monkeypatch.syspath_prepend(str(EXAMPLE))
    from tinysys_torch.services import training
    from tpusystem_torch.observe.events import Iterated

    class StopModel:
        id = 'stop-model'

        def __init__(self):
            object.__setattr__(self, 'epoch', 0)
            object.__setattr__(self, 'phase', None)

        def shard_batch(self, batch):
            return batch

        def fit(self, inputs, targets):
            return targets, 0.0

        def evaluate(self, inputs, targets):
            return targets, 0.0

        def __setattr__(self, key, value):
            object.__setattr__(self, key, value)
            if key == 'epoch' and value > 0:
                raise StopIteration   # the aggregate's commit() unwinding

    class Metrics:
        def update(self, *parts):
            pass

        def compute(self):
            return {}

        def reset(self):
            pass

    events = []
    monkeypatch.setattr(training, 'producer',
                        types.SimpleNamespace(dispatch=events.append))
    model = StopModel()
    loaders = {'train': [((0,), (0,))], 'evaluation': [((0,), (0,))]}
    with pytest.raises(StopIteration):
        training.iterate(model, loaders, Metrics())
    assert model.epoch == 1
    assert any(isinstance(event, Iterated) for event in events)


def test_the_classifier_satisfies_the_model_protocol(monkeypatch):
    monkeypatch.syspath_prepend(str(EXAMPLE))
    from tinysys_torch.classifier import Classifier
    from tinysys_torch.domain import Model
    from tpusystem_torch.models import MLP
    from tpusystem_torch.train import Adam, CrossEntropyLoss
    classifier = Classifier(MLP(features=(8,), device='cpu'),
                            CrossEntropyLoss(), Adam())
    assert isinstance(classifier, Model) and isinstance(classifier,
                                                        torch.nn.Module)
    assert set(classifier.modules()) == {'nn', 'criterion', 'optimizer'}


# ---------------------------------------------------------------------------
# the two examples side by side
# ---------------------------------------------------------------------------


class Recorded:
    """A package's ``ClassifierMetrics`` that also keeps every batch's
    losses as numpy."""

    def __init__(self, metrics):
        self.metrics, self.losses = metrics, []

    def update(self, loss, predictions, targets):
        self.losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
        self.metrics.update(loss, predictions, targets)

    def compute(self):
        return self.metrics.compute()

    def reset(self):
        self.metrics.reset()


def _epoch(package: str, monkeypatch, tmp_path, dispatch: int, params=None):
    """One epoch of ``package``'s example (``'tinysys'`` or
    ``'tinysys_torch'``): its compiler builds the classifier (the MLP of
    ``main.py`` at a narrower width) on one device, and its service runs
    three train steps and one evaluation step, a tracking consumer writing
    the experiment store. Returns ((classifier, its initial parameters),
    the steps' losses, the metric rows, the model rows, the module rows)."""
    import importlib
    reference = package == 'tinysys'
    root = 'tpusystem' if reference else 'tpusystem_torch'
    monkeypatch.syspath_prepend(str(REFERENCE if reference else EXAMPLE))
    compilation = importlib.import_module(f'{package}.services.compilation')
    training = importlib.import_module(f'{package}.services.training')
    metrics_module = importlib.import_module(f'{package}.metrics')
    data = importlib.import_module(f'{root}.data')
    models = importlib.import_module(f'{root}.models')
    observe = importlib.import_module(f'{root}.observe')
    storage = importlib.import_module(f'{root}.storage')
    train = importlib.import_module(f'{root}.train')
    checkpoint = importlib.import_module(f'{root}.checkpoint')
    parallel = importlib.import_module(f'{root}.parallel')

    store = storage.DocumentStore(tmp_path / f'{package}.json')
    repository = checkpoint.Repository(tmp_path / f'{package}-weights',
                                       async_save=False)
    tracker = observe.tracking_consumer()
    tracker.dependency_overrides.update({
        observe.tracking.metrics_store: lambda: storage.DocumentMetrics(store),
        observe.tracking.models_store: lambda: storage.DocumentModels(store),
        observe.tracking.modules_store: lambda: storage.DocumentModules(store),
        observe.tracking.iterations_store:
            lambda: storage.DocumentIterations(store),
    })
    producer = importlib.import_module(f'{root}.services').Producer()
    producer.register(tracker)
    monkeypatch.setattr(training, 'producer', producer)
    overrides = {
        compilation.models: lambda: storage.DocumentModels(store),
        compilation.repository: lambda: repository,
        compilation.batch_size: lambda: 64,
    }
    if reference:
        overrides[compilation.mesh] = parallel.single_device_mesh
        network = models.MLP(features=(32,), classes=10, dropout=0.1)
        loader_kwargs = {}
    else:
        overrides[compilation.mesh] = lambda: parallel.MeshSpec(
            data=-1).build([torch.device('cpu')])
        network = models.MLP(features=(32,), classes=10, dropout=0.1,
                             device='cpu')
        network.load_state_dict(params, strict=True)
        loader_kwargs = {'device': 'cpu'}
    training.provider.override(training.steps_per_dispatch,
                               lambda: dispatch)
    for dependency, override in overrides.items():
        compilation.provider.override(dependency, override)
    try:
        classifier = compilation.compiler.compile(
            network, train.CrossEntropyLoss(), train.Adam(lr=1e-3))
        loaders = {
            'train': data.Loader(data.SyntheticDigits(samples=192),
                                 batch_size=64, shuffle=True, seed=1,
                                 **loader_kwargs),
            'evaluation': data.Loader(
                data.SyntheticDigits(samples=64, train=False),
                batch_size=64, **loader_kwargs)}
        metrics = Recorded(metrics_module.ClassifierMetrics())
        # before any step, copied: the reference's steps donate the state
        initial = (jax.tree.map(np.array, classifier.state.params)
                   if reference else None)
        training.service.handle('iterate', classifier, loaders, metrics)
        rows = sorted((row.name, row.phase, row.epoch, row.value) for row in
                      storage.DocumentMetrics(store).list(classifier.id))
        model_rows = [(row.hash, row.epoch) for row in
                      storage.DocumentModels(store).list('default')]
        modules = sorted((row.kind, row.name, row.hash) for row in
                         storage.DocumentModules(store).list(classifier.id))
    finally:
        training.provider.override(training.steps_per_dispatch,
                                   training.steps_per_dispatch)
        for dependency in overrides:
            compilation.provider.override(dependency, dependency)
        repository.close()
        store.close()
    return (classifier, initial), metrics.losses, rows, model_rows, modules


@pytest.mark.parametrize('dispatch', [1, 3])
def test_one_epoch_matches_the_reference_example(monkeypatch, tmp_path,
                                                 dispatch):
    from tpusystem_torch.convert import params_from_jax
    (reference, initial), want, want_rows, want_models, want_modules = \
        _epoch('tinysys', monkeypatch, tmp_path, dispatch)
    (port, _), got, got_rows, got_models, got_modules = _epoch(
        'tinysys_torch', monkeypatch, tmp_path, dispatch,
        params_from_jax(initial))
    assert port.id == reference.id
    assert got_models == want_models == [(port.id, 1)]
    assert got_modules == want_modules
    assert len(got) == len(want) == 4          # 3 train steps + 1 eval
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert [row[:3] for row in got_rows] == [row[:3] for row in want_rows]
    assert {row[:2] for row in got_rows} == {
        (name, phase) for name in ('loss', 'accuracy')
        for phase in ('train', 'evaluation')}
    np.testing.assert_allclose([row[3] for row in got_rows],
                               [row[3] for row in want_rows], rtol=0,
                               atol=TOL)
