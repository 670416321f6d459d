"""The LM pretraining system on the port (``examples/lm_torch``).

Twins of ``tests/test_example_lm.py`` (the tiny preset end to end twice,
and from a generated corpus file through ``--corpus``/``--holdout``; slow
as the reference's are, on the CPU), then the two examples side by side:
each package's compiler pipeline builds its ``LanguageModel`` on
``gpt2_tiny`` (float32, sequence 128; the port's from the reference's
initial weights, carried over by ``params_from_jax``), and one epoch of
three train steps (one dispatch of three) and one evaluation step through
each package's service gives the same losses within 1e-5, the same
registry hash and the same experiment-store rows (names, phases, epochs).
"""

from __future__ import annotations

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / 'examples' / 'lm_torch'
REFERENCE = ROOT / 'examples' / 'lm'
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def lm_main(tmp_path, monkeypatch):
    module = _load(EXAMPLE / 'main.py', 'lm_torch_main')
    monkeypatch.setattr(module, 'ROOT', tmp_path)
    return module


@pytest.mark.slow
def test_pretrains_and_resumes(lm_main, capsys):
    lm_main.main(epochs=2, device='cpu')
    out = capsys.readouterr().out
    assert 'from epoch 0' in out

    from tpusystem_torch.storage import (DocumentMetrics, DocumentModels,
                                         DocumentStore)
    store = DocumentStore(lm_main.ROOT / 'experiments.json')
    (model,) = DocumentModels(store).list('lm')
    assert model.epoch == 2
    rows = DocumentMetrics(store).list(model.hash)
    assert {row.name for row in rows} == {'loss', 'perplexity'}
    losses = [row.value for row in rows
              if row.name == 'loss' and row.phase == 'train']
    assert losses[-1] < losses[0]     # bigram structure is learnable
    evals = [row.value for row in rows
             if row.name == 'loss' and row.phase == 'evaluation']
    # holdout shares the bigram table (train=False): learning generalizes
    assert evals[-1] < evals[0]
    store.close()

    lm_main.main(epochs=3, device='cpu')
    out = capsys.readouterr().out
    assert 'from epoch 2' in out
    store = DocumentStore(lm_main.ROOT / 'experiments.json')
    (model,) = DocumentModels(store).list('lm')
    assert model.epoch == 3
    store.close()


def bigram_corpus(tokens, seed):
    """A mostly-deterministic bigram chain (learnable), 10% noise."""
    rng = np.random.default_rng(seed)
    out = np.empty(tokens, np.uint16)
    out[0] = rng.integers(0, 96)
    jumps = rng.random(tokens) < 0.1
    noise = rng.integers(0, 96, tokens)
    for i in range(1, tokens):
        out[i] = noise[i] if jumps[i] else (out[i - 1] * 7 + 3) % 96
    return out


@pytest.mark.slow
def test_pretrains_from_generated_corpus_file(lm_main, tmp_path, capsys):
    """Real-data ingestion end to end: write a binary token corpus to disk,
    train via --corpus/--holdout (MemmapTokens), verify learning on the
    held-out file."""
    corpus = tmp_path / 'train.bin'
    holdout = tmp_path / 'holdout.bin'
    corpus.write_bytes(bigram_corpus(8192, seed=1).tobytes())
    holdout.write_bytes(bigram_corpus(2176, seed=2).tobytes())

    lm_main.main(epochs=2, corpus=str(corpus), holdout_corpus=str(holdout),
                 device='cpu')
    capsys.readouterr()

    from tpusystem_torch.storage import (DocumentMetrics, DocumentModels,
                                         DocumentStore)
    store = DocumentStore(lm_main.ROOT / 'experiments.json')
    (model,) = DocumentModels(store).list('lm')
    assert model.epoch == 2
    rows = DocumentMetrics(store).list(model.hash)
    losses = [row.value for row in rows
              if row.name == 'loss' and row.phase == 'train']
    assert losses[-1] < losses[0]     # the on-disk chain is learnable
    evals = [row.value for row in rows
             if row.name == 'loss' and row.phase == 'evaluation']
    assert evals[-1] < evals[0]       # generalizes to the held-out file
    store.close()


def test_the_full_preset_and_the_mesh_seam(monkeypatch):
    """``--full`` builds the headline recipe, the device comes through the
    mesh seam (the card by default: none here, so it raises and asks for
    the CPU), and a mesh over more than one device is item 9's."""
    lm = _load(EXAMPLE / 'main.py', 'lm_torch_preset')
    from tpusystem_torch.parallel import MeshSpec
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.mesh()
    with pytest.raises(ValueError, match='one process a device'):
        MeshSpec(fsdp=2).build([torch.device('cpu')] * 2)
    placed = MeshSpec(fsdp=-1).build([torch.device('cpu')])
    assert placed.device == torch.device('cpu') and placed.shape['fsdp'] == 1
    assert lm.policy().fsdp and lm.experiment() == 'lm'


# ---------------------------------------------------------------------------
# the two examples side by side
# ---------------------------------------------------------------------------


class Recorded:
    """A package's ``LMMetrics`` that also keeps every step's loss."""

    def __init__(self, metrics):
        self.metrics, self.losses = metrics, []

    def update(self, loss):
        self.losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
        self.metrics.update(loss)

    def compute(self):
        return self.metrics.compute()

    def reset(self):
        self.metrics.reset()


def _epoch(package: str, tmp_path, params=None):
    """One epoch of ``package``'s LM example (``'tpusystem'`` or
    ``'tpusystem_torch'``) on ``gpt2_tiny``: three train steps in one
    dispatch and one evaluation step, a tracking consumer writing the
    experiment store. Returns ((the network's registry hash, the model, its
    initial parameters as numpy), the losses, the metric rows, the model
    rows)."""
    import importlib
    reference = package == 'tpusystem'
    lm = _load((REFERENCE if reference else EXAMPLE) / 'main.py',
               f'{package}_lm_main')
    data = importlib.import_module(f'{package}.data')
    models = importlib.import_module(f'{package}.models')
    observe = importlib.import_module(f'{package}.observe')
    storage = importlib.import_module(f'{package}.storage')
    train = importlib.import_module(f'{package}.train')
    checkpoint = importlib.import_module(f'{package}.checkpoint')
    parallel = importlib.import_module(f'{package}.parallel')

    store = storage.DocumentStore(tmp_path / f'{package}.json')
    weights = checkpoint.Repository(tmp_path / f'{package}-weights',
                                    async_save=False)
    tracker = observe.tracking_consumer()
    tracker.dependency_overrides.update({
        observe.tracking.metrics_store: lambda: storage.DocumentMetrics(store),
        observe.tracking.models_store: lambda: storage.DocumentModels(store),
        observe.tracking.modules_store: lambda: storage.DocumentModules(store),
        observe.tracking.iterations_store:
            lambda: storage.DocumentIterations(store),
        observe.tracking.experiment: lm.experiment,
    })
    lm.producer.register(tracker)
    lm.provider.override(lm.models, lambda: storage.DocumentModels(store))
    lm.provider.override(lm.repository, lambda: weights)
    lm.provider.override(lm.steps_per_dispatch, lambda: 3)
    if reference:
        lm.provider.override(lm.mesh, parallel.single_device_mesh)
        network = models.gpt2_tiny(dtype='float32', return_features=True)
        loader_kwargs = {}
    else:
        lm.provider.override(lm.mesh, lambda: parallel.MeshSpec(
            fsdp=-1).build([torch.device('cpu')]))
        network = models.gpt2_tiny(dtype='float32', return_features=True,
                                   device='cpu')
        network.load_state_dict(params, strict=True)
        loader_kwargs = {'device': 'cpu'}
    identity = importlib.import_module(f'{package}.registry').gethash(network)
    try:
        model = lm.compiler.compile(network, train.ChunkedNextTokenLoss(
            chunks=8), train.AdamW(lr=3e-4, grad_clip=1.0))
        tokens = dict(sequence_length=128, vocab_size=256)
        loaders = {
            'train': data.Loader(data.SyntheticTokens(samples=48, **tokens),
                                 batch_size=16, shuffle=True, seed=0,
                                 **loader_kwargs),
            'evaluation': data.Loader(data.SyntheticTokens(
                samples=16, train=False, **tokens), batch_size=16,
                **loader_kwargs)}
        metrics = Recorded(lm.LMMetrics())
        # before any step, copied: the reference's steps donate the state
        initial = (jax.tree.map(np.array, model.state.params)
                   if reference else None)
        lm.service.handle('iterate', model, loaders, metrics)
        rows = sorted((row.name, row.phase, row.epoch, row.value) for row in
                      storage.DocumentMetrics(store).list(model.id))
        model_rows = [(row.hash, row.epoch) for row in
                      storage.DocumentModels(store).list('lm')]
    finally:
        weights.close()
        store.close()
    return (identity, model, initial), metrics.losses, rows, model_rows


def test_one_epoch_matches_the_reference_example(tmp_path):
    """The port's aggregate id is its network's hash, which equals the
    reference network's. (The reference's ``place`` binds its placement
    mesh into a clone of the network, whose registry arguments are then its
    dataclass fields, so the reference aggregate's id is not its network's
    hash; a one-device port has no mesh to bind.)"""
    from tpusystem_torch.convert import params_from_jax
    (network_id, reference, initial), want, want_rows, want_models = _epoch(
        'tpusystem', tmp_path)
    (port_id, port, _), got, got_rows, got_models = _epoch(
        'tpusystem_torch', tmp_path, params_from_jax(initial))
    assert port.id == port_id == network_id
    assert want_models == [(reference.id, 1)]
    assert got_models == [(port.id, 1)]
    assert len(got) == len(want) == 4          # 3 train steps + 1 eval
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert [row[:3] for row in got_rows] == [row[:3] for row in want_rows]
    assert {row[:2] for row in got_rows} == {
        (name, phase) for name in ('loss', 'perplexity')
        for phase in ('train', 'evaluation')}
    np.testing.assert_allclose([row[3] for row in got_rows],
                               [row[3] for row in want_rows], rtol=TOL,
                               atol=TOL)
