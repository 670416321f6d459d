"""The verybasic slice of the port against the JAX package's.

``MLP``, ``SyntheticDigits`` and ``SyntheticTokens`` run in both packages
on the same numpy inputs on the CPU: the datasets bitwise, the MLP's
identity equal, its dropout masks bitwise (the reference's flax
``make_rng`` keys, drawn by the threefry port), and its loss trajectory
within 1e-5 over 10 steps from the same converted weights and batches.
Then twins of ``tests/test_train_slice.py``'s tests on the port, and the
four ``examples/verybasic_torch`` scripts against ``examples/verybasic``'s.
"""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.data import SyntheticDigits as JaxDigits
from tpusystem.data import SyntheticTokens as JaxTokens
from tpusystem.models import MLP as JaxMLP
from tpusystem.registry import getarguments as jax_getarguments
from tpusystem.registry import gethash as jax_gethash
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.data import Loader, SyntheticDigits, SyntheticTokens
from tpusystem_torch.models import MLP
from tpusystem_torch.ops.attention import dropout_mask
from tpusystem_torch.ops.threefry import as_key, make_rng
from tpusystem_torch.registry import getarguments, gethash

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / 'examples'
TOL = 1e-5
# the examples print losses rounded to 4 places: equal values to 1e-5 may
# still round one unit apart
PRINTED_TOL = 1e-4 + 1e-9


@pytest.fixture(autouse=True, scope='module')
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


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('name', ['digits', 'tokens'])
def test_synthetic_datasets_are_bitwise(name, train):
    if name == 'digits':
        args = dict(samples=300, classes=7, seed=3, noise=0.5, train=train)
        pairs = [(JaxDigits(**args), SyntheticDigits(**args))]
    else:
        args = dict(samples=40, sequence_length=33, vocab_size=97, seed=5,
                    train=train)
        pairs = [(JaxTokens(**args), SyntheticTokens(**args))]
    for reference, port in pairs:
        assert len(port) == len(reference)
        for want, got in zip(reference.arrays, port.arrays):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()


def test_mlp_identity_equals_the_reference():
    for kwargs in ({}, {'features': (64,), 'classes': 10},
                   {'features': (32, 16), 'classes': 3, 'dropout': 0.2}):
        port = MLP(device='cpu', **kwargs)
        assert getarguments(port) == jax_getarguments(JaxMLP(**kwargs))
        assert gethash(port) == jax_gethash(JaxMLP(**kwargs))
    assert gethash(MLP(features=(64,), device='cpu')) != gethash(
        MLP(features=(128,), device='cpu'))


def _pair(features=(64, 32), dropout=0.1, rng=0):
    """The reference MLP, its parameters from ``init_state`` at ``rng``, and
    the port's MLP loaded with them."""
    reference = JaxMLP(features=features, classes=10, dropout=dropout)
    params = jtrain.init_state(reference, jtrain.SGD(),
                               jnp.zeros((1, 28, 28)), rng=rng).params
    port = MLP(features=features, classes=10, dropout=dropout, device='cpu')
    port.load_state_dict(params_from_jax(params), strict=True)
    return reference, params, port


def test_mlp_forward_and_dropout_masks_equal_the_reference():
    reference, params, port = _pair()
    images = np.random.default_rng(0).normal(
        size=(16, 28, 28)).astype(np.float32)
    want = reference.apply({'params': params}, jnp.asarray(images))
    got = port(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    key = jax.random.PRNGKey(7)
    _, captured = reference.apply(
        {'params': params}, jnp.asarray(images), train=True,
        rngs={'dropout': key}, capture_intermediates=True)
    captured = captured['intermediates']
    for index in range(2):
        dense = np.asarray(captured[f'Dense_{index}']['__call__'][0])
        dropped = np.asarray(captured[f'Dropout_{index}']['__call__'][0])
        keep = dropout_mask(dense.shape, 0.1,
                            make_rng(as_key(key), (f'Dropout_{index}',)),
                            'cpu').numpy()
        # the mask is observable where the ReLU passed a value
        np.testing.assert_array_equal(dropped != 0, keep & (dense > 0))
        np.testing.assert_allclose(
            dropped, np.where(keep, np.maximum(dense, 0) / 0.9, 0),
            rtol=TOL, atol=TOL)
    trained = port(torch.from_numpy(images), train=True,
                   rng=as_key(key)).detach().numpy()
    want = reference.apply({'params': params}, jnp.asarray(images),
                           train=True, rngs={'dropout': key})
    np.testing.assert_allclose(trained, np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match='rng'):
        port(torch.from_numpy(images), train=True)


@pytest.mark.parametrize('optimizer', ['SGD', 'Adam', 'AdamW'])
def test_mlp_loss_trajectory_matches_the_reference(optimizer):
    """Ten steps at dropout 0.1 from the same weights, batches and state key:
    every loss within 1e-5, and the parameters after them too."""
    arguments = {'SGD': dict(lr=0.1), 'Adam': dict(lr=1e-3),
                 'AdamW': dict(lr=1e-3, weight_decay=0.01)}[optimizer]
    reference, params, port = _pair(rng=3)
    jax_optimizer = getattr(jtrain, optimizer)(**arguments)
    jax_step = jtrain.build_train_step(jtrain.flax_apply(reference),
                                       jtrain.CrossEntropyLoss(),
                                       jax_optimizer)
    jax_state = jtrain.init_state(reference, jax_optimizer,
                                  jnp.zeros((1, 28, 28)), rng=3)
    port_optimizer = getattr(ttrain, optimizer)(**arguments)
    step = ttrain.build_train_step(ttrain.module_apply(port),
                                   ttrain.CrossEntropyLoss(), port_optimizer)
    state = ttrain.init_state(port, port_optimizer, rng=3)
    data = JaxDigits(samples=320, seed=1)
    for index in range(10):
        images, labels = data[np.arange(index * 32, (index + 1) * 32)]
        jax_state, (_, want) = jax_step(jax_state, jnp.asarray(images),
                                        jnp.asarray(labels))
        state, (_, got) = step(state, torch.from_numpy(images),
                               torch.from_numpy(labels))
        assert abs(float(got) - float(want)) <= TOL, (index, got, want)
    trained = params_from_jax(jax_state.params)
    for name, tensor in state.params.items():
        np.testing.assert_allclose(tensor.detach().numpy(),
                                   trained[name].numpy(), rtol=TOL, atol=TOL)
    assert int(state.step) == int(jax_state.step) == 10


# twins of tests/test_train_slice.py on the port


@pytest.fixture(scope='module')
def slice_setup():
    module = MLP(features=(64,), classes=10, dropout=0.1, device='cpu')
    optimizer = ttrain.Adam(lr=1e-3)
    criterion = ttrain.CrossEntropyLoss()
    apply_fn = ttrain.module_apply(module)
    train_step = ttrain.build_train_step(apply_fn, criterion, optimizer)
    eval_step = ttrain.build_eval_step(apply_fn, criterion)

    def fresh_state(rng=0):
        module.init_weights(torch.Generator().manual_seed(rng))
        return ttrain.init_state(module, optimizer, rng=rng)

    return module, optimizer, fresh_state, train_step, eval_step


def test_registered_module_has_identity():
    module = MLP(features=(64,), classes=10, device='cpu')
    assert getarguments(module) == {'features': (64,), 'classes': 10}
    assert gethash(module) == gethash(MLP(features=(64,), classes=10,
                                          device='cpu'))
    assert gethash(module) != gethash(MLP(features=(128,), classes=10,
                                          device='cpu'))


def test_loss_decreases_over_training(slice_setup):
    _, _, fresh_state, train_step, eval_step = slice_setup
    state = fresh_state(0)
    dataset = SyntheticDigits(samples=512, seed=0)
    loader = Loader(dataset, batch_size=64, shuffle=True, seed=0,
                    device='cpu')
    loss_metric = ttrain.Mean()
    first_epoch_loss = None
    for _ in range(3):
        loss_metric.reset()
        for inputs, targets in loader:
            state, (_, loss) = train_step(state, inputs, targets)
            loss_metric.update(loss)
        epoch_loss = loss_metric.compute()
        if first_epoch_loss is None:
            first_epoch_loss = epoch_loss
    assert epoch_loss < first_epoch_loss * 0.5, (first_epoch_loss, epoch_loss)

    accuracy = ttrain.Accuracy()
    test_set = SyntheticDigits(samples=256, seed=0, train=False)
    for inputs, targets in Loader(test_set, batch_size=64, device='cpu'):
        outputs, _ = eval_step(state, inputs, targets)
        accuracy.update(outputs.argmax(-1), targets)
    assert accuracy.compute() > 0.8


def test_train_step_increments_the_step_counter(slice_setup):
    _, _, fresh_state, train_step, _ = slice_setup
    state = fresh_state(1)
    inputs = torch.zeros((8, 28, 28))
    targets = torch.zeros((8,), dtype=torch.int32)
    state, _ = train_step(state, inputs, targets)
    state, _ = train_step(state, inputs, targets)
    assert int(state.step) == 2


def test_eval_step_is_deterministic(slice_setup):
    _, _, fresh_state, _, eval_step = slice_setup
    state = fresh_state(2)
    inputs = torch.ones((4, 28, 28))
    targets = torch.zeros((4,), dtype=torch.int32)
    first, _ = eval_step(state, inputs, targets)
    second, _ = eval_step(state, inputs, targets)
    assert torch.equal(first, second)


# the examples: each twin prints what the reference script prints


@pytest.mark.parametrize('script', ['events', 'prodcon', 'pubsub'])
def test_bus_example_twins_print_what_the_reference_prints(script, capsys):
    _load(EXAMPLES / 'verybasic' / f'{script}.py', f'jax_{script}').main()
    want = capsys.readouterr().out
    _load(EXAMPLES / 'verybasic_torch' / f'{script}.py',
          f'torch_{script}').main()
    assert capsys.readouterr().out == want
    assert want


def _epochs(text: str) -> list:
    lines = text.strip().splitlines()
    assert [re.sub(r'loss=.*', '', line) for line in lines] == [
        f'epoch {epoch}: ' for epoch in range(3)]
    return [float(line.split('loss=')[1]) for line in lines]


def test_train_example_twin_prints_the_reference_losses(capsys,
                                                        monkeypatch):
    """From the reference's initial weights (the twin's MLP is loaded with
    them), the twin trains through the same batches and dropout keys and
    prints the same three epoch losses to the printed precision."""
    _load(EXAMPLES / 'verybasic' / 'train.py', 'jax_train').main()
    want = _epochs(capsys.readouterr().out)
    reference = JaxMLP(features=(128,), classes=10)
    params = jtrain.init_state(reference, jtrain.Adam(lr=1e-3),
                               jnp.zeros((1, 28, 28))).params
    twin = _load(EXAMPLES / 'verybasic_torch' / 'train.py', 'torch_train')

    def loaded(**kwargs):
        module = MLP(**kwargs)
        module.load_state_dict(params_from_jax(params), strict=True)
        return module

    monkeypatch.setattr(twin, 'MLP', loaded)
    losses = twin.main(device='cpu')
    got = _epochs(capsys.readouterr().out)
    assert got == [float(f'{loss:.4f}') for loss in losses]
    assert losses[0] > losses[1] > losses[2]
    for got_loss, want_loss in zip(got, want):
        assert abs(got_loss - want_loss) <= PRINTED_TOL, (got, want)
