"""The port's training slice against the JAX package's, on the CPU.

Losses, optimizers and the train step take the same seeded numpy inputs in
both packages; the JAX params of ``gpt2_tiny`` cross through
``params_from_jax``, and the JAX flash attention runs in interpret mode. In
float32 the two differ by summation order and by the last bit of a few
transcendentals: loss values and grads agree at ``rtol = atol = 1e-5``
(grads of a model within ``1e-5`` of the largest), optimizer updates at
``rtol = 1e-6`` (their float32 arithmetic is the same, operation for
operation, apart from the global norm's and the bias correction's last
bit). Registry digests agree bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.ops.precision import head_logits as jax_head_logits
from tpusystem.registry import gethash as jax_gethash
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.ops.cuda import flash as tflash
from tpusystem_torch.ops.precision import head_logits
from tpusystem_torch.registry import gethash

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _flat(tree) -> dict:
    return {name: tensor.numpy() for name, tensor in
            params_from_jax(tree).items()}


# --- losses -------------------------------------------------------------

@pytest.mark.parametrize('tied', [True, False, None])
@pytest.mark.parametrize('z_loss', [0.0, 1e-3])
def test_chunked_loss_value_and_grads_match_jax(tied, z_loss):
    """Padding ids (< 0) masked, and 5 chunks that do not divide the
    2 x 12 rows (one masked pad row)."""
    rng = np.random.default_rng(5)
    features = rng.standard_normal((2, 13, 16)).astype(np.float32)
    table = (rng.standard_normal((40, 16) if tied in (True, None)
                                 else (16, 40)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, 40, (2, 13))
    tokens[0, 9:] = -1
    tokens[1, 4] = -1
    reference = jtrain.ChunkedNextTokenLoss(chunks=5, z_loss=z_loss,
                                            tied=tied)
    want, want_grads = jax.value_and_grad(
        lambda f, t: reference((f, t), jnp.asarray(tokens)),
        argnums=(0, 1))(jnp.asarray(features), jnp.asarray(table))
    port = ttrain.ChunkedNextTokenLoss(chunks=5, z_loss=z_loss, tied=tied)
    leaves = [torch.tensor(features, requires_grad=True),
              torch.tensor(table, requires_grad=True)]
    got = port(tuple(leaves), torch.as_tensor(tokens))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert port.weight(torch.as_tensor(tokens)).item() == float(
        reference.weight(jnp.asarray(tokens)))


@pytest.mark.parametrize('name,make_inputs', [
    ('CrossEntropyLoss', lambda r: (r.standard_normal((6, 9)),
                                    r.integers(0, 9, (6,)))),
    ('MSELoss', lambda r: (r.standard_normal((6, 3)),
                           r.standard_normal((6, 3)))),
    ('BCEWithLogitsLoss', lambda r: (r.standard_normal((6,)) * 3,
                                     r.integers(0, 2, (6,)).astype(float))),
    ('NextTokenLoss', lambda r: (r.standard_normal((2, 7, 11)),
                                 np.where(r.random((2, 7)) < 0.2, -1,
                                          r.integers(0, 11, (2, 7))))),
])
def test_plain_losses_match_jax(name, make_inputs):
    rng = np.random.default_rng(6)
    prediction, target = make_inputs(rng)
    prediction = prediction.astype(np.float32)
    if target.dtype.kind == 'f':
        target = target.astype(np.float32)
    options = ({'label_smoothing': 0.1} if name == 'CrossEntropyLoss'
               else {'z_loss': 1e-3} if name == 'NextTokenLoss' else {})
    for kwargs in ({}, options):
        want = getattr(jtrain, name)(**kwargs)(jnp.asarray(prediction),
                                               jnp.asarray(target))
        got = getattr(ttrain, name)(**kwargs)(torch.tensor(prediction),
                                              torch.tensor(target))
        np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_head_logits_infers_the_orientation_and_refuses_a_square_table():
    rng = np.random.default_rng(7)
    features = rng.standard_normal((3, 8)).astype(np.float32)
    for table in (rng.standard_normal((20, 8)), rng.standard_normal((8, 20))):
        table = table.astype(np.float32)
        want = jax_head_logits(jnp.asarray(features), jnp.asarray(table))
        got = head_logits(torch.tensor(features), torch.tensor(table))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match='square'):
        head_logits(torch.zeros(3, 8), torch.zeros(8, 8))


# --- optimizers ---------------------------------------------------------

OPTIMIZERS = [
    ('SGD', dict(lr=0.1)),
    ('SGD', dict(lr=0.1, momentum=0.9)),
    ('SGD', dict(lr=0.1, momentum=0.9, nesterov=True)),
    ('Adam', dict(lr=1e-2)),
    ('AdamW', dict(lr=1e-2)),
    ('AdamW', dict(lr=1e-2, grad_clip=1.0)),             # clip triggers
    ('AdamW', dict(lr=1e-2, grad_clip=100.0)),           # clip idle
    ('AdamW', dict(lr=1e-2, grad_clip=1.0, warmup_steps=3)),
    ('AdamW', dict(lr=1e-2, warmup_steps=3, decay_steps=8)),
    ('AdamW', dict(lr=1e-2, decay_steps=6, min_lr_ratio=0.3)),
]


@pytest.mark.parametrize('name,kwargs', OPTIMIZERS)
def test_optimizer_updates_match_optax(name, kwargs):
    """Ten updates of a random tree with fresh random grads each step."""
    rng = np.random.default_rng(8)
    shapes = {'dense': (5, 4), 'bias': (4,), 'scale': (3, 2, 2)}
    params = {key: rng.standard_normal(shape).astype(np.float32)
              for key, shape in shapes.items()}
    reference = getattr(jtrain, name)(**kwargs)
    transform = reference.transform()
    jparams = {key: jnp.asarray(value) for key, value in params.items()}
    jstate = transform.init(jparams)
    port = getattr(ttrain, name)(**kwargs)
    tparams = {key: torch.tensor(value) for key, value in params.items()}
    tstate = port.init(tparams)
    for step in range(10):
        grads = {key: (rng.standard_normal(shape) * 2).astype(np.float32)
                 for key, shape in shapes.items()}
        updates, jstate = transform.update(
            {key: jnp.asarray(value) for key, value in grads.items()},
            jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.step(tparams, {key: torch.tensor(value)
                            for key, value in grads.items()}, tstate)
        for key in shapes:
            np.testing.assert_allclose(tparams[key].numpy(),
                                       np.asarray(jparams[key]),
                                       rtol=1e-6, atol=1e-7)
        if step == 0 and kwargs.get('warmup_steps'):
            for key in shapes:        # a warmup from 0: the first update is 0
                np.testing.assert_array_equal(tparams[key].numpy(),
                                              params[key])
    assert int(tstate['count']) == 10


def test_clip_by_global_norm_is_optax_exactly():
    rng = np.random.default_rng(9)
    grads = [rng.standard_normal(shape).astype(np.float32)
             for shape in ((7, 3), (5,))]
    for max_norm in (0.5, 50.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = ttrain.optim.clip_by_global_norm(
            [torch.tensor(g) for g in grads], max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize('instance', [
    "CrossEntropyLoss()", "CrossEntropyLoss(label_smoothing=0.1)",
    "MSELoss()", "BCEWithLogitsLoss()", "NextTokenLoss(z_loss=1e-4)",
    "ChunkedNextTokenLoss(chunks=8)", "ChunkedNextTokenLoss(8, 0.0, True)",
    "SGD(lr=0.1, momentum=0.9)", "Adam()", "AdamW(lr=3e-4, grad_clip=1.0)",
    "AdamW(3e-4, 0.9, 0.95, warmup_steps=100, decay_steps=1000)",
])
def test_registry_digests_match_the_reference(instance):
    assert (gethash(eval(instance, vars(ttrain)))
            == jax_gethash(eval(instance, vars(jtrain))))


# --- the slice ----------------------------------------------------------

def _jax_run(module, criterion, optimizer, batches, *, accumulate=1):
    """Params before the first step, first-step grads and per-step losses
    of the reference's build_train_step."""
    state = jtrain.init_state(module, optimizer,
                              jnp.asarray(batches[0][0], jnp.int32), rng=0)
    params = jax.tree.map(np.asarray, state.params)
    apply = jtrain.flax_apply(module)

    def objective(params, inputs, targets):
        return criterion(apply(params, inputs, None, True), targets)

    grads = jax.grad(objective)(state.params,
                                *(jnp.asarray(a) for a in batches[0]))
    step = jtrain.build_train_step(apply, criterion, optimizer,
                                   accumulate=accumulate)
    losses = []
    for inputs, targets in batches:
        state, (_, loss) = step(state, jnp.asarray(inputs, jnp.int32),
                                jnp.asarray(targets, jnp.int32))
        losses.append(float(loss))
    return params, jax.tree.map(np.asarray, grads), losses


def _port_model(params, **overrides):
    module = gpt2_tiny(dtype='float32', device='cpu', **overrides)
    module.load_state_dict(params_from_jax(params))
    return module


@pytest.fixture(scope='module')
def flash_slice():
    """3 AdamW steps of gpt2_tiny(attention='flash', return_features=True)
    with the chunked loss, in the reference."""
    tokens = _tokens(10, (2, 32))
    module = jax_gpt2_tiny(dtype='float32', attention='flash',
                           return_features=True)
    run = _jax_run(module, jtrain.ChunkedNextTokenLoss(chunks=4),
                   jtrain.AdamW(grad_clip=1.0), [(tokens, tokens)] * 3)
    return tokens, run


def test_gpt2_flash_train_steps_match_jax(flash_slice):
    tokens, (params, jax_grads, jax_losses) = flash_slice
    module = _port_model(params, attention='flash', return_features=True)
    criterion = ttrain.ChunkedNextTokenLoss(chunks=4)
    optimizer = ttrain.AdamW(grad_clip=1.0)
    state = ttrain.init_state(module, optimizer)
    apply = ttrain.module_apply(module)
    batch = torch.as_tensor(tokens)
    loss = criterion(apply(state.params, batch, None, True), batch)
    grads = dict(zip(state.params, torch.autograd.grad(
        loss, list(state.params.values()))))
    want = _flat(jax_grads)
    scale = max(np.abs(g).max() for g in want.values())
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    step = ttrain.build_train_step(apply, criterion, optimizer)
    launches = tflash.flash_attention_lse.launches
    losses = []
    for _ in range(3):
        state, (outputs, loss) = step(state, batch, batch)
        losses.append(loss.item())
    assert tflash.flash_attention_lse.launches == launches     # CPU: plain
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert int(state.step) == 3 and losses[-1] < losses[0]
    features, table = outputs
    assert features.shape == (2, 32, 64) and table.shape == (256, 64)


@pytest.mark.parametrize('name,kwargs', [
    ('SGD', dict(lr=0.5, momentum=0.9)), ('Adam', dict(lr=3e-3)),
    ('AdamW', dict(lr=3e-3, grad_clip=1.0, warmup_steps=2, decay_steps=8)),
])
def test_gpt2_loss_trajectories_match_jax(name, kwargs):
    """Ten steps on fresh batches at attention='xla' with the full-logits
    loss; trajectories agree at rtol 1e-5."""
    batches = [(tokens, tokens) for tokens in
               (_tokens(20 + index, (2, 24)) for index in range(10))]
    module = jax_gpt2_tiny(dtype='float32')
    params, _, jax_losses = _jax_run(module, jtrain.NextTokenLoss(),
                                     getattr(jtrain, name)(**kwargs), batches)
    port = _port_model(params)
    optimizer = getattr(ttrain, name)(**kwargs)
    state = ttrain.init_state(port, optimizer)
    step = ttrain.build_train_step(ttrain.module_apply(port),
                                   ttrain.NextTokenLoss(), optimizer)
    losses = [step(state, torch.as_tensor(inputs),
                   torch.as_tensor(targets))[1][1].item()
              for inputs, targets in batches]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_accumulate_two_equals_the_full_batch():
    """Padding gives the two microbatches different token counts; the
    token-weighted accumulation still equals the full-batch step. SGD keeps
    the update linear in the grads (Adam would magnify the float32
    rounding of near-zero grads); sums in another order: rtol 1e-5 on
    params, 1e-6 on the loss."""
    inputs = _tokens(30, (4, 20))
    targets = inputs.copy()
    targets[0, 5:] = -1
    targets[1, 12:] = -1
    params = jax_gpt2_tiny(dtype='float32').init(
        jax.random.PRNGKey(1), jnp.asarray(inputs, jnp.int32))['params']
    results = []
    for accumulate in (1, 2):
        module = _port_model(params, return_features=True)
        optimizer = ttrain.SGD(lr=0.5)
        state = ttrain.init_state(module, optimizer)
        step = ttrain.build_train_step(
            ttrain.module_apply(module), ttrain.ChunkedNextTokenLoss(chunks=3),
            optimizer, accumulate=accumulate)
        state, (_, loss) = step(state, torch.as_tensor(inputs),
                                torch.as_tensor(targets))
        results.append((loss.item(), {name: leaf.detach().clone()
                                      for name, leaf in state.params.items()}))
    (full_loss, full), (micro_loss, micro) = results
    np.testing.assert_allclose(micro_loss, full_loss, rtol=1e-6)
    for name in full:
        np.testing.assert_allclose(micro[name].numpy(), full[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_eval_step_matches_jax():
    tokens = _tokens(40, (2, 16))
    module = jax_gpt2_tiny(dtype='float32')
    params = module.init(jax.random.PRNGKey(2),
                         jnp.asarray(tokens, jnp.int32))['params']
    state = jtrain.TrainState.create(params, None)
    _, want = jtrain.build_eval_step(jtrain.flax_apply(module),
                                     jtrain.NextTokenLoss())(
        state, jnp.asarray(tokens, jnp.int32), jnp.asarray(tokens, jnp.int32))
    port = _port_model(params)
    port_state = ttrain.init_state(port, ttrain.SGD())
    outputs, got = ttrain.build_eval_step(ttrain.module_apply(port),
                                          ttrain.NextTokenLoss())(
        port_state, torch.as_tensor(tokens), torch.as_tensor(tokens))
    assert not outputs.requires_grad
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_return_features_match_jax():
    tokens = _tokens(50, (2, 12))
    module = jax_gpt2_tiny(dtype='float32', return_features=True)
    params = module.init(jax.random.PRNGKey(3),
                         jnp.asarray(tokens, jnp.int32))['params']
    want_features, want_table = module.apply({'params': params},
                                             jnp.asarray(tokens, jnp.int32))
    features, table = _port_model(params, return_features=True)(
        torch.as_tensor(tokens), train=True)
    np.testing.assert_allclose(features.detach().numpy(),
                               np.asarray(want_features), **TOL)
    np.testing.assert_array_equal(table.detach().numpy(),
                                  np.asarray(want_table))


def test_unported_training_options_name_their_roadmap_item():
    module = gpt2_tiny(dtype='float32', device='cpu')
    apply, criterion = ttrain.module_apply(module), ttrain.NextTokenLoss()
    optimizer = ttrain.SGD()
    for option in ({'guard': object()}, {'fault': object()}):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            ttrain.build_train_step(apply, criterion, optimizer, **option)
    for builder in (ttrain.build_multi_step, ttrain.build_1f1b_train_step):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            builder(None)
    state = ttrain.init_state(module, optimizer)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        state.health
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ttrain.TrainState.create(state.params, {}, health=object())
    assert state.step.dtype == torch.int32 and state.global_step == 0
