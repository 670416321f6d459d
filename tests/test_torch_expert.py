"""Twins of ``tests/test_moe.py``'s expert-parallel tests (``:77``,
``:171``, ``:210``, ``:251``, ``:276``, ``:315``) and of the ``moe=`` arm of
``tests/test_schedule.py`` (``:740``, ``:762``): the port's
``MoEMLP`` on a mesh of ranks (the quota, ragged and emulated exchanges,
the dense fallback, the overlap schedule) and GPT-2 over an ``expert``
axis, against the JAX package.

The multi-rank cases run in one world of eight port processes
(``tests/torch_ranks.py``'s ``expert`` scenario, gloo on the CPU) on the
reference tests' meshes; the reference side runs here on the virtual
devices from the same numpy weights, and each twin holds the port to the
reference test's tolerance: outputs within 2e-5, the router loss within
1e-5 relative, gradients within 5e-5 in float32. The overlap twins hold
the port to those tests' docstrings on its own (overlap equal to one-shot
bit for bit in loss at ample capacity; ragged under ``moe='overlap'``
equal to ragged one-shot) and the scheduled layer to the reference's
``MoEMLP``; no model-level reference step runs (ROADMAP queue 3 lists the
reference tests as red or flaky).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusystem import parallel as jpar
from tpusystem import train as jtrain
from tpusystem.models import GPT2 as JaxGPT2
from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.ops import MoEMLP as JaxMoEMLP

from tests import torch_ranks

RANKS = 8
OUT, AUX, GRAD = dict(atol=2e-5), dict(rtol=1e-5), dict(atol=5e-5)


def jmesh(**sizes):
    count = int(np.prod(list(sizes.values())))
    return jpar.MeshSpec(**sizes).build(jax.devices()[:count])


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _layer(hidden, mesh, seed=0, **config):
    """The reference layer's params, output, aux and ``mean(out^2) + aux``
    gradients."""
    module = JaxMoEMLP(dtype=jnp.float32, mesh=mesh, **config)
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), hidden)['params']
    out, aux = jax.jit(module.apply)({'params': params}, hidden)

    def loss(p):
        out, aux = module.apply({'params': p}, hidden)
        return jnp.mean(out ** 2) + aux
    grads = jax.jit(jax.grad(loss))(params)
    return dict(params=_numpy(params), out=np.asarray(out), aux=float(aux),
                grads=_numpy(grads))


def _skew():
    """``test_ragged_seats_tokens_the_quota_path_drops``'s skewed batch and
    pinned router."""
    dim, rows = 8, 16
    features = np.zeros((rows, dim), np.float32)
    features[:rows // 2, 1] = 1.0
    features[rows // 2:, 0] = 1.0
    features += 0.01 * np.random.default_rng(0).normal(size=features.shape)
    router = np.zeros((dim, 2), np.float32)
    router[0, 0] = router[1, 1] = 20.0
    return features.reshape(2, rows // 2, dim).astype(np.float32), router


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('expert')
    cases, reference = {}, {}

    mesh = jmesh(data=2, expert=4)
    model = JaxGPT2(vocab_size=64, layers=2, dim=32, heads=4, max_seq=32,
                    dropout=0.0, dtype='float32', moe_experts=4, moe_every=2,
                    moe_k=2, mesh=mesh)
    tokens = np.random.default_rng(0).integers(0, 64, (8, 16))
    optimizer = jtrain.AdamW(lr=1e-2)
    state = jtrain.init_state(model, optimizer, jnp.asarray(tokens[:2]),
                              rng=0)
    cases['train'] = dict(params=_numpy(state.params), tokens=tokens)
    state = jpar.ShardingPolicy(rules=JaxGPT2.partition_rules()).place(
        state, mesh)
    step = jtrain.build_train_step(jtrain.flax_apply(model),
                                   jtrain.WithAuxLoss(jtrain.NextTokenLoss()),
                                   optimizer)
    placed = jax.device_put(jnp.asarray(tokens), jpar.batch_sharding(mesh))
    losses = []
    for _ in range(4):
        state, (_, loss) = step(state, placed, placed)
        losses.append(float(loss))
    reference['train'] = losses

    hidden = jax.random.normal(jax.random.PRNGKey(2), (8, 16, 32))
    dense = _layer(hidden, jmesh(data=2, expert=2), experts=4, k=2,
                   capacity_factor=4.0, dispatch='dense')
    cases['layer'] = dict(params=dense['params'], hidden=np.asarray(hidden))
    reference['layer'] = dense

    hidden = jax.random.normal(jax.random.PRNGKey(7), (4, 16, 32))
    drops = _layer(hidden, jmesh(expert=2), experts=4, k=2,
                   capacity_factor=0.75, dispatch='dense')
    cases['drops'] = dict(params=drops['params'], hidden=np.asarray(hidden))
    reference['drops'] = drops

    features, router = _skew()
    duo = jmesh(expert=2)
    skew_params = None
    for name, dispatch, exchange in (('dense', 'dense', 'quota'),
                                     ('quota', 'sparse', 'quota'),
                                     ('ragged', 'sparse', 'ragged-emulated')):
        module = JaxMoEMLP(experts=2, k=1, capacity_factor=1.0,
                           dtype=jnp.float32, mesh=duo, dispatch=dispatch,
                           exchange=exchange)
        params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(features))['params']
        params = dict(params, router=jnp.asarray(router))
        skew_params = _numpy(params)
        reference[f'skew_{name}'] = np.asarray(jax.jit(module.apply)(
            {'params': params}, jnp.asarray(features))[0])
    cases['skew'] = dict(params=skew_params, hidden=features)

    hidden = jax.random.normal(jax.random.PRNGKey(3), (8, 16, 32))
    module = JaxMoEMLP(experts=4, dtype=jnp.float32,
                       mesh=jmesh(data=2, expert=2, model=2),
                       dispatch='auto')
    params = jax.jit(module.init)(jax.random.PRNGKey(0), hidden)['params']
    cases['guards'] = dict(params=_numpy(params), hidden=np.asarray(hidden))
    reference['auto'] = np.asarray(jax.jit(module.apply)(
        {'params': params}, hidden)[0])

    tokens = np.random.default_rng(0).integers(0, 256, (8, 32))
    module = jax_gpt2_tiny(dim=64, heads=4, moe_experts=2, moe_every=2,
                           moe_capacity_factor=2.0, dtype='float32')
    params = jtrain.init_state(module, jtrain.AdamW(lr=1e-3),
                               jnp.asarray(tokens[:1]), rng=0).params
    hidden = jax.random.normal(jax.random.PRNGKey(4), (8, 32, 64))
    layer = JaxMoEMLP(experts=2, k=2, capacity_factor=2.0, dtype=jnp.float32,
                      mesh=jmesh(data=2, expert=2), dispatch='sparse',
                      schedule=jpar.OverlapSchedule(moe='overlap'))
    layer_params = jax.jit(layer.init)(jax.random.PRNGKey(5),
                                       hidden)['params']
    reference['schedule'] = np.asarray(jax.jit(layer.apply)(
        {'params': layer_params}, hidden)[0])
    cases['schedule'] = dict(
        params=_numpy(params), tokens=tokens,
        tokens1=np.random.default_rng(1).integers(0, 256, (8, 32)),
        layer_params=_numpy(layer_params), layer_hidden=np.asarray(hidden))

    ranks = torch_ranks.launch(root, dict(scenarios=['expert'],
                                          expert=cases), RANKS)
    return dict(reference=reference, ranks=[rank['expert'] for rank in ranks])


def _rows(value, rank, data_ranks=2, per=4):
    """Data rank ``rank``'s rows of a reference batch."""
    return value[rank * per:(rank + 1) * per] if data_ranks > 1 else value


def test_moe_gpt2_expert_parallel_train_step(world):
    """Twin of ``test_moe.py:77`` over data=2 x expert=4 (eight ranks):
    each rank holds one expert of each stack, the logits are its rows, and
    the four AdamW losses are the reference's within 1e-5 (and fall)."""
    want = world['reference']['train']
    for rank, found in enumerate(world['ranks']):
        got = found['train']
        assert got['axes'][0] == ('expert',)
        assert got['piece'] == (1, 32, 128)
        assert got['logits'] == (4, 16, 64)
        assert all(np.isfinite(got['losses']))
        np.testing.assert_allclose(got['losses'], want, rtol=1e-5,
                                   err_msg=f'rank {rank}')
        assert got['losses'][-1] < got['losses'][0]


@pytest.mark.parametrize('path', ['quota', 'dense'])
def test_sharded_sparse_matches_dense_on_expert_mesh(world, path):
    """Twin of ``test_moe.py:171``: on data=2 x expert=2 at ample capacity
    the quota exchange (and the dense path on the mesh) give the
    reference's dense output, aux and gradients."""
    want = world['reference']['layer']
    for rank in range(4):
        got = world['ranks'][rank][path]
        np.testing.assert_allclose(got['out'], _rows(want['out'], rank // 2),
                                   **OUT)
        np.testing.assert_allclose(got['aux'], want['aux'], **AUX)
        for name, grad in want['grads'].items():
            np.testing.assert_allclose(got['grads'][name], grad,
                                       err_msg=name, **GRAD)


@pytest.mark.parametrize('exchange', ['ragged', 'emulated'])
def test_ragged_exchange_matches_dense_on_expert_mesh(world, exchange):
    """Twin of ``test_moe.py:210``: the ragged exchange (``all_to_all_single``
    with the actual rows) and its all-gather emulation match the dense
    path, forward, aux and the reverse exchange's gradients."""
    want = world['reference']['layer']
    for rank in range(4):
        got = world['ranks'][rank][exchange]
        np.testing.assert_allclose(got['out'], _rows(want['out'], rank // 2),
                                   **OUT)
        np.testing.assert_allclose(got['aux'], want['aux'], **AUX)
        for name, grad in want['grads'].items():
            np.testing.assert_allclose(got['grads'][name], grad,
                                       err_msg=name, **GRAD)


@pytest.mark.parametrize('exchange', ['ragged', 'ragged-emulated'])
def test_ragged_matches_dense_even_under_drops(world, exchange):
    """Twin of ``test_moe.py:251``: the whole batch in one expert group at
    capacity 0.75, the receiver's seating is the dense path's global
    choice-major drop order."""
    want = world['reference']['drops']
    for rank in range(2):
        got = world['ranks'][rank][f'drops_{exchange}']
        np.testing.assert_allclose(got['out'], want['out'], **OUT)
        np.testing.assert_allclose(got['aux'], want['aux'], **AUX)


def test_ragged_seats_tokens_the_quota_path_drops(world):
    """Twin of ``test_moe.py:276``: each shard's tokens want the expert the
    other shard owns; the quota path drops half of each sender's sends,
    the ragged one seats all 16 tokens and matches the dense output (and
    each path the reference's)."""
    seated = lambda out: int((np.abs(out).sum(-1) > 1e-6).sum())
    rows = 16
    for rank in range(2):
        found = world['ranks'][rank]
        dense, quota, ragged = (found[f'skew_{name}']['out']
                                for name in ('dense', 'quota', 'ragged'))
        assert seated(dense) == rows and seated(ragged) == rows
        assert seated(quota) < rows
        np.testing.assert_allclose(ragged, dense, **OUT)
        for name in ('dense', 'quota', 'ragged'):
            np.testing.assert_allclose(found[f'skew_{name}']['out'],
                                       world['reference'][f'skew_{name}'],
                                       err_msg=name, **OUT)
    # seated assignments over the two ranks: every token on the ragged
    # path, half of them on the quota path
    assert sum(world['ranks'][rank]['skew_ragged']['seated']
               for rank in range(2)) == rows
    assert sum(world['ranks'][rank]['skew_quota']['seated']
               for rank in range(2)) == rows // 2


def test_sharded_sparse_guards(world):
    """Twin of ``test_moe.py:315``: an explicit ``'sparse'`` on a mesh with
    a model axis raises the reference's reason, ``'auto'`` falls back to
    the dense path (and gives the reference's output there), a misspelt
    ``sparse_impl`` raises up front, ``'fused'`` raises on a multi-device
    mesh and an unknown exchange raises."""
    for rank, found in enumerate(world['ranks']):
        refusals = found['refusals']
        assert 'dense-only' in refusals['dense_only']
        assert 'unknown sparse_impl' in refusals['typo']
        if rank < 4:
            assert 'single-shard only' in refusals['fused']
            assert 'unknown exchange' in refusals['exchange']
        np.testing.assert_allclose(
            found['auto']['out'],
            _rows(world['reference']['auto'], (rank // 4) % 2), **OUT)


def test_moe_overlap_dispatch_matches_one_shot_model_level(world):
    """``test_schedule.py:740``'s docstring on the port: the MoE gpt2_tiny
    on data=2 x expert=2 under ``moe='overlap'`` (piece k + 1's dispatch
    before piece k's expert products) has the one-shot exchange's loss bit
    for bit in float32 at ample capacity, and its gradients within 1e-4
    relative, 1e-6 absolute."""
    for rank in range(4):
        found = world['ranks'][rank]
        ref, ovl = found['model_one_shot'], found['model_overlap']
        assert ref['loss'] == ovl['loss'], (ref['loss'], ovl['loss'])
        assert set(ref['grads']) == set(ovl['grads'])
        for name, grad in ref['grads'].items():
            np.testing.assert_allclose(ovl['grads'][name], grad, rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_moe_overlap_layer_matches_the_reference(world):
    """The scheduled quota layer against the reference's ``MoEMLP`` under
    ``OverlapSchedule(moe='overlap')`` on data=2 x expert=2, and bit for
    bit the port's one-shot layer."""
    want = world['reference']['schedule']
    for rank in range(4):
        found = world['ranks'][rank]
        np.testing.assert_allclose(found['layer_overlap']['out'],
                                   _rows(want, rank // 2), **OUT)
        np.testing.assert_array_equal(found['layer_overlap']['out'],
                                      found['layer_one_shot']['out'])


def test_moe_overlap_ragged_exchange_falls_back_one_shot(world):
    """``test_schedule.py:762``'s docstring on the port: the emulated
    ragged exchange keeps its one-shot exchange under ``moe='overlap'``
    (``moe_plan`` pins it), so the loss is the one-shot loss."""
    from tpusystem_torch.parallel.schedule import moe_plan
    assert moe_plan(8, 2, exchange='ragged-emulated').path == 'one-shot'
    for rank in range(4):
        found = world['ranks'][rank]
        assert (found['model_ragged_one_shot']['loss']
                == found['model_ragged_overlap']['loss'])
