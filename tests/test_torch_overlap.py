"""Twins of ``tests/test_overlap.py``: the port's decomposed all-gather /
reduce-scatter matmuls (``tpusystem_torch/parallel/overlap.py``) and the
``tp_impl`` knob of its GPT-2 and Llama, against the JAX package.

The ranks run in one world of four port processes (``tests/torch_ranks.py``,
gloo on the CPU), started once by a module fixture; the reference side runs
here on four of the eight virtual CPU devices, the same numpy operands
through both. The tolerances are the reference tests' own. The ring shift's
two routes (point-to-point, and the gather-and-pick that gloo takes on CUDA
tensors) are held bit for bit against each other.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from tpusystem import parallel as jpar
from tpusystem.models import GPT2 as JaxGPT2
from tpusystem.models.llama import llama_tiny as jax_llama_tiny
from tpusystem.parallel.mesh import MODEL, shard_map
from tpusystem_torch import parallel as tpar
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import GPT2, llama_tiny

from tests import torch_ranks

RING = 4
RANKS = 4


def tp_mesh():
    return jpar.MeshSpec(model=RING).build(jax.devices()[:RING])


def _operands(dtype, rows=16, inner=12, cols=24, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(rows, inner)) * 0.5, dtype)
    w = jnp.asarray(rng.normal(size=(inner, cols)) * 0.5, dtype)
    return x, w


def _mapped_allgather(mesh, chunks):
    @functools.partial(shard_map, mesh=mesh, check_vma=False,
                       in_specs=(JP(MODEL, None), JP(None, MODEL)),
                       out_specs=JP(None, MODEL))
    def mapped(x, w):
        return jpar.allgather_matmul(x, w, MODEL, chunks=chunks)
    return mapped


def _mapped_reducescatter(mesh, chunks):
    @functools.partial(shard_map, mesh=mesh, check_vma=False,
                       in_specs=(JP(None, MODEL), JP(MODEL, None)),
                       out_specs=JP(MODEL, None))
    def mapped(x, w):
        return jpar.matmul_reducescatter(x, w, MODEL, chunks=chunks)
    return mapped


BUILDERS = {'ag': _mapped_allgather, 'rs': _mapped_reducescatter}
# how the ranks' pieces assemble: (y, dx, dw) axes
AXES = {'ag': (1, 0, 1), 'rs': (0, 1, 0)}


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _gpt2(**knobs):
    return JaxGPT2(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                   dropout=0.0, dtype='float32', **knobs)


def _init(model, tokens):
    return model.init(jax.random.PRNGKey(0),
                      jnp.asarray(tokens[:1, :8]))['params']


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('overlap')
    tokens = _tokens(0, (4, 16))
    inputs = dict(
        scenarios=['overlap', 'tp_impl'],
        overlap={name: tuple(np.asarray(a, np.float32)
                             for a in _operands(dtype))
                 for name, dtype in (('float32', jnp.float32),
                                     ('bfloat16', jnp.bfloat16))},
        gpt2=jax.tree.map(np.asarray, _init(_gpt2(), tokens)),
        llama=jax.tree.map(np.asarray, _init(jax_llama_tiny(
            dtype='float32'), tokens)),
        tokens=tokens, tokens15=_tokens(1, (4, 15)), root=str(root))
    return dict(inputs=inputs,
                ranks=torch_ranks.launch(root, inputs, RANKS))


def _port(world, dtype, kind, chunks):
    """The ranks' (y, dx, dw) pieces assembled whole."""
    pieces = [result['overlap'][dtype, kind, chunks]
              for result in world['ranks']]
    return tuple(np.concatenate([piece[key] for piece in pieces], axis=axis)
                 for key, axis in zip(('y', 'dx', 'dw'), AXES[kind]))


@pytest.mark.parametrize('chunks', [1, 2])
def test_allgather_matmul_forward_matches_gspmd_reference(world, chunks):
    x, w = _operands(jnp.float32)
    want = jax.jit(_mapped_allgather(tp_mesh(), chunks))(x, w)
    got = _port(world, 'float32', 'ag', chunks)[0]
    np.testing.assert_allclose(got, np.asarray(x @ w), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize('chunks', [1, 2])
def test_matmul_reducescatter_forward_matches_gspmd_reference(world, chunks):
    x, w = _operands(jnp.float32)
    want = jax.jit(_mapped_reducescatter(tp_mesh(), chunks))(x, w)
    got = _port(world, 'float32', 'rs', chunks)[0]
    np.testing.assert_allclose(got, np.asarray(x @ w), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6, atol=2e-6)


def _reference_grads(kind, dtype, chunks):
    x, w = _operands(dtype)
    mapped = BUILDERS[kind](tp_mesh(), chunks)

    def loss(x, w):
        return jnp.sum(jnp.square(mapped(x, w).astype(jnp.float32)))

    def plain(x, w):
        return jnp.sum(jnp.square(jnp.matmul(x, w).astype(jnp.float32)))

    return (jax.jit(jax.grad(loss, argnums=(0, 1)))(x, w),
            jax.grad(plain, argnums=(0, 1))(x, w))


@pytest.mark.parametrize('kind', ['ag', 'rs'])
def test_overlap_grads_match_gspmd_reference_f32(world, kind):
    """The backward (each decomposition's transpose is its dual with
    swapped operands) reproduces the reference cotangents."""
    (rx, rw), (px, pw) = _reference_grads(kind, jnp.float32, 2)
    _, dx, dw = _port(world, 'float32', kind, 2)
    for got, want in ((dx, px), (dw, pw), (dx, rx), (dw, rw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize('kind', ['ag', 'rs'])
def test_overlap_grads_match_gspmd_reference_bf16(world, kind):
    """bf16 compute with f32 accumulation: the reference test's bounded
    tolerance against the bf16 matmul, gradients in bf16."""
    x, w = _operands(jnp.bfloat16)
    y, dx, dw = _port(world, 'bfloat16', kind, 1)
    np.testing.assert_allclose(y, np.asarray(jnp.matmul(x, w), np.float32),
                               rtol=0.05, atol=0.1)
    (rx, rw), (px, pw) = _reference_grads(kind, jnp.bfloat16, 1)
    assert rx.dtype == jnp.bfloat16 and rw.dtype == jnp.bfloat16
    for result in world['ranks']:
        assert result['overlap']['bfloat16', kind, 1]['dtypes'][1:] == (
            'torch.bfloat16', 'torch.bfloat16')
    for got, want in ((dx, px), (dw, pw)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=0.1, atol=0.5)


def test_plans_pick_one_shot_when_chunks_cannot_tile():
    assert tpar.allgather_plan(16, 1).path == 'one-shot'
    assert tpar.reducescatter_plan(16, 1).path == 'one-shot'
    plan = tpar.allgather_plan(16, RING, chunks=3)
    assert plan.path == 'one-shot' and 'chunks' in plan.reason
    plan = tpar.reducescatter_plan(16, RING, chunks=3)
    assert plan.path == 'one-shot' and 'chunks' in plan.reason
    assert tpar.allgather_plan(16, RING, chunks=2).path == 'overlap'
    assert tpar.reducescatter_plan(16, RING, chunks=2).path == 'overlap'
    with pytest.raises(ValueError):
        tpar.reducescatter_plan(18, RING)
    # every plan and reason is the reference's, field for field
    for rows in (4, 8, 12, 16, 24):
        for ring in (1, 2, 4):
            for chunks in (0, 1, 2, 3, 4):
                assert tuple(tpar.allgather_plan(rows, ring, chunks)) == \
                    tuple(jpar.allgather_plan(rows, ring, chunks))
                if ring > 1 and rows % ring:
                    continue
                assert tuple(tpar.reducescatter_plan(rows, ring, chunks)) \
                    == tuple(jpar.reducescatter_plan(rows, ring, chunks))


def test_one_shot_fallback_still_matches_reference(world):
    """chunks=3 cannot tile the 4-row shards: the one-shot collective path
    runs (pinned by the plan) and stays correct, gradients too."""
    x, w = _operands(jnp.float32)
    assert tpar.allgather_plan(x.shape[0] // RING, RING, 3).path == \
        'one-shot'
    y, dx, _ = _port(world, 'float32', 'ag', 3)
    np.testing.assert_allclose(y, np.asarray(x @ w), rtol=2e-6, atol=2e-6)
    _, (px, _) = _reference_grads('ag', jnp.float32, 3)
    np.testing.assert_allclose(dx, np.asarray(px), rtol=2e-5, atol=2e-5)
    assert tpar.reducescatter_plan(x.shape[0], RING, 3).path == 'one-shot'
    y = _port(world, 'float32', 'rs', 3)[0]
    np.testing.assert_allclose(y, np.asarray(x @ w), rtol=2e-6, atol=2e-6)


def test_ring_shift_routes_are_bitwise_equal(world):
    """The gather-and-pick route (gloo's on CUDA tensors) moves the same
    bits as point-to-point: three shifts in float32 and bfloat16 and the
    gradients through them. On the CPU gloo's mesh picks point-to-point."""
    for result in world['ranks']:
        assert result['routes']['default'] == 'p2p'
        assert result['routes']['bitwise']
    # rank r holds its predecessor's shard after a forward shift
    got = [result['routes']['held'][0] for result in world['ranks']]
    for rank, held in enumerate(got):
        before = (rank - 1) % RANKS
        np.testing.assert_array_equal(
            held, np.arange(24.0, dtype=np.float32).reshape(4, 6) * 1.37
            + 100 * before)


# ---------------------------------------------------------------------------
# model-level: the tp_impl knob


def _model_mesh():
    return jpar.MeshSpec(data=2, model=2).build(jax.devices()[:4])


def _run_model(model, rules, tokens, mesh):
    variables = model.init(jax.random.PRNGKey(0), tokens[:1, :8])
    params = jpar.ShardingPolicy(rules=rules).place(variables['params'],
                                                    mesh)
    placed_tokens = jax.device_put(tokens, jpar.batch_sharding(mesh))
    out = jax.jit(lambda p, t: model.apply({'params': p}, t))(
        params, placed_tokens)

    def loss(p):
        logits = model.apply({'params': p}, placed_tokens)
        return jnp.sum(jnp.square(logits.astype(jnp.float32))) * 1e-3

    grads = jax.jit(jax.grad(loss))(params)
    return variables, out, grads


def logits_rows(world, key, scenario, mesh_shape=(2, 2)):
    """The ranks' logits rows in batch order (one rank a batch block)."""
    blocks, model = mesh_shape
    return np.concatenate([world['ranks'][block * model][scenario][key][
        'logits'] for block in range(blocks)])


def _grads_close(got: dict, want, rtol, atol):
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize('family', ['gpt2', 'llama'])
def test_tp_impl_overlap_matches_gspmd_model_level(world, family):
    """Same parameters, logits and gradients either way on data=2 x
    model=2: 'overlap' is an implementation knob for the FFN projections.
    The port's ranks against the reference's placed runs."""
    mesh = _model_mesh()
    tokens = jnp.asarray(world['inputs']['tokens'])

    def build(impl):
        if family == 'gpt2':
            return _gpt2(mesh=mesh, tp_impl=impl, tp_chunks=2), \
                JaxGPT2.partition_rules()
        model = jax_llama_tiny(dtype='float32', mesh=mesh, tp_impl=impl,
                               tp_chunks=2)
        return model, type(model).partition_rules()

    v_ref, out_ref, grads_ref = _run_model(*build('gspmd'), tokens, mesh)
    v_ovl, out_ovl, _ = _run_model(*build('overlap'), tokens, mesh)
    for ref, ovl in zip(jax.tree.leaves(v_ref), jax.tree.leaves(v_ovl)):
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(ovl))
    # the port's tree is the reference's under either knob, bit for bit
    for leaf, given in zip(jax.tree.leaves(v_ref['params']),
                           jax.tree.leaves(world['inputs'][family])):
        np.testing.assert_array_equal(np.asarray(leaf), given)
    make = ((lambda **knobs: GPT2(vocab_size=256, layers=2, dim=64, heads=4,
                                  max_seq=128, dropout=0.0, dtype='float32',
                                  device='cpu', **knobs))
            if family == 'gpt2' else
            (lambda **knobs: llama_tiny(dtype='float32', device='cpu',
                                        **knobs)))
    plain, knob = make(), make(tp_impl='overlap', tp_chunks=2)
    assert [(name, leaf.shape) for name, leaf in plain.state_dict().items()] \
        == [(name, leaf.shape) for name, leaf in knob.state_dict().items()]
    assert all(leaf.equal(knob.state_dict()[name])
               for name, leaf in plain.state_dict().items())
    for impl in ('gspmd', 'overlap'):
        got = logits_rows(world, (family, impl), 'tp_impl')
        np.testing.assert_allclose(got, np.asarray(out_ref), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(out_ovl), rtol=2e-5,
                                   atol=2e-5)
        for result in world['ranks']:
            _grads_close(result['tp_impl'][family, impl]['grads'],
                         grads_ref, rtol=2e-4, atol=2e-5)


def test_tp_impl_overlap_falls_back_on_non_tiling_sequence(world):
    """seq=15 cannot split over the model axis: the Megatron Dense path
    runs under the same parameters and the forward still matches."""
    mesh = _model_mesh()
    tokens = jnp.asarray(world['inputs']['tokens15'])
    reference = _gpt2(mesh=mesh, tp_impl='gspmd')
    variables = {'params': jax.tree.map(jnp.asarray,
                                        world['inputs']['gpt2'])}
    out_ref = jax.jit(lambda v, t: reference.apply(v, t))(variables, tokens)
    gspmd = logits_rows(world, ('seq15', 'gspmd'), 'tp_impl')
    overlap = logits_rows(world, ('seq15', 'overlap'), 'tp_impl')
    np.testing.assert_allclose(overlap, gspmd, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(overlap, np.asarray(out_ref), rtol=2e-5,
                               atol=2e-5)
    schedule = tpar.OverlapSchedule(tp='overlap')
    mesh_sizes = {'data': 2, 'model': 2}
    shaped = tpar.Mesh('cpu', None, mesh_sizes)
    assert not tpar.schedule_applicable(schedule, shaped, (4, 15, 64), 256)
    assert tpar.schedule_applicable(schedule, shaped, (4, 16, 64), 256)


def test_tp_impl_rejects_unknown_value():
    with pytest.raises(ValueError, match='tp_impl'):
        GPT2(vocab_size=64, layers=1, dim=32, heads=4, max_seq=32,
             dropout=0.0, dtype='float32', tp_impl='magic', device='cpu')
    model = JaxGPT2(vocab_size=64, layers=1, dim=32, heads=4, max_seq=32,
                    dropout=0.0, dtype='float32', tp_impl='magic')
    with pytest.raises(ValueError, match='tp_impl'):
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
