"""The port's recommender slice against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages. The kernels' plain
versions match the reference's Pallas kernels in interpret mode bitwise in
float32: the gather multiplies once and rounds once; the scatter-add sums
each id's rows from 0.0 in ascending position, one rounding per product and
per add, bitwise the reference kernel's body, and bitwise the interpreted
kernel where ids do not repeat (XLA on the CPU fuses the interpreted
product and add into one multiply-add, an ulp apart per repeated id). In bfloat16 they are held to the reference's own bounds
(``tests/test_recsys.py``: forward 1e-2, table gradient 5e-2). The
differentiable lookup's forward is bitwise, its table and weight gradients
within 1e-6 (the reference's cross-impl tolerance). ``dedup_ids``,
``SyntheticClicks``, the ``Loader``'s order and cursors, and the registry
digests are bitwise. The models' forwards with carried weights match
within 1e-5 (float32 products summed in another order; the two-tower
scores are divided by a temperature of 0.05, so 2e-5 there), and three SGD
and three AdamW steps of ``dlrm_tiny`` and ``two_tower_tiny`` match the
reference's ``build_train_step`` within 1e-5, as the GPT-2 steps do in
``test_torch_train.py``. The metrics give equal results on equal inputs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.data import Loader as JaxLoader
from tpusystem.data import SyntheticClicks as JaxClicks
from tpusystem.models import DLRM as JaxDLRM
from tpusystem.models import TwoTower as JaxTwoTower
from tpusystem.models import dlrm_tiny as jax_dlrm_tiny
from tpusystem.models import two_tower_tiny as jax_two_tower_tiny
from tpusystem.observe.events import Trained as JTrained
from tpusystem.ops.pallas import embedding_lookup as jel
from tpusystem.recsys import RecallAtK as JaxRecallAtK
from tpusystem.recsys import ShardedEmbedding as JaxShardedEmbedding
from tpusystem.recsys import StreamingAUC as JaxStreamingAUC
from tpusystem.recsys import dedup_ids as jax_dedup_ids
from tpusystem.recsys import evaluation_consumer as jax_evaluation_consumer
from tpusystem.recsys import lookup as jax_lookup
from tpusystem.recsys import route_plan as jax_route_plan
from tpusystem.registry import gethash as jax_gethash
from tpusystem.services import Producer as JProducer
from tpusystem.train import metrics as jmetrics
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.data import Loader, SyntheticClicks
from tpusystem_torch.models import DLRM, TwoTower, dlrm_tiny, two_tower_tiny
from tpusystem_torch.observe.events import Trained as TTrained
from tpusystem_torch.ops.cuda import embedding_lookup as tel
from tpusystem_torch.recsys import (RecallAtK, RecsysEvaluator,
                                    ShardedEmbedding, StreamingAUC, dedup_ids,
                                    evaluation_consumer, lookup, route_plan)
from tpusystem_torch.registry import gethash
from tpusystem_torch.services import Producer as TProducer
from tpusystem_torch.train import metrics as tmetrics
from tpusystem_torch.train import optim as toptim

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want, name=''):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


def _t(array):
    return torch.from_numpy(np.array(array))


def _case(seed=0, rows=48, dim=16, count=40):
    """Ids with the hard cases baked in: a duplicate pair (the scatter-add
    collision), -1 padding (the empty row), and the full id range."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = rng.integers(0, rows, (count,)).astype(np.int32)
    ids[3] = -1
    ids[7] = ids[5]
    weights = rng.uniform(0.5, 1.5, (count,)).astype(np.float32)
    cotangent = rng.standard_normal((count, dim)).astype(np.float32)
    return table, ids, weights, cotangent


def _bf16(array):
    """A float32 array rounded to bfloat16, as both packages' tensors."""
    rounded = np.asarray(jnp.asarray(array, jnp.bfloat16))
    return jnp.asarray(rounded), torch.from_numpy(
        rounded.astype(np.float32)).to(torch.bfloat16)


# --- K8 / K9: the plain versions vs the Pallas kernels -------------------

@pytest.mark.parametrize('seed,rows,dim,count', [
    (0, 48, 16, 40), (1, 7, 128, 64), (2, 300, 24, 33), (3, 5, 10, 50)])
def test_gather_rows_plain_matches_the_pallas_kernel_bitwise(seed, rows, dim,
                                                             count):
    table, ids, weights, _ = _case(seed, rows, dim, count)
    clamped = np.clip(ids, 0, rows - 1)
    scale = (weights * (ids >= 0)).astype(np.float32)
    scale[1] = 0.0                              # a zero scale reads the row
    want = jel.gather_rows(jnp.asarray(table), jnp.asarray(clamped),
                           jnp.asarray(scale), interpret=True)
    got = tel.gather_rows(_t(table), _t(clamped), _t(scale))
    _same(got.numpy(), want)


def test_gather_rows_bf16_within_the_reference_bound():
    table, ids, weights, _ = _case(4)
    jtable, ttable = _bf16(table)
    clamped = np.clip(ids, 0, table.shape[0] - 1)
    want = jel.gather_rows(jtable, jnp.asarray(clamped), jnp.asarray(weights),
                           interpret=True)
    got = tel.gather_rows(ttable, _t(clamped), _t(weights))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    wide = tel.gather_rows(ttable, _t(clamped), _t(weights),
                           out_dtype=torch.float32)
    _same(wide.numpy(), ttable.float().numpy()[clamped] * weights[:, None])


def _scatter_ids(rng, count, table_rows, distinct):
    if distinct == count:                             # every id once
        ids = rng.permutation(table_rows)[:count].astype(np.int32)
    else:
        ids = rng.integers(0, distinct, (count,)).astype(np.int32)
    ids[5] = table_rows                               # sentinels
    ids[-1] = table_rows
    return ids


def _sequential_scatter(rows, ids, scale, table_rows):
    """The reference kernel's body as written: for each j in order, the
    float32 product rounded, then the add rounded."""
    out = np.zeros((table_rows, rows.shape[1]), np.float32)
    for j, row in enumerate(ids):
        if row < table_rows:
            out[row] = out[row] + rows[j] * scale[j]
    return out


@pytest.mark.parametrize('count,table_rows,dim,distinct', [
    (32, 12, 16, 4), (64, 40, 128, 40), (48, 6, 10, 2), (40, 100, 24, 40),
    (64, 64, 128, 64)])
def test_scatter_add_rows_plain_matches_the_pallas_kernel(
        count, table_rows, dim, distinct):
    """Duplicate ids sum in ascending position from 0.0, the product and
    the add each rounded: bitwise the reference kernel's body. Interpreted
    on the CPU, XLA contracts that product and add into one fused
    multiply-add, so with duplicates the interpreted kernel differs by an
    ulp per add (within 1e-6 here); where every id comes once the add is
    to 0.0 and both are bitwise."""
    rng = np.random.default_rng(count + dim)
    rows = rng.standard_normal((count, dim)).astype(np.float32)
    ids = _scatter_ids(rng, count, table_rows, distinct)
    scale = rng.uniform(0.5, 1.5, (count,)).astype(np.float32)
    want = np.asarray(jel.scatter_add_rows(
        jnp.asarray(rows), jnp.asarray(ids), jnp.asarray(scale), table_rows,
        interpret=True))
    got = tel.scatter_add_rows(_t(rows), _t(ids), _t(scale), table_rows)
    assert got.dtype == torch.float32 and got.shape == (table_rows, dim)
    _same(got.numpy(), _sequential_scatter(rows, ids, scale, table_rows))
    if distinct == count:
        _same(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_scatter_add_rows_heavy_duplicates_hold_the_sequential_sum(dtype):
    """One id ~1,000 times among 2,048, sentinels interleaved and at the
    end: the plain K9 is bitwise the reference kernel's body as written
    (``_sequential_scatter``, each product and each add rounded, in
    ascending position) however long the segment, in float32 and on bf16
    rows. The interpreted Pallas kernel contracts each product and add into
    one fused multiply-add, so it is held within the bound that difference
    allows. For one id's m products x_k and unit roundoff u = 2**-24, the
    body's sum carries m roundings of products and adds, at most
    m u sum|x_k| from the exact sum to first order; the fused one m - 1
    roundings, at most (m - 1) u sum|x_k|; so the two differ by at most
    (2m - 1) u sum|x_k| per column. At m ~ 1,000 that is ~1e-4 of the
    column's sum of magnitudes: the 1e-6 of the short-segment test does
    not carry over."""
    rng = np.random.default_rng(13)
    count, table_rows, dim = 2048, 64, 16
    ids = rng.integers(0, table_rows, count).astype(np.int32)
    ids[rng.random(count) < 0.5] = 7
    ids[::37] = table_rows
    ids[-5:] = table_rows
    rows = rng.standard_normal((count, dim)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, count).astype(np.float32)
    if dtype == 'bfloat16':
        jrows, trows = _bf16(rows)
        rows = trows.float().numpy()          # the bf16 values, widened
    else:
        jrows, trows = jnp.asarray(rows), _t(rows)
    repeats = int((ids == 7).sum())
    assert repeats > 950
    got = tel.scatter_add_rows(trows, _t(ids), _t(scale), table_rows)
    assert got.dtype == torch.float32 and got.shape == (table_rows, dim)
    _same(got.numpy(), _sequential_scatter(rows, ids, scale, table_rows))
    want = np.asarray(jel.scatter_add_rows(
        jrows, jnp.asarray(ids), jnp.asarray(scale), table_rows,
        interpret=True))
    magnitude = np.zeros((table_rows + 1, dim))
    counts = np.bincount(ids, minlength=table_rows + 1)[:, None]
    np.add.at(magnitude, ids, np.abs(rows.astype(np.float64)
                                     * scale[:, None]))
    bound = ((2 * counts - 1).clip(min=0) * 2.0 ** -24 * magnitude)[
        :table_rows]
    error = np.abs(got.numpy().astype(np.float64) - want)
    assert (error <= bound).all(), float((error - bound).max())
    assert error[7].max() > 0                 # the fused adds do differ


def test_scatter_add_rows_bf16_rows_within_the_reference_bound():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((32, 16)).astype(np.float32)
    jrows, trows = _bf16(rows)
    ids = _scatter_ids(rng, 32, 12, 4)
    scale = rng.uniform(0.5, 1.5, (32,)).astype(np.float32)
    want = jel.scatter_add_rows(jrows, jnp.asarray(ids), jnp.asarray(scale),
                                12, interpret=True)
    got = tel.scatter_add_rows(trows, _t(ids), _t(scale), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2,
                               atol=5e-2)


# --- the differentiable lookup ------------------------------------------

def _lookup_grads(fn, table, weights, cotangent):
    """``(out, d_table, d_weights)`` of ``sum(fn(table, weights) * cot)``
    through torch autograd."""
    ttable = _t(table).requires_grad_()
    tweights = _t(weights).requires_grad_()
    out = fn(ttable, tweights)
    d_table, d_weights = torch.autograd.grad(
        (out.float() * _t(cotangent)).sum(), (ttable, tweights),
        allow_unused=True)
    return out.detach(), d_table, d_weights


def _jax_lookup_grads(fn, table, weights, cotangent):
    def objective(tab, wts):
        return jnp.sum(fn(tab, wts).astype(jnp.float32) * cotangent)
    out = fn(jnp.asarray(table), jnp.asarray(weights))
    d_table, d_weights = jax.grad(objective, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(weights))
    return out, d_table, d_weights


@pytest.mark.parametrize('impl', ['fused', 'take', 'auto'])
def test_embedding_lookup_matches_the_reference(impl):
    """Forward bitwise; d_table and d_weights within 1e-6 (on the CPU
    'auto' is the take path, as the reference's is off-TPU)."""
    table, ids, weights, cotangent = _case(6)
    want = _jax_lookup_grads(
        lambda t, w: jel.embedding_lookup(t, jnp.asarray(ids), w,
                                          impl='take'),
        table, weights, cotangent)
    got = _lookup_grads(
        lambda t, w: tel.embedding_lookup(t, _t(ids), w, impl=impl),
        table, weights, cotangent)
    _same(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert float(got[2][3]) == 0.0       # padding never sees a gradient
    np.testing.assert_array_equal(got[0][3].numpy(), 0.0)


def test_fused_lookup_counts_no_launch_on_the_cpu():
    """A CPU tensor takes the plain versions: the launch counters stay."""
    table, ids, weights, cotangent = _case(7)
    before = (tel.gather_rows.launches, tel.scatter_add_rows.launches)
    _lookup_grads(lambda t, w: tel.embedding_lookup(t, _t(ids), w,
                                                    impl='fused'),
                  table, weights, cotangent)
    assert (tel.gather_rows.launches, tel.scatter_add_rows.launches) == before


def test_fused_lookup_bf16_within_the_reference_bound():
    table, ids, weights, cotangent = _case(8)
    jtable, ttable = _bf16(table)
    want = jel.embedding_lookup(jtable, jnp.asarray(ids),
                                jnp.asarray(weights), impl='take')
    leaf = ttable.clone().requires_grad_()
    got = tel.embedding_lookup(leaf, _t(ids), _t(weights), impl='fused')
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)
    (d_table,) = torch.autograd.grad((got.float() * _t(cotangent)).sum(),
                                     leaf)
    d_want = jax.grad(lambda t: jnp.sum(jel.embedding_lookup(
        t, jnp.asarray(ids), jnp.asarray(weights),
        impl='take').astype(jnp.float32) * cotangent))(jtable)
    np.testing.assert_allclose(d_table.float().numpy(),
                               np.asarray(d_want, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_unknown_impl_raises():
    table, ids, weights, _ = _case()
    with pytest.raises(ValueError, match='unknown impl'):
        tel.embedding_lookup(_t(table), _t(ids), _t(weights), impl='turbo')


# --- dedup and the lookup -----------------------------------------------

@pytest.mark.parametrize('seed,count,vocab', [(0, 8, 9), (1, 64, 5),
                                              (2, 100, 1000), (3, 1, 4)])
def test_dedup_ids_matches_bitwise(seed, count, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, vocab, (count,)).astype(np.int32)
    sent = np.where(ids >= 0, ids, vocab).astype(np.int32)
    got = dedup_ids(_t(sent), vocab)
    want = jax_dedup_ids(jnp.asarray(sent), vocab)
    for g, w, name in zip(got, want, ('reps', 'inverse')):
        assert g.dtype == torch.int32
        _same(g.numpy(), w, name)
    _same(got[0].numpy()[got[1].numpy()], sent)


@pytest.mark.parametrize('dedup', [True, False])
@pytest.mark.parametrize('weighted', [True, False])
def test_lookup_matches_the_reference(dedup, weighted):
    """Forward bitwise with and without the dedup pass (equal to each
    other too); gradients within 1e-6."""
    table, ids, weights, cotangent = _case(9, count=64)
    ids[10:20] = ids[11]                           # a heavy duplicate
    jweights = (lambda w: w) if weighted else (lambda w: None)
    want = _jax_lookup_grads(
        lambda t, w: jax_lookup(t, jnp.asarray(ids), jweights(w),
                                dedup=dedup), table, weights, cotangent)
    got = _lookup_grads(
        lambda t, w: lookup(t, _t(ids), jweights(w), impl='fused',
                            dedup=dedup), table, weights, cotangent)
    _same(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    if weighted:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6, atol=1e-6)
    other = lookup(_t(table), _t(ids), _t(weights) if weighted else None,
                   dedup=not dedup)
    _same(other.numpy(), got[0].numpy())


# --- ShardedEmbedding ---------------------------------------------------

def _mesh(**sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)


def test_route_plan_matches_the_reference():
    meshes = [None, _mesh(data=2, model=2, expert=2), _mesh(data=8),
              _mesh(data=2, fsdp=2, model=3)]
    for mesh in meshes:
        for vocab, count in ((64, 48), (63, 48), (64, 7), (66, 12)):
            assert (route_plan(vocab, count, mesh)
                    == jax_route_plan(vocab, count, mesh))


def test_a_split_table_is_not_ported():
    with pytest.raises(NotImplementedError, match='queue 1: 9'):
        ShardedEmbedding(64, 8, mesh=_mesh(data=2, model=2), device='cpu')
    ShardedEmbedding(64, 8, mesh=_mesh(data=8), device='cpu')   # one shard
    assert (_scoped_evaluations(evaluation_consumer, TTrained, TProducer)
            == _scoped_evaluations(jax_evaluation_consumer, JTrained,
                                   JProducer))


def _scoped_evaluations(evaluation_consumer, trained, producer_type):
    """Which ``Trained`` events an evaluation consumer answers, scoped by
    instance, by ``id`` and not at all, and the ``RecsysEvaluated`` events
    it dispatches."""
    runs, dispatched = [], []

    class Evaluator:
        def run(self, state):
            runs.append(state)
            return {'auc': 0.5, 'loss': float(len(runs))}

    mine = types.SimpleNamespace(id='mine', state='mine-state')
    other = types.SimpleNamespace(id='other', state='other-state')
    twin = types.SimpleNamespace(id='mine', state='twin-state')
    producer = producer_type()
    producer.taps.append(lambda event: dispatched.append(
        (type(event).__name__, event.model.state, event.metrics)))
    for subject in (mine, 'mine', None):
        consumer = evaluation_consumer(Evaluator(), producer=producer,
                                       subject=subject)
        for model in (mine, other, twin):
            consumer.consume(trained(model, {'loss': 1.0}))
    assert runs == ['mine-state', 'mine-state', 'twin-state', 'mine-state',
                    'other-state', 'twin-state']
    return runs, dispatched


@pytest.mark.parametrize('dedup', [True, False])
def test_sharded_embedding_forward_matches_with_carried_weights(dedup):
    rng = np.random.default_rng(10)
    ids = rng.integers(-1, 64, (16, 3)).astype(np.int32)
    weights = rng.uniform(0.5, 1.5, (16, 3)).astype(np.float32)
    reference = JaxShardedEmbedding(64, 8, dedup=dedup)
    variables = reference.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    want = reference.apply(variables, jnp.asarray(ids), jnp.asarray(weights))
    port = ShardedEmbedding(64, 8, dedup=dedup, device='cpu')
    port.load_state_dict(params_from_jax(variables['params']))
    got = port(_t(ids), _t(weights))
    assert got.shape == (16, 3, 8)
    _same(got.detach().numpy(), want)


# --- the models ---------------------------------------------------------

def _click_batch(rng, batch=8, features=2, vocab=32, dense=4, hot=4,
                 weighted=False):
    inputs = {'dense': rng.standard_normal((batch, dense)).astype(np.float32),
              'ids': rng.integers(-1, vocab, (batch, features, hot)).astype(
                  np.int32)}
    if weighted:
        inputs['weights'] = rng.uniform(0.5, 1.5, (batch, features, hot)
                                        ).astype(np.float32)
    return inputs, rng.integers(0, 2, (batch,)).astype(np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {key: _to_torch(value) for key, value in tree.items()}
    return _t(tree)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {key: _to_jax(value) for key, value in tree.items()}
    return jnp.asarray(tree)


def _carry(reference, port, inputs):
    """Init the reference on ``inputs``, load its params into the port."""
    params = reference.init(jax.random.PRNGKey(0), _to_jax(inputs))['params']
    port.load_state_dict(params_from_jax(params))
    return params


DLRM_CASES = {
    'tiny': (dict(), dict(features=2, vocab=32, dense=4, hot=4)),
    'tiny-weighted': (dict(), dict(features=2, vocab=32, dense=4, hot=4,
                                   weighted=True)),
    'dim128-multihot': (dict(vocabs=(100, 37, 5), dim=128, dense_features=13,
                             bottom=(64, 32), top=(64, 32)),
                        dict(features=3, vocab=5, dense=13, hot=3,
                             weighted=True)),
}


@pytest.mark.parametrize('case', list(DLRM_CASES))
def test_dlrm_forward_matches_with_carried_weights(case):
    config, shape = DLRM_CASES[case]
    rng = np.random.default_rng(11)
    inputs, _ = _click_batch(rng, **shape)
    reference = jax_dlrm_tiny(**config)
    port = dlrm_tiny(device='cpu', **config)
    params = _carry(reference, port, inputs)
    want = reference.apply({'params': params}, _to_jax(inputs))
    got = port(_to_torch(inputs))
    assert got.shape == (8,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_two_tower_multi_hot_forward_matches_with_carried_weights():
    rng = np.random.default_rng(12)
    history = rng.integers(0, 64, (8, 5)).astype(np.int32)
    history[:, 3:] = -1                          # ragged histories
    history[2] = -1                              # an empty one
    inputs = {'user': history,
              'item': rng.integers(0, 32, (8,)).astype(np.int32)}
    reference = jax_two_tower_tiny()
    port = two_tower_tiny(device='cpu')
    params = _carry(reference, port, inputs)
    want = reference.apply({'params': params}, _to_jax(inputs))
    got = port(_to_torch(inputs))
    assert got.shape == (8, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=2e-5)


def _two_tower_batch(rng, batch=16):
    users = rng.integers(0, 64, (batch, 3)).astype(np.int32)
    users[::3, 2] = -1
    return {'user': users, 'item': (users[:, 0] % 32).astype(np.int32)}, \
        np.arange(batch, dtype=np.int32)


MODELS = {'dlrm_tiny': (jax_dlrm_tiny, dlrm_tiny, 'BCEWithLogitsLoss'),
          'two_tower_tiny': (jax_two_tower_tiny, two_tower_tiny,
                             'CrossEntropyLoss')}


@pytest.mark.parametrize('optimizer', ["SGD(lr=0.1)", "AdamW(lr=1e-2)"])
@pytest.mark.parametrize('model', list(MODELS))
def test_three_train_steps_match_the_reference(model, optimizer):
    """Three steps from carried weights on one batch: losses within 1e-5,
    end parameters within 1e-5."""
    jax_factory, factory, loss = MODELS[model]
    rng = np.random.default_rng(13)
    if model == 'dlrm_tiny':
        inputs, targets = _click_batch(rng, batch=16)
    else:
        inputs, targets = _two_tower_batch(rng)
    reference, port = jax_factory(), factory(device='cpu')
    jopt = eval(optimizer, vars(jtrain))
    topt = eval(optimizer, vars(ttrain))
    jstate = jtrain.init_state(reference, jopt, _to_jax(inputs))
    port.load_state_dict(params_from_jax(jstate.params))
    tstate = ttrain.init_state(port, topt)
    jstep = jtrain.build_train_step(jtrain.flax_apply(reference),
                                    getattr(jtrain, loss)(), jopt)
    tstep = ttrain.build_train_step(ttrain.module_apply(port),
                                    getattr(ttrain, loss)(), topt)
    jinputs, tinputs = _to_jax(inputs), _to_torch(inputs)
    jtargets, ttargets = jnp.asarray(targets), _t(targets)
    jlosses, tlosses = [], []
    for _ in range(3):
        jstate, (_, jloss) = jstep(jstate, jinputs, jtargets)
        tstate, (_, tloss) = tstep(tstate, tinputs, ttargets)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert tlosses[-1] < tlosses[0]
    want = params_from_jax(jstate.params)
    for name, value in tstate.params.items():
        np.testing.assert_allclose(value.detach().numpy(),
                                   want[name].numpy(), **TOL, err_msg=name)


def test_models_raise_without_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for factory in (dlrm_tiny, two_tower_tiny):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Loader(SyntheticClicks(samples=8), 4)


# --- data ---------------------------------------------------------------

@pytest.mark.parametrize('kwargs', [
    dict(), dict(samples=300, vocabs=(1000, 3, 17), hot=1, dense=13, seed=4),
    dict(samples=50, vocabs=(64,), hot=6, seed=2, alpha=1.05, train=False)])
def test_synthetic_clicks_match_bitwise(kwargs):
    want, got = JaxClicks(**kwargs), SyntheticClicks(**kwargs)
    assert len(got) == len(want)
    index = np.arange(len(got))
    (wf, wl), (gf, gl) = want[index], got[index]
    for key in ('dense', 'ids'):
        assert gf[key].dtype == wf[key].dtype
        _same(gf[key], wf[key], key)
    _same(gl, wl, 'labels')


def _batches(loader, count):
    out = []
    for features, labels in loader:
        out.append((np.asarray(features['ids']), np.asarray(labels),
                    dict(loader.state())))
        if len(out) == count:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gi, gl, gs), (wi, wl, ws) in zip(got, want):
        _same(gi, wi)
        _same(gl, wl)
        assert gs == ws


def test_loader_order_and_cursors_match_bitwise():
    dataset_args = dict(samples=100, vocabs=(64, 32), seed=3)
    jdata, tdata = JaxClicks(**dataset_args), SyntheticClicks(**dataset_args)
    for shuffle, drop in ((True, True), (False, False)):
        kwargs = dict(batch_size=16, shuffle=shuffle, seed=5,
                      drop_remainder=drop)
        jloader = JaxLoader(jdata, **kwargs)
        tloader = Loader(tdata, device='cpu', **kwargs)
        assert len(tloader) == len(jloader)
        for _ in range(2):                                  # two epochs
            _same_batches(_batches(tloader, 100), _batches(jloader, 100))
            assert tloader.state() == jloader.state()
        # an early stop mid-epoch, then a fresh loader seeking its cursor
        _same_batches(_batches(tloader, 3), _batches(jloader, 3))
        cursor = tloader.state()
        assert cursor == jloader.state()
        fresh = Loader(tdata, device='cpu', **kwargs).seek(cursor)
        jfresh = JaxLoader(jdata, **kwargs).seek(cursor)
        _same_batches(_batches(fresh, 100), _batches(jfresh, 100))
        for past in ({'epoch': 1, 'batch': 9}, {'epoch': 0, 'batch': 6}):
            _same_batches(
                _batches(Loader(tdata, device='cpu', **kwargs).seek(past),
                         100),
                _batches(JaxLoader(jdata, **kwargs).seek(past), 100))
    with pytest.raises(ValueError, match='>= 0'):
        tloader.seek({'epoch': 0, 'batch': -1})
    with pytest.raises(TypeError, match='mesh Placement'):
        Loader(tdata, 4, sharding=object(), device='cpu')


def test_loader_batches_are_tensors_on_the_asked_device():
    loader = Loader(SyntheticClicks(samples=40), 16, device='cpu')
    batches = list(loader)
    assert len(batches) == 2
    features, labels = batches[0]
    assert isinstance(labels, torch.Tensor) and labels.shape == (16,)
    assert features['ids'].dtype == torch.int32
    assert features['dense'].device.type == 'cpu'


# --- metrics and the evaluator ------------------------------------------

def test_streaming_auc_recall_and_mean_equal_on_equal_inputs():
    rng = np.random.default_rng(14)
    jauc, tauc = JaxStreamingAUC(64), StreamingAUC(64)
    jrecall, trecall = JaxRecallAtK(3), RecallAtK(3)
    jmean, tmean = jmetrics.Mean(), tmetrics.Mean()
    jtop, ttop = jmetrics.TopKAccuracy(2), tmetrics.TopKAccuracy(2)
    jacc, tacc = jmetrics.Accuracy(), tmetrics.Accuracy()
    jppl, tppl = jmetrics.Perplexity(), tmetrics.Perplexity()
    for _ in range(4):
        logits = rng.standard_normal(50).astype(np.float32) * 3
        labels = rng.integers(0, 2, 50).astype(np.float32)
        jauc.update(jnp.asarray(logits), jnp.asarray(labels))
        tauc.update(_t(logits), _t(labels))
        scores = rng.standard_normal((12, 12)).astype(np.float32)
        scores[0, :4] = 1.0                                # ties
        relevant = np.arange(12, dtype=np.int32)
        for j, t in ((jrecall, trecall), (jtop, ttop)):
            j.update(jnp.asarray(scores), jnp.asarray(relevant))
            t.update(_t(scores), _t(relevant))
        predictions = rng.integers(0, 3, 20).astype(np.int32)
        targets = rng.integers(0, 3, 20).astype(np.int32)
        jacc.update(jnp.asarray(predictions), jnp.asarray(targets))
        tacc.update(_t(predictions), _t(targets))
        loss = np.float32(rng.uniform(0.1, 3.0))
        for j, t in ((jmean, tmean), (jppl, tppl)):
            j.update(jnp.asarray(loss), weight=2.0)
            t.update(torch.tensor(loss), weight=2.0)
    assert tauc.compute() == jauc.compute()
    assert trecall.compute() == jrecall.compute()
    assert ttop.compute() == jtop.compute()
    assert tacc.compute() == jacc.compute()
    assert tmean.compute() == jmean.compute()
    assert tppl.compute() == jppl.compute()
    tauc.reset()
    assert tauc.compute() == 0.5 and tmetrics.Mean().compute() == 0.0


def test_recsys_evaluator_matches_the_reference():
    """The same trained-from-carried weights on the same holdout: the loss
    within 1e-6, the AUC within one bucket (1/512)."""
    data = dict(samples=96, vocabs=(64, 32), seed=0, train=False)
    reference, port = jax_dlrm_tiny(), dlrm_tiny(device='cpu')
    sample = JaxClicks(**data)[np.arange(2)][0]
    jstate = jtrain.init_state(reference, jtrain.SGD(lr=0.1), sample)
    port.load_state_dict(params_from_jax(jstate.params))
    tstate = ttrain.init_state(port, ttrain.SGD(lr=0.1))
    from tpusystem.recsys import RecsysEvaluator as JaxEvaluator
    want = JaxEvaluator(reference, JaxLoader(JaxClicks(**data), 32)).run(
        jstate)
    got = RecsysEvaluator(port, Loader(SyntheticClicks(**data), 32,
                                       device='cpu')).run(tstate)
    assert set(got) == {'loss', 'auc'}
    assert abs(got['loss'] - want['loss']) <= 1e-6
    assert abs(got['auc'] - want['auc']) <= 1 / 512


# --- identity and the optimizer's runs ----------------------------------

@pytest.mark.parametrize('instance', [
    "DLRM(vocabs=(64, 32), dim=8)", "DLRM((1460, 583), 128, 13, (512, 256))",
    "TwoTower(users=64, items=32, dim=8, tower=(16,))",
    "TwoTower(temperature=0.1, dedup=False)",
    "ShardedEmbedding(64, 8)", "ShardedEmbedding(64, 8, impl='take')",
])
def test_registry_digests_match_the_reference(instance):
    port = eval(instance[:-1] + ", device='cpu')",
                dict(DLRM=DLRM, TwoTower=TwoTower,
                     ShardedEmbedding=ShardedEmbedding))
    reference = eval(instance, dict(DLRM=JaxDLRM, TwoTower=JaxTwoTower,
                                    ShardedEmbedding=JaxShardedEmbedding))
    assert gethash(port) == jax_gethash(reference)


def test_data_registry_digests_match_the_reference():
    args = dict(samples=64, vocabs=(8, 4), hot=2, seed=1)
    jdata, tdata = JaxClicks(**args), SyntheticClicks(**args)
    assert gethash(tdata) == jax_gethash(jdata)
    assert (gethash(Loader(tdata, 16, shuffle=True, seed=3, device='cpu'))
            == jax_gethash(JaxLoader(jdata, 16, shuffle=True, seed=3)))
    assert (gethash(Loader(tdata, batch_size=8, prefetch=4, device='cpu'))
            == jax_gethash(JaxLoader(jdata, batch_size=8, prefetch=4)))


def test_optimizer_runs_split_the_update_without_changing_it(monkeypatch):
    """Spans of leaves bound the temporary; the arithmetic is the same."""
    rng = np.random.default_rng(15)
    shapes = [(40, 8), (3,), (100, 2), (7, 7), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    results = []
    for elements in (toptim.RUN_ELEMENTS, 60):
        monkeypatch.setattr(toptim, 'RUN_ELEMENTS', elements)
        leaves = {str(i): _t(p) for i, p in enumerate(params)}
        optimizer = ttrain.SGD(lr=0.1, momentum=0.9)
        state = optimizer.init(leaves)
        for _ in range(2):
            optimizer.step(leaves, {str(i): _t(g) for i, g in
                                    enumerate(grads)}, state)
        results.append([leaf.numpy() for leaf in leaves.values()])
    assert list(toptim._runs([torch.zeros(40, 8), torch.zeros(3),
                              torch.zeros(100, 2)])) == [(0, 1), (1, 2),
                                                         (2, 3)]
    for got, want in zip(*results):
        _same(got, want)
