"""Twins of ``tests/test_parallel.py`` and of the reference's multi-device
tests that need a mesh of ranks: the port's meshes, collectives and
sharding policies (``tpusystem_torch.parallel``) against the JAX package.

The spec logic (``MeshSpec`` arithmetic, ``fsdp_shard_dim``, rules, the
models' ``partition_rules``) runs in this process over shape-only meshes,
spec for spec against the reference's own trees. Everything that needs
ranks runs in one world of four port processes (``tests/torch_ranks.py``:
torch, numpy and ``tpusystem_torch`` only, gloo on the CPU, the coordinator
on a free port), started once by a module fixture; the reference side runs
here on four of the eight virtual CPU devices, and weights cross as numpy
trees (``convert.params_from_jax`` in the workers). Tensor parallelism and
the combined ``data x fsdp x model`` mesh wait for ROADMAP 9c.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from tpusystem import parallel as jpar
from tpusystem import train as jtrain
from tpusystem.data.loader import ArrayDataset as JaxArrayDataset
from tpusystem.data.loader import Loader as JaxLoader
from tpusystem.models import MLP as JaxMLP
from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.models import resnet_tiny as jax_resnet_tiny
from tpusystem.parallel import collectives as jcol
from tpusystem.parallel.mesh import shard_map
from tpusystem_torch import parallel as tpar
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import GPT2, MLP, ResNet, gpt2_tiny
from tpusystem_torch.parallel import sharding as tshard
from tpusystem_torch.parallel.mesh import AXES, Mesh
from tpusystem_torch.parallel.mesh import PartitionSpec as P
from tpusystem_torch.train import Adam, init_state

from tests import torch_ranks

RANKS = 4
RTOL = 2e-5          # the reference's own (tests/test_parallel.py:135)


def shaped(**sizes) -> Mesh:
    """A shape-only mesh: the axis sizes the spec logic reads, no ranks."""
    return Mesh(torch.device('cpu'), None, sizes)


def ref_mesh(**sizes):
    return jpar.MeshSpec(**sizes).build(jax.devices()[:RANKS])


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_path(path: str) -> str:
    """The port's name of a reference path: an MLP's ``Dense_i/kernel`` is
    a ``Linear``'s ``Dense_i/weight``."""
    return path.replace('/kernel', '/weight') if path.startswith('Dense_') \
        else path


def keypath(path) -> str:
    return '/'.join(str(getattr(entry, 'key', entry)) for entry in path)


# ---------------------------------------------------------------------------
# spec logic, in this process


def test_mesh_spec_wildcard_resolution():
    for sizes, count in (({'data': -1, 'model': 2}, 8), ({'fsdp': -1}, 4),
                         ({'data': 2, 'fsdp': -1, 'stage': 2}, 8)):
        assert (tpar.MeshSpec(**sizes).resolved_sizes(count)
                == jpar.MeshSpec(**sizes).resolved_sizes(count))
    for size, count in ((4, 8), (1, 1)):
        assert (tpar.MeshSpec(data=size).resized(count).sizes
                == jpar.MeshSpec(data=size).resized(count).sizes)


def test_mesh_spec_errors():
    for sizes, count, match in (({'data': -1, 'model': -1}, 8, 'only one'),
                                ({'data': -1, 'model': 3}, 8, 'not divisible'),
                                ({'data': 4}, 8, 'wants')):
        with pytest.raises(ValueError, match=match):
            tpar.MeshSpec(**sizes).resolved_sizes(count)
        with pytest.raises(ValueError, match=match):
            jpar.MeshSpec(**sizes).resolved_sizes(count)
    # no process group: one device, so four wanted is the reference's error
    with pytest.raises(ValueError, match='wants'):
        tpar.MeshSpec(data=4).build([torch.device('cpu')])


def test_mesh_spec_identity_distinguishes_layouts():
    from tpusystem.registry import gethash as jax_gethash
    from tpusystem_torch.registry import gethash
    assert gethash(tpar.MeshSpec(data=4, model=2)) != gethash(
        tpar.MeshSpec(data=2, model=4))
    for sizes in ({'data': 4, 'model': 2}, {'fsdp': -1}):
        assert gethash(tpar.MeshSpec(**sizes)) == jax_gethash(
            jpar.MeshSpec(**sizes))


def test_single_device_mesh_works():
    mesh = tpar.single_device_mesh('cpu')
    assert mesh.size == 1 and not mesh.distributed
    assert mesh.shape == {axis: 1 for axis in AXES}
    assert tuple(mesh.axis_names) == tuple(
        jpar.single_device_mesh().axis_names)


def test_fsdp_policy_shards_largest_divisible_dim():
    params = {'dense': {'kernel': np.zeros((24, 64)), 'bias': np.zeros((64,))},
              'tiny': np.zeros((2, 2)),
              'tie': np.zeros((32, 32, 8))}
    specs = tshard.FullyShardedDataParallel(min_size=16).tree_specs(
        params, shaped(fsdp=8))
    want = jpar.FullyShardedDataParallel(min_size=16).tree_specs(
        params, jpar.MeshSpec(fsdp=-1).build())
    assert specs['dense']['kernel'] == P(None, 'fsdp')  # 64 > 24
    assert specs['dense']['bias'] == P('fsdp')
    assert specs['tiny'] == P()  # below min_size
    assert specs['tie'] == P('fsdp')        # a tie: the lowest index
    for path, spec in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda leaf: isinstance(leaf, JP))[0]:
        node = specs
        for entry in path:
            node = node[entry.key]
        assert tuple(node) == tuple(spec), keypath(path)
    for shape in ((24, 64), (64, 64), (6, 9), (8, 16, 16), (3,)):
        for size in (2, 4, 8):
            for taken in ((), (0,), (1,)):
                assert tshard.fsdp_shard_dim(shape, size, taken) == \
                    jpar.sharding.fsdp_shard_dim(shape, size, taken)


def test_tensor_parallel_rules_with_fsdp_fallback():
    rules = [(r'attention/query/kernel$', P(None, 'model')),
             (r'mlp/out/kernel$', P('model', None))]
    params = {
        'attention': {'query': {'kernel': np.zeros((16, 32))}},
        'mlp': {'out': {'kernel': np.zeros((32, 16))}},
        'embed': {'kernel': np.zeros((64, 8))},
    }
    specs = tshard.TensorParallel(rules, fsdp=True, fsdp_min_size=16
                                  ).tree_specs(params, shaped(fsdp=2, model=4))
    want = jpar.TensorParallel(
        [(pattern, JP(*spec)) for pattern, spec in rules], fsdp=True,
        fsdp_min_size=16).tree_specs(params,
                                     jpar.MeshSpec(fsdp=2, model=4).build())
    assert specs['attention']['query']['kernel'] == P('fsdp', 'model')
    assert specs['mlp']['out']['kernel'] == P('model', 'fsdp')
    assert specs['embed']['kernel'] == P('fsdp')
    for path, spec in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda leaf: isinstance(leaf, JP))[0]:
        node = specs
        for entry in path:
            node = node[entry.key]
        assert tuple(node) == tuple(spec), keypath(path)


def test_rule_axis_dropped_when_not_divisible():
    policy = tshard.ShardingPolicy(rules=[(r'kernel$', P(None, 'model'))])
    specs = policy.tree_specs({'kernel': np.zeros((4, 6))}, shaped(model=8))
    assert specs['kernel'] == P()          # 6 % 8 != 0


def test_optimizer_state_inherits_param_rules():
    """Adam's mu/nu paths end with the parameter's, so one rule covers
    both; the port's ``Linear`` weight is the reference's kernel
    transposed, so its rule names the other dimension."""
    module = MLP(features=(32,), classes=8, device='cpu')
    state = init_state(module, Adam())
    policy = tshard.TensorParallel(
        rules=[(r'Dense_\d+/weight$', P('model', None))])
    specs = policy.tree_specs(state, shaped(data=4, model=2))
    assert specs.params['Dense_0.weight'] == P('model')
    assert specs.opt_state['mu']['Dense_0.weight'] == P('model')
    assert specs.opt_state['nu']['Dense_1.weight'] == P('model')
    assert specs.opt_state['count'] == P()
    reference = jtrain.init_state(JaxMLP(features=(32,), classes=8),
                                  jtrain.Adam(), jnp.zeros((4, 28, 28)))
    want = jpar.TensorParallel(rules=[(r'Dense_\d+/kernel$',
                                       JP(None, 'model'))]).tree_specs(
        reference, jpar.MeshSpec(data=-1, model=2).build())
    assert JP(None, 'model') in jax.tree.leaves(
        want.opt_state, is_leaf=lambda leaf: isinstance(leaf, JP))


def test_model_partition_rules_are_the_references():
    """GPT-2's rules (the scanned ``hs/`` and MoE forms included) and
    ResNet's, pattern for pattern; over gpt2_tiny's tree under
    ``TensorParallel(rules, fsdp=True)`` on an fsdp=4 mesh the specs equal
    the reference's: a rule's ``model`` entry claims its dimension even at
    ``model=1``, so FSDP takes another."""
    from tpusystem.models import GPT2 as JaxGPT2
    from tpusystem.models.resnet import ResNet as JaxResNet
    for port, reference in ((GPT2, JaxGPT2), (ResNet, JaxResNet)):
        got = [(pattern, tuple(spec)) for pattern, spec
               in port.partition_rules()]
        want = [(pattern, tuple(spec)) for pattern, spec
                in reference.partition_rules()]
        assert got == want
    for scan in (False, True):
        jmodule = jax_gpt2_tiny(scan_layers=scan)
        params = jax.eval_shape(lambda: jmodule.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))['params']
        want = jpar.TensorParallel(JaxGPT2.partition_rules(), fsdp=True,
                                   fsdp_min_size=64).tree_specs(
            params, jpar.MeshSpec(fsdp=4).build(jax.devices()[:4]))
        module = gpt2_tiny(device='cpu', scan_layers=scan)
        got = tshard.TensorParallel(GPT2.partition_rules(), fsdp=True,
                                    fsdp_min_size=64).tree_specs(
            dict(module.named_parameters()), shaped(fsdp=4))
        flat = {keypath(path): tuple(spec) for path, spec in
                jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda leaf: isinstance(leaf, JP))[0]}
        assert {name.replace('.', '/'): tuple(spec)
                for name, spec in got.items()} == flat


def test_constraints_are_the_identity_at_size_one_and_name_9f():
    value = torch.ones(4, 2)
    assert tshard.constrain_table_rows(value, shaped(fsdp=4)) is value
    assert tshard.constrain_expert_major(value, None) is value
    for constrain, sizes in ((tshard.constrain_table_rows, {'model': 2}),
                             (tshard.constrain_expert_major, {'expert': 2})):
        with pytest.raises(NotImplementedError, match='9f'):
            constrain(value, shaped(**sizes))
    assert tuple(tshard.table_row_spec(2)) == tuple(
        jpar.sharding.table_row_spec(2))
    assert tuple(tshard.expert_major_spec(3)) == tuple(
        jpar.sharding.expert_major_spec(3))
    with pytest.raises(NotImplementedError, match='9d'):
        tpar.collectives.pp_hop('stage', 1, value)


# ---------------------------------------------------------------------------
# a world of four port processes


def _digits():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(64, 28, 28)).astype(np.float32),
            rng.integers(0, 10, size=(64,)).astype(np.int32))


def _lm_batch():
    """gpt2_tiny tokens [8, 16] and targets whose pads (-1) fall unevenly
    over the four ranks' rows: rank 0 holds 19 of them, rank 3 none."""
    tokens = np.random.default_rng(1).integers(0, 256, (8, 16)).astype(
        np.int64)
    targets = tokens.copy()
    targets[0, 4:] = -1
    targets[1, 9:] = -1
    targets[2, 13:] = -1
    targets[5, 15:] = -1
    return tokens, targets


def _flip(leaf_path: str, index: int, port_order: list, shapes: dict):
    """The reference's flat ``index`` into leaf ``leaf_path`` as the port's
    leaf position and flat index (a Linear's weight is transposed)."""
    port = port_path(leaf_path)
    name = port.replace('/', '.')
    shape = shapes[leaf_path]
    if port != leaf_path:
        index = int(np.ravel_multi_index(
            np.unravel_index(index, shape)[::-1], shape[::-1]))
    return port_order.index(name), index


FLIPS = {'data4': ('Dense_0/kernel', 1, 2, 5, 12),
         'data2_model2': ('Dense_0/kernel', 1, 0, 3, 9),
         'drill': ('Dense_0/bias', 0, 1, 0, 30)}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """One run of every scenario over four gloo ranks, and the reference
    inputs it was given."""
    root = tmp_path_factory.mktemp('ranks')
    mlp = jtrain.init_state(JaxMLP(features=(64,), classes=10, dropout=0.0),
                            jtrain.Adam(lr=1e-2), jnp.zeros((8, 28, 28)),
                            rng=0).params
    parity = jtrain.init_state(JaxMLP(features=(16,), classes=10,
                                      dropout=0.0), jtrain.Adam(lr=1e-2),
                               jnp.zeros((1, 28, 28)), rng=1).params
    gpt2 = jax_gpt2_tiny(attention='xla', dtype='float32').init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))['params']
    images = np.random.default_rng(0).normal(size=(16, 16, 16, 3)).astype(
        np.float32)
    labels = np.random.default_rng(0).integers(0, 10, (16,)).astype(np.int64)
    resnet = jtrain.init_state(jax_resnet_tiny(), jtrain.AdamW(lr=1e-3),
                               jnp.asarray(images[:1])).params
    port_order = list(dict(MLP(features=(16,), classes=10,
                               device='cpu').named_parameters()))
    shapes = {keypath(path): leaf.shape for path, leaf in
              jax.tree_util.tree_flatten_with_path(parity)[0]}
    flips = {}
    for name, (path, ref_leaf, replica, index, bit) in FLIPS.items():
        leaf, at = _flip(path, index, port_order, shapes)
        flips[name] = dict(replica=replica, leaf=leaf, index=at, bit=bit)
    loader = (np.arange(40 * 3, dtype=np.float32).reshape(40, 3),
              np.arange(40, dtype=np.int64))
    inputs = dict(scenarios=['layouts', 'mlp', 'collectives', 'loader', 'lm',
                             'parity', 'checkpoint', 'resnet', 'guarded'],
                  mlp=numpy_tree(mlp), parity=numpy_tree(parity),
                  gpt2=numpy_tree(gpt2), resnet=numpy_tree(resnet),
                  digits=_digits(), lm=_lm_batch(), images=(images, labels),
                  loader=loader, flips=flips, root=str(root / 'ckpt'))
    results = torch_ranks.launch(root, inputs, RANKS)
    return dict(inputs=inputs, ranks=results)


def _coordinate(mesh, rank: int) -> dict:
    device = jax.devices()[rank]
    where = np.argwhere(mesh.devices == device)[0]
    return dict(zip(mesh.axis_names, (int(index) for index in where)))


def test_mesh_over_ranks_is_the_references(world):
    """Each rank sits where the reference's device of the same index does,
    every axis kept (size 1 included), on gloo's device."""
    for name, sizes in (('data', {'data': -1}), ('fsdp', {'fsdp': -1}),
                        ('data_fsdp', {'data': 2, 'fsdp': 2}),
                        ('data_model', {'data': -1, 'model': 2})):
        mesh = ref_mesh(**sizes)
        for rank, result in enumerate(world['ranks']):
            layout = result['layouts'][name]
            assert layout['shape'] == dict(mesh.shape)
            assert layout['coordinate'] == _coordinate(mesh, rank)
            assert layout['device'] == 'cpu'
    for result in world['ranks']:
        assert '9c. Tensor parallelism' in result['model_axis']


def _train_losses(mesh, policy, batch, steps=4):
    module = JaxMLP(features=(64,), classes=10, dropout=0.0)
    optimizer = jtrain.Adam(lr=1e-2)
    state = jtrain.init_state(module, optimizer, jnp.zeros((8, 28, 28)), rng=0)
    state = policy.place(state, mesh)
    inputs = jax.device_put(batch[0], jpar.batch_sharding(mesh))
    targets = jax.device_put(batch[1], jpar.batch_sharding(mesh))
    step = jtrain.build_train_step(jtrain.flax_apply(module),
                                   jtrain.CrossEntropyLoss(), optimizer)
    losses = []
    for _ in range(steps):
        state, (_, loss) = step(state, inputs, targets)
        losses.append(float(loss))
    return losses, state


@pytest.mark.slow
def test_dp_matches_single_device_numerics(world):
    want, _ = _train_losses(ref_mesh(data=-1), jpar.DataParallel(),
                            _digits())
    for result in world['ranks']:
        np.testing.assert_allclose(result['dp_losses'], want, rtol=RTOL)


def test_fsdp_matches_single_device_and_actually_shards(world):
    """FSDP losses over four ranks equal the reference's within its own
    rtol, and each rank's piece of ``Dense_0`` has the reference's
    addressable shard shape (transposed: the port's weight is a
    ``Linear``'s). Its slots are split alike; DP holds whole leaves."""
    want, state = _train_losses(ref_mesh(fsdp=-1),
                                jpar.FullyShardedDataParallel(min_size=64),
                                _digits())
    kernel = state.params['Dense_0']['kernel']
    shard = kernel.addressable_shards[0].data.shape
    assert shard == (784 // RANKS, 64)
    for result in world['ranks']:
        np.testing.assert_allclose(result['fsdp_losses'], want, rtol=RTOL)
        assert result['fsdp_shards']['Dense_0.weight'] == shard[::-1]
        assert result['fsdp_slot_shards'] == result['fsdp_shards']
        assert result['fsdp_shards']['Dense_1.bias'] == (10,)  # < min_size
        assert result['dp_shards']['Dense_0.weight'] == (64, 784)


class TestCollectiveVocabulary:
    """The collectives over the ``data`` axis of four ranks, each rank's
    output in rank order against the reference's ``shard_map`` over four
    devices (``out_specs=P('data')``)."""

    def _mapped(self, fn, values, n=RANKS):
        mesh = jpar.MeshSpec(data=n).build(jax.devices()[:n])
        return np.asarray(shard_map(fn, mesh=mesh, in_specs=JP('data'),
                                    out_specs=JP('data'))(values))

    def _port(self, world, key, ranks=range(RANKS)):
        return np.concatenate([world['ranks'][rank]['collectives'][key]
                               for rank in ranks])

    def test_reductions_and_gather(self, world):
        values = jnp.arange(4.0)
        for key, fn in (
                ('sum', lambda x: jcol.all_reduce_sum(x, 'data')),
                ('mean', lambda x: jcol.all_reduce_mean(x, 'data')),
                ('gather', lambda x: jcol.all_gather(x, 'data')),
                ('stacked', lambda x: jcol.all_gather(x, 'data',
                                                      tiled=False))):
            np.testing.assert_array_equal(self._port(world, key),
                                          self._mapped(fn, values), key)
        rows = jnp.concatenate([jnp.arange(6.0).reshape(2, 3) + 10 * rank
                                for rank in range(RANKS)])
        ring = self._mapped(lambda x: jcol.ring_allgather(x, 'data',
                                                          chunks=2), rows)
        np.testing.assert_array_equal(self._port(world, 'ring_gather'), ring)
        np.testing.assert_array_equal(self._port(world, 'gather_rows'), ring)
        for rank, result in enumerate(world['ranks']):
            assert result['collectives']['index'] == rank
            assert result['collectives']['size'] == RANKS

    def test_reduce_scatter_and_ring_shift(self, world):
        scattered = self._mapped(lambda x: jcol.reduce_scatter(x[0], 'data'),
                                 jnp.ones((4, 4)))
        np.testing.assert_array_equal(self._port(world, 'scatter'), scattered)
        np.testing.assert_array_equal(self._port(world, 'shift'), [3, 0, 1, 2])
        np.testing.assert_array_equal(
            self._port(world, 'shift'),
            self._mapped(lambda x: jcol.ring_shift(x, 'data'),
                         jnp.arange(4.0)))
        np.testing.assert_array_equal(self._port(world, 'back'), [1, 2, 3, 0])
        blocks = jnp.concatenate([jnp.arange(16.0).reshape(8, 2) * (rank + 1)
                                  for rank in range(RANKS)])
        want = self._mapped(lambda x: jcol.ring_reducescatter(x, 'data'),
                            blocks)
        np.testing.assert_array_equal(self._port(world, 'ring_scatter'), want)
        np.testing.assert_array_equal(self._port(world, 'scatter_rows'), want)

    def test_all_to_all_shard_transpose(self, world):
        data = jnp.arange(8.0).reshape(2, 4)   # each shard [1, 4]
        swapped = self._mapped(
            lambda x: jcol.all_to_all(x, 'data', split_dimension=1,
                                      concat_dimension=0), data, n=2)
        np.testing.assert_array_equal(swapped,
                                      [[0, 1], [4, 5], [2, 3], [6, 7]])
        # data coordinates 0 and 1 at fsdp coordinate 0: ranks 0 and 2
        np.testing.assert_array_equal(self._port(world, 'all_to_all',
                                                 (0, 2)), swapped)

    def test_gradients_run_the_dual_collective(self, world):
        """The gather's backward reduce-scatters, the reduce-scatter's
        gathers, the all-to-all's swaps back."""
        weights = np.arange(12.0)
        for rank, result in enumerate(world['ranks']):
            got = result['collectives']
            np.testing.assert_array_equal(
                got['gather_grad'], RANKS * weights[3 * rank:3 * rank + 3])
            np.testing.assert_array_equal(got['scatter_grad'],
                                          np.repeat(np.arange(1.0, 5.0), 2))
            np.testing.assert_array_equal(
                got['all_to_all_grad'],
                [1, 2, 1, 2] if rank < 2 else [3, 4, 3, 4])


@pytest.mark.parametrize('shuffle', [False, True])
def test_loader_rows_are_the_reference_shard(world, shuffle):
    """Each rank's rows of every batch (two epochs) are bit for bit those
    of the reference's device at the same coordinate of a data=2 x fsdp=2
    mesh."""
    features, targets = world['inputs']['loader']
    mesh = ref_mesh(data=2, fsdp=2)
    loader = JaxLoader(JaxArrayDataset(features, targets.astype(np.int32)),
                       8, shuffle=shuffle, seed=3,
                       sharding=jpar.batch_sharding(mesh))
    batches = [batch for _ in range(2) for batch in loader]
    devices = list(jax.devices())
    for rank, result in enumerate(world['ranks']):
        rows = result['loader'][shuffle]
        assert len(rows) == len(batches) == 10
        for got, batch in zip(rows, batches):
            for leaf, array in zip(got, batch):
                shard = next(shard for shard in array.addressable_shards
                             if devices.index(shard.device) == rank)
                np.testing.assert_array_equal(
                    leaf, np.asarray(shard.data).astype(leaf.dtype))
                assert leaf.shape[0] == 2


def test_masked_next_token_loss_under_dp_and_fsdp(world):
    """Pads spread unevenly over the ranks' rows: the global loss and the
    summed gradients equal the reference's whole-batch ``value_and_grad``
    (the mean over unmasked tokens, not the mean of the ranks' means)."""
    tokens, targets = world['inputs']['lm']
    module = jax_gpt2_tiny(attention='xla', dtype='float32')
    params = jax.tree.map(jnp.asarray, world['inputs']['gpt2'])
    apply = jtrain.flax_apply(module)

    def loss_fn(params):
        return jtrain.NextTokenLoss()(apply(params, jnp.asarray(tokens),
                                            None, True),
                                      jnp.asarray(targets))
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want = params_from_jax(numpy_tree(grads))
    rank_means = []
    for result in world['ranks']:
        for name in ('dp', 'fsdp'):
            got = result[f'lm_{name}']
            np.testing.assert_allclose(got['loss'], float(loss), rtol=RTOL)
            for key, grad in want.items():
                np.testing.assert_allclose(got['grads'][key], grad.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=key)
    # the trap this pins: the plain mean of each rank's masked mean differs
    for rank in range(RANKS):
        rows = slice(2 * rank, 2 * rank + 2)
        rank_means.append(float(jtrain.NextTokenLoss()(
            apply(params, jnp.asarray(tokens[rows]), None, True),
            jnp.asarray(targets[rows]))))
    assert abs(np.mean(rank_means) - float(loss)) > 1e-3


def _checksums(mesh, flip):
    state = jtrain.init_state(JaxMLP(features=(16,), classes=10,
                                     dropout=0.0), jtrain.Adam(lr=1e-2),
                              jnp.zeros((1, 28, 28)), rng=1)
    state = jax.tree.map(lambda leaf: jax.device_put(
        leaf, jpar.replicated(mesh)), state)
    clean, paths = jcol.replica_checksums(state.params, mesh)
    _, leaf, replica, index, bit = flip
    corrupted = jpar.FlipParamBit(replica=replica, leaf=leaf, index=index,
                                  bit=bit)(state.params, mesh)
    flipped, _ = jcol.replica_checksums(corrupted, mesh)
    verdict = jtrain.Sentinel().check_parity(
        state.replace(params=corrupted), mesh, raise_on_mismatch=False)
    paths = [path.replace("']['", '/').strip("[]'") for path in paths]
    return clean, flipped, paths, verdict


class TestParity:
    """``test_sentinel.py::TestParity`` over four ranks: the checksum
    matrices bit for bit (columns by path), a flip attributed to the same
    replica and leaf. On data=2 x model=2 a leaf replicated over ``model``
    counts twice, as in the reference."""

    def _compare(self, world, name, sizes):
        clean, flipped, paths, verdict = _checksums(ref_mesh(**sizes),
                                                    FLIPS[name])
        for result in world['ranks']:
            got = result['parity'][name]
            order = [got['paths'].index(port_path(path)) for path in paths]
            np.testing.assert_array_equal(got['clean'][:, order], clean)
            np.testing.assert_array_equal(got['flipped'][:, order], flipped)
            replicas, leaves = got['verdict']
            assert replicas == verdict[0]
            assert leaves == [port_path(leaf.replace("']['", '/').strip(
                "[]'")) for leaf in verdict[1]]
        return clean, verdict

    def test_replicas_agree_and_flip_is_attributed(self, world):
        clean, verdict = self._compare(world, 'data4', {'data': 4})
        assert clean.shape == (4, 4) and bool(np.all(clean == clean[0]))
        assert verdict[0] == [2] and len(verdict[1]) == 1

    def test_two_replica_tie_reports_both_sides(self, world):
        clean, verdict = self._compare(world, 'data2_model2',
                                       {'data': 2, 'model': 2})
        assert verdict[0] == [0, 1] and len(verdict[1]) == 1

    def test_flip_detected_before_next_checkpoint_commits(self, world):
        for result in world['ranks']:
            drill = result['parity']['drill']
            assert drill['clean'] and 'replica' in drill['raised']
            assert drill['latest'] == 1          # nothing contaminated
            assert drill['replicas'] == [[1]]


def test_restore_onto_sharded_target(world):
    """A state saved whole lands on a replicated and on an FSDP placement,
    each rank's piece equal to its slice of the saved leaf."""
    for result in world['ranks']:
        report = result['checkpoint']
        assert report['replicated']['replicated'] and \
            report['replicated']['equal']
        assert report['replicated']['shape'] == (64, 784)
        assert report['fsdp']['equal'] and report['fsdp']['shape'] == (
            64, 784 // RANKS)


def test_sharded_leaf_reshards_bit_for_bit(world):
    """Four ranks' fsdp=4 pieces merge and land on data=2 x fsdp=2 slice
    boundaries bit for bit; without ``reshard`` another layout is
    refused."""
    for result in world['ranks']:
        reshard = result['checkpoint']['reshard']
        assert reshard == dict(exact=True, refused=True, pieces=RANKS)


def test_placed_save_on_a_mesh_without_rank_zero_commits(world):
    """A state placed by FSDP on a mesh over ranks 1-3 of the four is
    saved by the mesh's first rank, not by global rank 0 (outside the
    mesh): every rank sees the step committed and restores it whole."""
    for rank, result in enumerate(world['ranks']):
        report = result['checkpoint']['submesh']
        assert report['latest'] == 0 and report['equal']
        if rank:
            assert report['shards']['Dense_0.weight'] == (16, 784)
            assert report['shards']['Dense_1.weight'] == (10, 16)


def test_resnet_data_parallel(world):
    """``test_models.py::test_resnet_data_parallel`` at resnet_tiny over
    four ranks: the loss equals the reference's one-device step within
    the ResNet parity tests' 1e-5."""
    images, labels = world['inputs']['images']
    module = jax_resnet_tiny()
    optimizer = jtrain.AdamW(lr=1e-3)
    state = jtrain.init_state(module, optimizer, jnp.asarray(images[:1]))
    step = jtrain.build_train_step(jtrain.flax_apply(module),
                                   jtrain.CrossEntropyLoss(), optimizer)
    _, (_, loss) = step(state, jnp.asarray(images),
                        jnp.asarray(labels.astype(np.int32)))
    for result in world['ranks']:
        np.testing.assert_allclose(result['resnet_loss'], float(loss),
                                   rtol=1e-5, atol=1e-5)


def _guarded_rows(mesh, policy, stack):
    """The reference's health rows: two calls of ``build_multi_step(
    guard=True)``, two guarded, clipped AdamW steps each."""
    module = JaxMLP(features=(64,), classes=10, dropout=0.0)
    optimizer = jtrain.AdamW(lr=1e-2, grad_clip=0.5)
    guard = jtrain.Guard()
    state = guard.arm(jtrain.init_state(module, optimizer,
                                        jnp.zeros((8, 28, 28)), rng=0))
    state = policy.place(state, mesh)
    batch = jax.device_put(stack, jpar.stacked_batch_sharding(mesh))
    multi = jtrain.build_multi_step(jtrain.build_train_step(
        jtrain.flax_apply(module), jtrain.CrossEntropyLoss(), optimizer,
        guard=guard), guard=True)
    rows = []
    for _ in range(2):
        state, (_, health) = multi(state, *batch)
        rows.append(np.asarray(health))
    return np.concatenate(rows)


def test_guarded_multi_step_on_a_placed_state(world):
    """``build_multi_step(guard=True)`` over a guarded, clipped AdamW step
    on an FSDP-placed state: the health rows' ok, loss and grad norm equal
    the reference's on an fsdp=4 mesh, and the port's unplaced steps',
    within the reference's rtol. The grad norm sums the squares of each
    rank's own pieces once, so the clip and the guard see the global
    norm."""
    images, labels = _digits()
    stack = (images.reshape(2, 32, 28, 28),
             labels.astype(np.int32).reshape(2, 32))
    want = _guarded_rows(ref_mesh(fsdp=-1),
                         jpar.FullyShardedDataParallel(min_size=64), stack)
    for result in world['ranks']:
        rows = result['guarded']
        assert rows['fsdp'].shape == rows['unplaced'].shape == want.shape \
            == (4, 4)
        assert bool(np.all(rows['fsdp'][:, 0] == 1.0))
        assert bool(np.all(rows['fsdp'][:2, 2] > 0.5))  # the clip bites
        for other in (want, rows['unplaced']):
            np.testing.assert_allclose(rows['fsdp'][:, :3], other[:, :3],
                                       rtol=RTOL, atol=1e-6)
            # the z-score divides the norm's float32 noise (an ulp here) by
            # the EMA's small spread: held to 1e-3
            np.testing.assert_allclose(rows['fsdp'][:, 3], other[:, 3],
                                       rtol=1e-3)
