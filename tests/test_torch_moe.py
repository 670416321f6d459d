"""The port's MoE slice against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages. Routing is integer
work and matches bitwise (the renormalized gates too: the same float32
operations in the same order). The grouped kernels' plain versions match the
reference's Pallas kernels in interpret mode at atol 1e-5 (float32 sums in
another order). ``MoEMLP`` in float32 matches at the tolerances the
reference holds its fused impl to against its gather impl: output atol
1e-5, aux rtol 1e-6, gradients atol 2e-6 / rtol 1e-4; in bfloat16 at the
reference's own cross-impl tolerances (bfloat16 rounds at other points in
the two frameworks). The ``gpt2_tiny`` MoE model's features and three AdamW
steps match at 1e-5, as the dense model's do in ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.ops import moe as jmoe
from tpusystem.ops.pallas import grouped_matmul as jgm
from tpusystem.registry import gethash as jax_gethash
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import GPT2, gpt2_tiny
from tpusystem_torch.ops import moe as tmoe
from tpusystem_torch.ops.cuda import grouped_matmul as tgm
from tpusystem_torch.registry import gethash
from tpusystem_torch.serve import Engine

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


# --- routing, bitwise ---------------------------------------------------

def _gates(kind, tokens, experts, seed):
    rng = np.random.default_rng(seed)
    if kind == 'ties':        # few distinct values: exact ties everywhere
        values = rng.integers(0, 3, (tokens, experts)) / 8.0
    else:
        values = rng.random((tokens, experts))
        values = values / values.sum(-1, keepdims=True)
    return values.astype(np.float32)


@pytest.mark.parametrize('tokens,experts,k,factor', [
    (24, 4, 2, 1.25), (24, 4, 2, 0.5), (24, 4, 2, 8.0), (30, 6, 3, 1.0),
    (17, 4, 1, 0.75)])
@pytest.mark.parametrize('kind', ['ties', 'random'])
def test_routing_matches_bitwise(tokens, experts, k, factor, kind):
    """Exact ties, tight capacity with drops, and ample capacity."""
    gates = _gates(kind, tokens, experts, tokens + k)
    capacity = tmoe.expert_capacity(tokens, experts, k, factor)
    assert capacity == jmoe.expert_capacity(tokens, experts, k, factor)
    jgates, tgates = jnp.asarray(gates), torch.tensor(gates)

    for got, want, name in zip(tmoe.route_top_k(tgates, k, capacity),
                               jmoe.route_top_k(jgates, k, capacity),
                               ('dispatch', 'combine', 'fraction')):
        _same(got.numpy(), want, name)

    got = tmoe.route_top_k_sparse(tgates, k, capacity)
    want = jmoe.route_top_k_sparse(jgates, k, capacity)
    for g, w, name in zip(got, want, ('token_ids', 'slots', 'weights',
                                      'fraction')):
        _same(g.numpy(), w, name)
    slots = got[1]
    if factor < 1:
        assert (slots == experts * capacity).any()          # drops happen

    for g, w, name in zip(
            tmoe._invert_seating(slots, k, tokens, experts * capacity),
            jmoe._invert_seating(jnp.asarray(slots.numpy()), k, tokens,
                                 experts * capacity),
            ('slot_asg', 'slot_token', 'slots_by_choice')):
        _same(g.numpy(), w, name)


def test_seating_positions_and_capacity_match_bitwise():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5, 200)
    for got, want in zip(tmoe._seating_positions(torch.tensor(keys), 6),
                         jmoe._seating_positions(jnp.asarray(keys), 6)):
        _same(got.numpy(), want)
    for tokens in (1, 7, 64, 16384):
        for experts, k in ((4, 2), (8, 2), (8, 1), (3, 3)):
            for factor in (0.1, 0.75, 1.0, 1.25, 3.3):
                assert (tmoe.expert_capacity(tokens, experts, k, factor)
                        == jmoe.expert_capacity(tokens, experts, k, factor))
    assert tmoe.expert_capacity(16384, 8, 2, 1.25) == 5120


# --- the grouped kernels' plain versions vs the Pallas kernels ----------

def test_grouped_matmul_plain_versions_match_the_reference_kernels():
    """Mirrors the reference's kernel test: both orientations, sentinel
    rows, no bias and rows not saved (interpret mode off-TPU)."""
    rng = np.random.default_rng(3)
    tokens, dim, hidden_dim, experts, capacity = 48, 16, 24, 4, 12
    rows = experts * capacity
    src = rng.normal(size=(tokens, dim)).astype(np.float32)
    w1 = rng.normal(size=(experts, dim, hidden_dim)).astype(np.float32)
    ids = rng.integers(0, tokens + 1, rows).astype(np.int32)
    clamped = np.minimum(ids, tokens - 1)
    scale = ((ids < tokens) * rng.random(rows)).astype(np.float32)
    for transpose in (False, True):
        rhs = w1.transpose(0, 2, 1).copy() if transpose else w1
        want = jgm.gather_rows_matmul(
            jnp.asarray(src), jnp.asarray(rhs), jnp.asarray(clamped),
            jnp.asarray(scale), rows_per_group=capacity,
            transpose_rhs=transpose)
        got = tgm.gather_rows_matmul(
            torch.tensor(src), torch.tensor(rhs), torch.tensor(clamped),
            torch.tensor(scale), rows_per_group=capacity,
            transpose_rhs=transpose)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    lhs = rng.normal(size=(rows, hidden_dim)).astype(np.float32)
    w2 = rng.normal(size=(experts, hidden_dim, dim)).astype(np.float32)
    b2 = rng.normal(size=(experts, dim)).astype(np.float32)
    toks = np.concatenate([rng.choice(tokens, capacity, replace=False)
                           for _ in range(experts)]).astype(np.int32)
    toks[::7] = tokens                                 # sentinel slots
    weights = rng.random(rows).astype(np.float32)
    weights[toks >= tokens] = 0.0
    launches = tgm.matmul_scatter_rows.launches
    for transpose, bias, save_rows in ((False, b2, True),
                                       (True, None, False)):
        rhs = w2.transpose(0, 2, 1).copy() if transpose else w2
        options = dict(rows_per_group=capacity, transpose_rhs=transpose,
                       save_rows=save_rows)
        want_out, want_rows = jgm.matmul_scatter_rows(
            jnp.asarray(lhs), jnp.asarray(rhs),
            None if bias is None else jnp.asarray(bias), jnp.asarray(toks),
            jnp.asarray(weights), tokens, **options)
        out, got_rows = tgm.matmul_scatter_rows(
            torch.tensor(lhs), torch.tensor(rhs),
            None if bias is None else torch.tensor(bias), torch.tensor(toks),
            torch.tensor(weights), tokens, **options)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=1e-5)
        assert (got_rows is None) == (want_rows is None) == (not save_rows)
        if save_rows:
            np.testing.assert_allclose(got_rows.numpy(),
                                       np.asarray(want_rows), atol=1e-5)
    assert tgm.matmul_scatter_rows.launches == launches      # CPU: plain


def test_plain_combine_sums_each_token_in_row_order_in_its_dtype():
    """Rows of one token added in ascending row order from zero, every
    product and add rounded to the rows' dtype (bfloat16 here)."""
    rows = torch.tensor([[1.0], [2 ** -8], [2 ** -8], [3.0]]).bfloat16()
    out = tgm.combine_rows_plain(rows, torch.tensor([1, 0, 0, 2]),
                                 torch.tensor([1.0, 1.0, 1.0, 0.5]), 2)
    # token 0: 2**-8 + 2**-8 exactly; token 1: 1.0; token 2 is the sentinel
    assert out.dtype == torch.bfloat16
    assert out[:, 0].tolist() == [2 ** -7, 1.0]
    ordered = tgm.combine_rows_plain(
        torch.tensor([[1.0], [2 ** -9], [2 ** -9]]).bfloat16(),
        torch.tensor([0, 0, 0]), torch.ones(3), 1)
    assert ordered.item() == 1.0           # each small add rounds away


# --- MoEMLP ------------------------------------------------------------

def _hidden(dtype=np.float32, seed=17):
    return np.random.default_rng(seed).standard_normal((4, 16, 32)).astype(
        dtype)


def _reference_layer(hidden, **options):
    module = jmoe.MoEMLP(experts=4, k=2, **options)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(hidden))['params']
    return module, params


def _port_layer(params, **options):
    layer = tmoe.MoEMLP(32, 4, k=2, device='cpu', **options)
    layer.load_state_dict(params_from_jax(params))
    return layer


def _jax_value_and_grads(module, params, hidden):
    def loss(p, x):
        out, aux = module.apply({'params': p}, x)
        return jnp.mean(out.astype(jnp.float32) ** 2) + aux
    (out, aux) = module.apply({'params': params}, jnp.asarray(hidden))
    grads = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(hidden))
    return np.asarray(out, np.float32), float(aux), grads


def _port_value_and_grads(layer, hidden, dtype):
    x = torch.tensor(hidden).to(dtype).requires_grad_()
    out, aux = layer(x)
    loss = out.float().square().mean() + aux
    names = [name for name, _ in layer.named_parameters()]
    grads = torch.autograd.grad(loss, list(layer.parameters()) + [x])
    return (out.detach().float().numpy(), aux.item(),
            dict(zip(names + ['hidden'], grads)))


IMPLS = [('sparse', 'fused'), ('sparse', 'gather'), ('sparse', 'scatter'),
         ('dense', 'gather')]


@pytest.mark.parametrize('capacity_factor', [0.75, 4.0])   # drops / ample
@pytest.mark.parametrize('dispatch,sparse_impl', IMPLS)
def test_moe_mlp_matches_the_reference_in_float32(dispatch, sparse_impl,
                                                  capacity_factor):
    hidden = _hidden()
    options = dict(capacity_factor=capacity_factor, dispatch=dispatch,
                   sparse_impl=sparse_impl)
    module, params = _reference_layer(hidden, dtype=jnp.float32, **options)
    want_out, want_aux, (want_params, want_hidden) = _jax_value_and_grads(
        module, params, hidden)
    layer = _port_layer(params, dtype='float32', **options)
    launches = tgm.gather_rows_matmul.launches
    out, aux, grads = _port_value_and_grads(layer, hidden, torch.float32)
    assert tgm.gather_rows_matmul.launches == launches       # CPU: plain
    np.testing.assert_allclose(out, want_out, atol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    want = {**{name: np.asarray(g) for name, g in want_params.items()},
            'hidden': np.asarray(want_hidden)}
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name], atol=2e-6,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize('sparse_impl', ['fused', 'gather', 'scatter'])
def test_moe_mlp_matches_the_reference_in_bfloat16(sparse_impl):
    """The reference's bf16 cross-impl tolerances (its test_moe.py): rtol
    0.05 with atol 1e-4 for gathers and scatters, 2e-2 for the fused
    kernels' float32 accumulation."""
    hidden = _hidden()
    options = dict(capacity_factor=1.25, dispatch='sparse',
                   sparse_impl=sparse_impl)
    module, params = _reference_layer(hidden, dtype=jnp.bfloat16, **options)
    want_out, want_aux, (want_params, want_hidden) = _jax_value_and_grads(
        module, params, hidden)
    layer = _port_layer(params, dtype='bfloat16', **options)
    out, aux, grads = _port_value_and_grads(layer, hidden, torch.float32)
    tolerance = dict(rtol=0.05, atol=2e-2 if sparse_impl == 'fused' else 1e-4)
    np.testing.assert_allclose(out, want_out, rtol=0.05, atol=2e-2)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    want = {**{name: np.asarray(g, np.float32)
               for name, g in want_params.items()},
            'hidden': np.asarray(want_hidden, np.float32)}
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.float().numpy(), want[name],
                                   err_msg=name, **tolerance)


def test_moe_mlp_options_and_unported_paths():
    layer = tmoe.MoEMLP(8, 4, device='cpu')
    assert {name: tuple(p.shape) for name, p in layer.named_parameters()} == {
        'router': (8, 4), 'w1': (4, 8, 32), 'b1': (4, 32), 'w2': (4, 32, 8),
        'b2': (4, 8)}
    assert all(p.dtype == torch.float32 for p in layer.parameters())
    for option in ({'mesh': type('Mesh', (), {'size': 4})()},
                   {'exchange': 'ragged'}, {'schedule': object()}):
        with pytest.raises(NotImplementedError, match='queue 1: 9'):
            tmoe.MoEMLP(8, 4, device='cpu', **option)
    for option in ({'dispatch': 'ring'}, {'sparse_impl': 'atomic'}):
        with pytest.raises(ValueError):
            tmoe.MoEMLP(8, 4, device='cpu', **option)
    # full_capacity seats every assignment: no token drops
    hidden = torch.tensor(_hidden()[:, :, :8])
    full = tmoe.MoEMLP(8, 4, capacity_factor=0.1, full_capacity=True,
                       dtype='float32', device='cpu')
    full.load_state_dict(layer.state_dict())
    dense = tmoe.MoEMLP(8, 4, capacity_factor=64.0, dtype='float32',
                        device='cpu')
    dense.load_state_dict(layer.state_dict())
    np.testing.assert_allclose(full(hidden)[0].detach().numpy(),
                               dense(hidden)[0].detach().numpy(), atol=1e-6)


def test_init_draws_the_reference_distributions():
    """router normal(0.02); w1, w2 lecun_normal over fan_in = experts x
    input width (truncated at 2 std); biases 0."""
    layer = tmoe.MoEMLP(64, 8, device='cpu')
    assert abs(layer.router.std().item() - 0.02) < 1e-3
    for name, fan_in in (('w1', 8 * 64), ('w2', 8 * 256)):
        values = getattr(layer, name).detach()
        assert abs(values.std().item() * fan_in ** 0.5 - 1.0) < 0.02, name
        assert values.abs().max().item() <= 2 / 0.8796 * fan_in ** -0.5 + 1e-6
    assert not layer.b1.any() and not layer.b2.any()


# --- the slice: gpt2_tiny with experts -----------------------------------

MOE = dict(dtype='float32', moe_experts=4, moe_every=2,
           moe_sparse_impl='fused', attention='flash', return_features=True)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope='module')
def moe_slice():
    """Init params, first-step grads and three steps' losses of the
    reference's build_train_step on the MoE gpt2_tiny."""
    tokens = _tokens(11, (2, 32))
    module = jax_gpt2_tiny(**MOE)
    criterion = jtrain.WithAuxLoss(jtrain.ChunkedNextTokenLoss(chunks=4))
    optimizer = jtrain.AdamW(grad_clip=1.0)
    batch = jnp.asarray(tokens, jnp.int32)
    state = jtrain.init_state(module, optimizer, batch, rng=0)
    params = jax.tree.map(np.asarray, state.params)
    apply = jtrain.flax_apply(module)
    (features, table), aux = apply(state.params, batch, None, False)
    grads = jax.grad(lambda p: criterion(apply(p, batch, None, True),
                                         batch))(state.params)
    step = jtrain.build_train_step(apply, criterion, optimizer)
    losses = []
    for _ in range(3):
        state, (_, loss) = step(state, batch, batch)
        losses.append(float(loss))
    return dict(tokens=tokens, params=params, grads=jax.tree.map(
        np.asarray, grads), losses=losses, features=np.asarray(features),
        table=np.asarray(table), aux=float(aux))


def _port_moe_model(params):
    module = gpt2_tiny(device='cpu', **MOE)
    module.load_state_dict(params_from_jax(params))
    return module


def test_gpt2_moe_features_and_aux_match_jax(moe_slice):
    module = _port_moe_model(moe_slice['params'])
    assert [module.is_moe(i) for i in range(module.layers)] == [False, True]
    (features, table), aux = module(torch.as_tensor(moe_slice['tokens']))
    np.testing.assert_allclose(features.detach().numpy(),
                               moe_slice['features'], **TOL)
    _same(table.detach().numpy(), moe_slice['table'])
    np.testing.assert_allclose(aux.item(), moe_slice['aux'], rtol=1e-6)


def test_gpt2_moe_train_steps_match_jax(moe_slice):
    module = _port_moe_model(moe_slice['params'])
    criterion = ttrain.WithAuxLoss(ttrain.ChunkedNextTokenLoss(chunks=4))
    optimizer = ttrain.AdamW(grad_clip=1.0)
    state = ttrain.init_state(module, optimizer)
    apply = ttrain.module_apply(module)
    batch = torch.as_tensor(moe_slice['tokens'])
    loss = criterion(apply(state.params, batch, None, True), batch)
    grads = dict(zip(state.params, torch.autograd.grad(
        loss, list(state.params.values()))))
    want = {name: tensor.numpy() for name, tensor in
            params_from_jax(moe_slice['grads']).items()}
    assert set(grads) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    step = ttrain.build_train_step(apply, criterion, optimizer)
    losses = []
    for _ in range(3):
        state, (outputs, loss) = step(state, batch, batch)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, moe_slice['losses'], rtol=1e-5)
    assert losses[-1] < losses[0] and int(state.step) == 3
    (features, _), aux = outputs
    assert features.shape == (2, 32, 64) and aux.dim() == 0


def test_with_aux_loss_forwards_the_weight_and_adds_the_aux():
    inner = ttrain.ChunkedNextTokenLoss(chunks=2)
    criterion = ttrain.WithAuxLoss(inner, coef=0.5)
    tokens = torch.as_tensor(_tokens(12, (2, 6), vocab=10))
    tokens[0, 3:] = -1
    assert criterion.weight(tokens).item() == inner.weight(tokens).item() == 7
    features = torch.randn(2, 6, 4)
    table = torch.randn(10, 4)
    aux = torch.tensor(0.25)
    np.testing.assert_allclose(
        criterion(((features, table), aux), tokens).item(),
        inner((features, table), tokens).item() + 0.125, rtol=1e-6)
    assert not hasattr(ttrain.WithAuxLoss(ttrain.MSELoss()), 'weight')


@pytest.mark.parametrize('instance', [
    "WithAuxLoss(ChunkedNextTokenLoss(chunks=8))",
    "WithAuxLoss(NextTokenLoss(), coef=0.5)"])
def test_with_aux_loss_digest_matches_the_reference(instance):
    assert (gethash(eval(instance, vars(ttrain)))
            == jax_gethash(eval(instance, vars(jtrain))))


def test_gpt2_moe_registry_identity_matches_bitwise():
    options = dict(moe_experts=4, moe_every=2, moe_k=2,
                   moe_capacity_factor=1.5, moe_sparse_impl='fused')
    assert (gethash(gpt2_tiny(device='cpu', **options))
            == jax_gethash(jax_gpt2_tiny(**options)))


def test_params_from_jax_carries_an_moe_tree_name_for_name():
    tokens = jnp.asarray(_tokens(13, (1, 8)), jnp.int32)
    module = jax_gpt2_tiny(layers=3, moe_experts=2, moe_every=1)
    params = jax.jit(module.init)(jax.random.PRNGKey(4), tokens)['params']
    flat = params_from_jax(params)
    assert set(flat) >= {f'h_{i}.moe.{leaf}' for i in range(3)
                         for leaf in ('router', 'w1', 'b1', 'w2', 'b2')}
    port = gpt2_tiny(layers=3, moe_experts=2, moe_every=1, device='cpu')
    assert set(dict(port.named_parameters())) == set(flat)
    port.load_state_dict(flat)
    _same(port.h_2.moe.w2.detach().numpy(),
          np.asarray(params['h_2']['moe']['w2']))
    assert all(block.moe is not None for block in port.blocks())


def test_moe_decode_and_serving_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match='MoE serving'):
        GPT2(vocab_size=32, layers=2, dim=16, heads=2, max_seq=16,
             moe_experts=2, decode=True, device='cpu')
    module = gpt2_tiny(moe_experts=2, device='cpu')
    with pytest.raises(NotImplementedError, match='MoE serving'):
        module.replace(decode=True)(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(NotImplementedError, match='MoE serving'):
        Engine(module, None, rows=1, block_size=8, device='cpu')
    with pytest.raises(NotImplementedError, match='MoE serving'):
        ttrain.generate(module, None, [[1, 2, 3]], steps=2, device='cpu')


def test_replace_reaches_the_moe_layers_and_shares_their_weights():
    module = gpt2_tiny(moe_experts=4, moe_every=2, moe_sparse_impl='fused',
                       dtype='float32', return_features=True, device='cpu')
    clone = module.replace(moe_sparse_impl='gather', moe_capacity_factor=2.0)
    assert (clone.h_1.moe.sparse_impl, clone.h_1.moe.capacity_factor) == (
        'gather', 2.0)
    assert (module.h_1.moe.sparse_impl, module.h_1.moe.capacity_factor) == (
        'fused', 1.25)
    assert clone.h_1.moe.w1 is module.h_1.moe.w1 and clone.h_0 is module.h_0
    tokens = torch.as_tensor(_tokens(14, (2, 16)))
    apply = ttrain.module_apply(clone)
    params = {name: tensor.detach() + 0.0
              for name, tensor in module.named_parameters()}
    (features, _), _ = apply(params, tokens)
    (want, _), _ = clone(tokens)
    np.testing.assert_array_equal(features.numpy(), want.detach().numpy())
    with pytest.raises(ValueError, match='moe_experts'):
        module.replace(moe_experts=2)
