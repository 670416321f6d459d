"""Twins of ``tests/test_pipeline.py`` (``:38-459``) and of
``tests/test_schedule.py``'s pipelined tests (``:667``, ``:696``, ``:799``,
``:822``, ``:872``): the port's pipelines
(``tpusystem_torch/parallel/pipeline.py``, ``GPT2Pipelined``,
``build_1f1b_train_step``) against the JAX package.

The multi-rank cases run in one world of eight port processes
(``tests/torch_ranks.py``'s ``pipeline`` scenario, gloo on the CPU) on the
reference tests' meshes; the reference side runs here on the eight virtual
devices, from the same numpy weights and tokens, and each twin holds the
port to the reference test's tolerance. Pure accounting (the stash bound,
the schedule's units), the placements' specs and the refusals run here.

Without a twin: ``test_compile_guard_composed_pipelined_step_never_retraces``
(``tests/test_schedule.py:838``) pins that a jitted step traces once; the
port's step is eager and has no trace to repeat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import parallel as jpar
from tpusystem import train as jtrain
from tpusystem.models import GPT2Pipelined as JaxGPT2Pipelined
from tpusystem.parallel import pipeline as jpipe
from tpusystem.registry import gethash as jax_gethash
from tpusystem_torch import parallel as tpar
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import GPT2Pipelined
from tpusystem_torch.parallel import pipeline as tpipe
from tpusystem_torch.parallel.mesh import Mesh
from tpusystem_torch.registry import gethash

from tests import torch_ranks

RANKS = 8
SMALL = dict(vocab_size=64, layers=4, dim=32, heads=4, max_seq=32,
             dtype='float32', microbatches=2)
WIDE = dict(vocab_size=256, layers=4, dim=64, heads=4, max_seq=64,
            dtype='float32', microbatches=8)
NARROW = dict(vocab_size=128, layers=4, dim=32, heads=2, max_seq=32,
              dtype='float32')
MOE = dict(vocab_size=256, layers=4, dim=48, heads=4, max_seq=64,
           dtype='float32', microbatches=2, moe_experts=2, moe_every=2,
           moe_capacity_factor=2.0)


def shaped(**sizes) -> Mesh:
    """A shape-only port mesh: the axis sizes the specs read, no ranks."""
    return Mesh('cpu', None, sizes)


def jmesh(**sizes):
    count = int(np.prod(list(sizes.values())))
    return jpar.MeshSpec(**sizes).build(jax.devices()[:count])


def _tokens(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.int32)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    """A JAX param tree's leaves under the port's dotted names."""
    return {name: tensor.numpy() for name, tensor in
            params_from_jax(_numpy(tree)).items()}


def _reference_steps(model, tokens, targets, optimizer, path, steps=1,
                     policy=None, criterion=None):
    criterion = criterion or jtrain.NextTokenLoss()
    state = jtrain.init_state(model, optimizer, jnp.abs(tokens[:1]), rng=0)
    placed_tokens, placed_targets = jnp.asarray(tokens), jnp.asarray(targets)
    if policy is not None:
        state = policy.place(state, model.mesh)
        sharding = jpar.batch_sharding(model.mesh)
        placed_tokens = jax.device_put(placed_tokens, sharding)
        placed_targets = jax.device_put(placed_targets, sharding)
    step = (jtrain.build_train_step(jtrain.flax_apply(model), criterion,
                                    optimizer) if path == 'gpipe'
            else jtrain.build_1f1b_train_step(model, criterion, optimizer))
    losses = []
    for _ in range(steps):
        state, (_, loss) = step(state, placed_tokens, placed_targets)
        losses.append(float(loss))
    return dict(losses=losses, params=_flat(state.params))


def _init_params(model, tokens, optimizer=None):
    """The weights ``init_state(rng=0)`` draws (what the port loads)."""
    optimizer = optimizer or jtrain.SGD(lr=0.1)
    return _numpy(jtrain.init_state(model, optimizer,
                                    jnp.abs(jnp.asarray(tokens[:1])),
                                    rng=0).params)


def _pp_stack():
    layers, batch, dim = 8, 8, 16
    keys = jax.random.split(jax.random.PRNGKey(0), layers)
    weights = jax.vmap(lambda key: jax.random.normal(key, (dim, dim)) / dim)(
        keys)
    inputs = jax.random.normal(jax.random.PRNGKey(1), (batch, dim))
    return np.asarray(weights), np.asarray(inputs)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The reference's results and every rank's, from the same inputs."""
    root = tmp_path_factory.mktemp('pipeline')
    dp_stage = jmesh(data=2, stage=4)
    cases, reference = {}, {}

    model = JaxGPT2Pipelined(mesh=dp_stage, **SMALL)
    tokens = _tokens(0, (4, 16), 64)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    cases['forward'] = dict(params=_numpy(variables['params']), tokens=tokens)
    reference['forward'] = np.asarray(jax.jit(model.apply)(
        variables, jnp.asarray(tokens)))

    tokens = _tokens(1, (4, 16), 64)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    cases['grads'] = dict(params=_numpy(variables['params']), tokens=tokens)

    def loss_pipe(params):
        logits = model.apply({'params': params}, jnp.asarray(tokens))
        return jnp.mean(logits.astype(jnp.float32) ** 2)
    reference['grads'] = _flat(jax.jit(jax.grad(loss_pipe))(
        variables['params']))

    tokens = _tokens(2, (8, 16), 64)
    cases['train'] = dict(params=_init_params(model, tokens,
                                              jtrain.AdamW(lr=1e-2)),
                          tokens=tokens)
    reference['train'] = _reference_steps(
        model, tokens, tokens, jtrain.AdamW(lr=1e-2), 'gpipe', steps=4,
        policy=jpar.PipelineParallel(fsdp=False))['losses']

    weights, inputs = _pp_stack()
    block_fn = lambda layer, x: jnp.tanh(x @ layer['w'])

    def stack_grad(schedule):
        def inner(w):
            out = jpar.pipeline_apply(block_fn, {'w': w}, jnp.asarray(inputs),
                                      dp_stage, microbatches=2,
                                      schedule=schedule)
            return jnp.sum(out.astype(jnp.float32) ** 2)
        return np.asarray(jax.jit(jax.grad(inner))(jnp.asarray(weights)))
    reference['stack8'] = np.asarray(jpar.pipeline_apply(
        block_fn, {'w': jnp.asarray(weights)}, jnp.asarray(inputs), dp_stage,
        microbatches=2))
    reference['stack8_grad'] = stack_grad(None)

    stage4, data2 = jmesh(stage=4), jmesh(data=2)
    pp_tp = jmesh(data=2, stage=2, model=2)
    for name, mesh, config, shape, seed in (
            ('1f1b', dp_stage, WIDE, (16, 32), 0),
            ('interleaved_1f1b', dp_stage, dict(WIDE, layers=8, interleave=2),
             (16, 32), 3),
            ('partial_group', stage4, dict(NARROW, layers=8, microbatches=6,
                                           interleave=2), (6, 16), 8),
            ('single_stage', data2, dict(NARROW, layers=2, microbatches=2),
             (4, 16), 1),
            ('pp_tp_1f1b', pp_tp, dict(WIDE, microbatches=4), (8, 32), 6)):
        model = JaxGPT2Pipelined(mesh=mesh, **config)
        tokens = _tokens(seed, shape, config['vocab_size'])
        cases[name] = dict(params=_init_params(model, tokens), tokens=tokens)
        policy = (jpar.PipelineParallel(
            stacked_rules=JaxGPT2Pipelined.block_partition_rules())
            if name == 'pp_tp_1f1b' else None)
        reference[name] = _reference_steps(model, tokens, tokens,
                                           jtrain.SGD(lr=0.1), 'gpipe',
                                           policy=policy)

    model = JaxGPT2Pipelined(mesh=stage4, **dict(NARROW, microbatches=4))
    tokens = _tokens(2, (8, 16), 128)
    tokens[:3, 4:] = -1                  # uneven padding across microbatches
    cases['weighted'] = dict(params=_init_params(model, tokens),
                             tokens=tokens)
    reference['weighted'] = _reference_steps(
        model, np.abs(tokens), tokens, jtrain.SGD(lr=0.1), '1f1b')

    for count in (8, 6):
        model = JaxGPT2Pipelined(mesh=dp_stage, **dict(
            SMALL, layers=8, microbatches=count, interleave=2))
        tokens = _tokens(5, (2 * count, 16), 64)
        variables = model.init(jax.random.PRNGKey(2), jnp.asarray(tokens))
        cases[f'interleaved_forward{count}'] = dict(
            params=_numpy(variables['params']), tokens=tokens)
        reference[f'interleaved_forward{count}'] = (
            np.asarray(jax.jit(model.apply)(variables, jnp.asarray(tokens))),
            np.asarray(jax.jit(model.sequential_apply)(
                variables, jnp.asarray(tokens))))

    model = JaxGPT2Pipelined(mesh=dp_stage, **dict(
        SMALL, layers=8, microbatches=8, interleave=2))
    tokens = _tokens(6, (16, 16), 64)
    variables = model.init(jax.random.PRNGKey(3), jnp.asarray(tokens))
    cases['interleaved_grads'] = dict(params=_numpy(variables['params']),
                                      tokens=tokens)

    def loss_interleaved(params):
        logits = model.apply({'params': params}, jnp.asarray(tokens))
        return jnp.mean(logits.astype(jnp.float32) ** 2)
    reference['interleaved_grads'] = _flat(jax.jit(jax.grad(
        loss_interleaved))(variables['params']))

    model = JaxGPT2Pipelined(mesh=pp_tp, **SMALL)
    tokens = _tokens(4, (4, 16), 64)
    variables = model.init(jax.random.PRNGKey(2), jnp.asarray(tokens))
    cases['pp_tp_forward'] = dict(params=_numpy(variables['params']),
                                  tokens=tokens)
    params = jpar.ShardingPolicy(rules=model.partition_rules()).place(
        variables['params'], pp_tp)
    reference['pp_tp_forward'] = np.asarray(jax.jit(model.apply)(
        {'params': params}, jnp.asarray(tokens)))

    for name, sizes in (('composed', dict(data=2, fsdp=2, stage=2)),
                        ('composed_tp', dict(fsdp=2, model=2, stage=2))):
        mesh = jmesh(**sizes)
        model = JaxGPT2Pipelined(mesh=mesh, **MOE)
        tokens = _tokens(2 if name == 'composed' else 3, (16, 32), 256)
        cases[name] = dict(params=_init_params(model, tokens,
                                               jtrain.AdamW(lr=1e-3)),
                           tokens=tokens)
        reference[name] = _reference_steps(
            model, tokens, tokens, jtrain.AdamW(lr=1e-3), 'gpipe', steps=3,
            policy=jpar.PipelineParallel(
                stacked_rules=JaxGPT2Pipelined.block_partition_rules(),
                fsdp=True, fsdp_min_size=64),
            criterion=jtrain.WithAuxLoss(jtrain.NextTokenLoss()))['losses']

    inputs = dict(scenarios=['pipeline'], pipeline=cases,
                  stack_weights=weights, stack_inputs=inputs)
    ranks = torch_ranks.launch(root, inputs, RANKS)
    return dict(cases=cases, reference=reference,
                ranks=[rank['pipeline'] for rank in ranks])


def _data_rank(rank: int, stages: int = 4) -> int:
    """The data coordinate of world rank ``rank`` on data=2 x stage=S."""
    return rank // stages


def _close_trees(got: dict, want: dict, **tolerance) -> None:
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tolerance)


# ---------------------------------------------------------------------------
# tests/test_pipeline.py


def test_pipelined_forward_matches_sequential(world):
    """Every rank's logits (its data rows, the same on each of its stage
    group) against the reference's pipelined and the port's sequential
    forward."""
    want = world['reference']['forward']
    for rank, record in enumerate(world['ranks']):
        rows = slice(2 * _data_rank(rank), 2 * _data_rank(rank) + 2)
        got = record['forward']['pipelined']
        np.testing.assert_allclose(got, want[rows], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, record['forward']['sequential'][rows],
                                   rtol=1e-4, atol=1e-4)


def test_pipelined_gradients_match_sequential(world):
    for record in world['ranks']:
        _close_trees(record['grads']['grads'], world['reference']['grads'],
                     rtol=2e-3, atol=2e-4)


def test_pipeline_train_step_on_stage_mesh(world):
    want = world['reference']['train']
    for record in world['ranks']:
        losses = record['train']['losses']
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_stage_sharding_placement():
    model = GPT2Pipelined(mesh=shaped(data=2, stage=4), device='cpu',
                          **SMALL)
    policy = tpar.PipelineParallel()
    mesh = shaped(data=2, stage=4)
    shapes = {name: tuple(leaf.shape)
              for name, leaf in model.named_parameters()}
    spec = policy.spec('h/attn/qkv/kernel', shapes['h.attn.qkv.kernel'], mesh)
    assert spec[0] == 'stage', spec
    assert tuple(policy.spec('wte/embedding', shapes['wte.embedding'],
                             mesh)) == ()
    reference = jpar.PipelineParallel()
    assert tuple(spec) == tuple(reference.spec(
        'h/attn/qkv/kernel', shapes['h.attn.qkv.kernel'],
        jmesh(data=2, stage=4)))


def test_layers_not_divisible_by_stages_raises():
    model = GPT2Pipelined(mesh=shaped(stage=4), device='cpu',
                          **dict(SMALL, layers=6))
    with pytest.raises(ValueError, match='divisible'):
        model(torch.zeros((2, 8), dtype=torch.long))
    reference = JaxGPT2Pipelined(mesh=jmesh(stage=4), **dict(SMALL, layers=6))
    tokens = jnp.zeros((2, 8), jnp.int32)
    variables = reference.init(jax.random.PRNGKey(0), tokens)
    with pytest.raises(ValueError, match='divisible'):
        reference.apply(variables, tokens)


def test_pipeline_apply_plain_stack(world):
    """Any stacked layer function pipelines: the tanh stack's outputs
    against the reference's and the unpipelined loop."""
    weights, loop = _pp_stack()
    for index in range(weights.shape[0]):
        loop = np.tanh(loop @ weights[index])
    np.testing.assert_allclose(world['reference']['stack8'], loop, rtol=1e-5,
                               atol=1e-6)
    for rank, record in enumerate(world['ranks']):
        # the stack's eight rows over data=2: this rank's four
        rows = slice(4 * _data_rank(rank), 4 * _data_rank(rank) + 4)
        np.testing.assert_allclose(record['stack']['out'], loop[rows],
                                   rtol=1e-5, atol=1e-6)


def _step_parity(record, reference):
    """1F1B against GPipe on the port, and both against the reference's
    GPipe step (loss rtol 1e-5, parameters rtol 2e-4 / atol 2e-6)."""
    np.testing.assert_allclose(record['gpipe']['losses'],
                               record['1f1b']['losses'], rtol=1e-5)
    _close_trees(record['1f1b']['params'], record['gpipe']['params'],
                 rtol=2e-4, atol=2e-6)
    for path in ('gpipe', '1f1b'):
        np.testing.assert_allclose(record[path]['losses'],
                                   reference['losses'], rtol=1e-5)
        _close_trees(record[path]['params'], reference['params'],
                     rtol=2e-4, atol=2e-6)


def test_1f1b_matches_gpipe_autodiff_step(world):
    for record in world['ranks']:
        _step_parity(record['1f1b'], world['reference']['1f1b'])


def test_1f1b_single_stage_degenerates_to_microbatch_loop(world):
    for record in world['ranks'][:2]:
        _step_parity(record['single_stage'],
                     world['reference']['single_stage'])


def test_interleaved_1f1b_matches_gpipe_autodiff_step(world):
    for record in world['ranks']:
        _step_parity(record['interleaved_1f1b'],
                     world['reference']['interleaved_1f1b'])


def test_interleaved_1f1b_partial_last_group(world):
    for record in world['ranks'][:4]:
        _step_parity(record['partial_group'],
                     world['reference']['partial_group'])


def test_interleaved_schedule_units_and_bubble():
    """Round-unit accounting of the interleaved schedule, and the port's
    stash bound equal to the reference's at every configuration."""
    def fwd_tick(S, v, s, c, m):
        g, pos = divmod(m, S)
        return s + g * v * S + c * S + pos

    def bwd_tick(S, v, s, c, m):
        g, pos = divmod(m, S)
        return (v * S + S - 2 - s) + g * v * S + (v - 1 - c) * S + pos

    for S, v, M in [(4, 1, 8), (4, 2, 8), (4, 4, 16), (2, 3, 6), (8, 2, 16)]:
        rounds = v * M + v * S + S - 2
        slots = tpipe._stash_slots(S, v, M)
        assert slots == jpipe._stash_slots(S, v, M)
        for s in range(S):
            fwd = [(c, m, fwd_tick(S, v, s, c, m))
                   for c in range(v) for m in range(M)]
            bwd = [(c, m, bwd_tick(S, v, s, c, m))
                   for c in range(v) for m in range(M)]
            assert len({t for _, _, t in fwd}) == v * M
            assert len({t for _, _, t in bwd}) == v * M
            assert all(0 <= t < rounds for _, _, t in fwd + bwd)
            for c in range(v):
                for m in range(M):
                    q = c * S + s
                    if q > 0:
                        prev_s, prev_c = (s - 1, c) if s else (S - 1, c - 1)
                        assert (fwd_tick(S, v, prev_s, prev_c, m)
                                == fwd_tick(S, v, s, c, m) - 1)
                    assert bwd_tick(S, v, s, c, m) >= fwd_tick(S, v, s, c, m)
            for c in range(v):
                for m in range(M - slots):
                    assert (fwd_tick(S, v, s, c, m + slots)
                            > bwd_tick(S, v, s, c, m))
            # the port's unit function is the formula's inverse
            unit, _ = tpipe._schedule(S, v, M)
            for c, m, tick in fwd:
                assert unit(tick - s) == (True, c, m)
    assert tpipe._stash_slots(4, 1, 8) <= 2 * 4 - 1
    plain = (8 + 2 * 4 - 2) - 8
    inter = (2 * 8 + 2 * 4 + 4 - 2) - 2 * 8
    assert inter < plain * 2


def test_interleaved_placement_shards_chunk_stack():
    """PipelineParallel(interleave=2) splits the chunk-major stack's second
    dimension over stage; the sequential forward runs on that storage and
    matches the reference's."""
    import torch
    model = GPT2Pipelined(mesh=shaped(data=2, stage=4), device='cpu',
                          **dict(SMALL, layers=8, interleave=2))
    kernel = model.h.attn.qkv.kernel
    assert tuple(kernel.shape[:2]) == (2, 4), kernel.shape
    spec = tpar.PipelineParallel(interleave=2).spec(
        'h/attn/qkv/kernel', tuple(kernel.shape), shaped(data=2, stage=4))
    assert tuple(spec[:2]) == (None, 'stage'), spec
    reference = JaxGPT2Pipelined(mesh=jmesh(data=2, stage=4),
                                 **dict(SMALL, layers=8, interleave=2))
    tokens = jnp.zeros((2, 8), jnp.int32)
    variables = reference.init(jax.random.PRNGKey(0), tokens)
    model.load_state_dict(params_from_jax(_numpy(variables['params'])))
    with torch.no_grad():
        out = model.sequential_apply(torch.zeros((2, 8), dtype=torch.long))
    assert tuple(out.shape) == (2, 8, 64)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(reference.sequential_apply(variables, tokens)),
        rtol=1e-5, atol=1e-5)


def test_1f1b_token_weighted_under_padding(world):
    """Pad-heavy microbatches weigh by their unmasked tokens: 1F1B equals
    the GPipe step on the port and the reference's 1F1B."""
    want = world['reference']['weighted']
    for record in world['ranks'][:4]:
        run = record['weighted']
        np.testing.assert_allclose(run['1f1b']['losses'],
                                   run['gpipe']['losses'], rtol=1e-5)
        _close_trees(run['1f1b']['params'], run['gpipe']['params'],
                     rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(run['1f1b']['losses'], want['losses'],
                                   rtol=1e-5)
        _close_trees(run['1f1b']['params'], want['params'], rtol=2e-4,
                     atol=2e-6)


@pytest.mark.parametrize('microbatches', [8, 6])
def test_interleaved_gpipe_forward_matches_sequential(world, microbatches):
    pipelined, sequential = world['reference'][
        f'interleaved_forward{microbatches}']
    np.testing.assert_allclose(pipelined, sequential, rtol=1e-4, atol=1e-4)
    for rank, record in enumerate(world['ranks']):
        rows = slice(microbatches * _data_rank(rank),
                     microbatches * (_data_rank(rank) + 1))
        np.testing.assert_allclose(
            record[f'interleaved_forward{microbatches}'], sequential[rows],
            rtol=1e-4, atol=1e-4)


def test_interleaved_gpipe_gradients_match_sequential(world):
    for record in world['ranks']:
        _close_trees(record['interleaved_grads']['grads'],
                     world['reference']['interleaved_grads'], rtol=2e-3,
                     atol=2e-4)


def test_interleaved_gpipe_fill_drain_units():
    """Forward-schedule accounting of the interleaved GPipe loop, and the
    port's tick count and units against it."""
    def fwd_tick(S, v, s, c, m):
        g, pos = divmod(m, S)
        return s + g * v * S + c * S + pos

    for S, v, M in [(4, 2, 8), (4, 2, 6), (2, 3, 6), (8, 2, 16)]:
        padded = -(-M // S) * S
        ticks = v * padded + S - 1
        unit, port_padded = tpipe._schedule(S, v, M)
        assert port_padded == padded
        for s in range(S):
            units = [(c, m, fwd_tick(S, v, s, c, m))
                     for c in range(v) for m in range(M)]
            assert len({t for *_, t in units}) == v * M
            assert all(0 <= t < ticks for *_, t in units)
            active = [tick for tick in range(ticks) if unit(tick - s)[0]]
            assert sorted(active) == sorted(t for *_, t in units)
        for m in range(M):
            expected = ((m // S) * v * S + (v - 1) * S + (m % S) + S - 1)
            assert fwd_tick(S, v, S - 1, v - 1, m) == expected
        busy = v * M
        assert ticks - busy == (S - 1) + v * (padded - M)


def test_pp_tp_placement_shards_stage_and_model():
    model = GPT2Pipelined(mesh=shaped(data=2, stage=2, model=2),
                          device='cpu', **SMALL)
    mesh = shaped(data=2, stage=2, model=2)
    policy = tpar.PipelineParallel(
        stacked_rules=GPT2Pipelined.block_partition_rules())
    shapes = {name.replace('.', '/'): tuple(leaf.shape)
              for name, leaf in model.named_parameters()}
    assert tuple(policy.spec('h/attn/qkv/kernel', shapes['h/attn/qkv/kernel'],
                             mesh)) == ('stage', None, 'model')
    assert tuple(policy.spec('h/attn/out/kernel', shapes['h/attn/out/kernel'],
                             mesh)) == ('stage', 'model')
    own = tpar.ShardingPolicy(rules=model.partition_rules())
    assert tuple(own.spec('h/fc/kernel', shapes['h/fc/kernel'],
                          mesh)) == ('stage', None, 'model')
    reference = jpar.ShardingPolicy(rules=JaxGPT2Pipelined(
        mesh=jmesh(data=2, stage=2, model=2), **SMALL).partition_rules())
    for path, shape in shapes.items():
        assert tuple(own.spec(path, shape, mesh)) == tuple(reference.spec(
            path, shape, jmesh(data=2, stage=2, model=2))), path


def test_pp_tp_forward_matches_sequential(world):
    want = world['reference']['pp_tp_forward']
    for rank, record in enumerate(world['ranks']):
        rows = slice(2 * (rank // 4), 2 * (rank // 4) + 2)
        np.testing.assert_allclose(record['pp_tp_forward']['logits'],
                                   want[rows], rtol=1e-4, atol=1e-4)


def test_pp_tp_1f1b_matches_gpipe_autodiff_step(world):
    for record in world['ranks']:
        _step_parity(record['pp_tp_1f1b'], world['reference']['pp_tp_1f1b'])


def test_pipelined_registry_digest_is_the_references():
    for config in (SMALL, dict(SMALL, layers=8, interleave=2), MOE):
        assert gethash(GPT2Pipelined(mesh=shaped(stage=2), device='cpu',
                                     **config)) == jax_gethash(
            JaxGPT2Pipelined(mesh=jmesh(stage=2), **config))


def test_pp_hop_shifts_forward_and_its_gradient_back(world):
    """Rank i's value to stage i + 1 forward; the cotangent back to i - 1,
    bit for bit."""
    for rank, record in enumerate(world['ranks']):
        stage = rank % 4
        np.testing.assert_array_equal(record['hop']['forward'],
                                      np.full(2, (stage - 1) % 4, np.float32))
        np.testing.assert_array_equal(
            record['hop']['backward'],
            np.full(2, (stage + 1) % 4 + 1, np.float32))


# ---------------------------------------------------------------------------
# tests/test_schedule.py's pipelined tests


@pytest.mark.parametrize('chunks', [1, 2])
def test_pp_overlap_gpipe_is_bitwise_vs_classic(world, chunks):
    """The skewed tick computes the same math on the same operands:
    outputs and gradients bit for bit the classic tick's, and the outputs
    the reference's."""
    assert tpar.pp_plan(2, 4, chunks=chunks).path == 'overlap'
    for rank, record in enumerate(world['ranks']):
        classic, skewed = record['overlap'][0], record['overlap'][chunks]
        np.testing.assert_array_equal(classic['out'], skewed['out'])
        np.testing.assert_array_equal(classic['grad'], skewed['grad'])
        rows = slice(4 * _data_rank(rank), 4 * _data_rank(rank) + 4)
        np.testing.assert_allclose(skewed['out'],
                                   world['reference']['stack8'][rows],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(skewed['grad'],
                                   world['reference']['stack8_grad'],
                                   rtol=1e-4, atol=1e-6)


def test_pp_overlap_fallback_when_chunks_cannot_tile(world):
    assert tpar.pp_plan(2, 4, chunks=3).path == 'one-shot'
    assert tuple(tpar.pp_plan(2, 4, chunks=3)) == tuple(
        jpar.pp_plan(2, 4, chunks=3))
    for record in world['ranks']:
        np.testing.assert_array_equal(record['overlap'][3]['out'],
                                      record['overlap'][0]['out'])


def test_composed_pp_fsdp_moe_pipelined_step_is_bitwise_vs_gspmd(world):
    """data=2 x fsdp=2 x stage=2: the pipelined MoE GPT-2 under every arm
    trains bit for bit the unscheduled one (losses and parameters), within
    1e-4 of the reference's losses."""
    for record in world['ranks']:
        run = record['composed']
        assert run['none']['losses'] == run['schedule']['losses']
        for name, value in run['none']['params'].items():
            np.testing.assert_array_equal(value,
                                          run['schedule']['params'][name])
        np.testing.assert_allclose(run['none']['losses'],
                                   world['reference']['composed'], rtol=1e-4)


def test_composed_pp_tp_fsdp_moe_pipelined_step_matches_gspmd(world):
    for record in world['ranks']:
        run = record['composed_tp']
        assert run['none']['losses'] == run['schedule']['losses']
        for name, value in run['none']['params'].items():
            np.testing.assert_array_equal(value,
                                          run['schedule']['params'][name])
        np.testing.assert_allclose(run['none']['losses'],
                                   world['reference']['composed_tp'],
                                   rtol=1e-4)


def test_pipelined_moe_rejects_1f1b_and_interleave():
    mesh = shaped(data=2, stage=2)
    with pytest.raises(ValueError, match='interleave'):
        GPT2Pipelined(vocab_size=64, layers=4, dim=32, heads=2, max_seq=32,
                      mesh=mesh, moe_experts=2, interleave=2, device='cpu')
    model = GPT2Pipelined(vocab_size=64, layers=4, dim=32, heads=2,
                          max_seq=32, dtype='float32', microbatches=2,
                          mesh=mesh, moe_experts=2, device='cpu')
    with pytest.raises(ValueError, match='MoE spans'):
        ttrain.build_1f1b_train_step(model, ttrain.NextTokenLoss(),
                                     ttrain.AdamW(lr=1e-3))
    with pytest.raises(ValueError, match='needs a mesh'):
        GPT2Pipelined(device='cpu')
