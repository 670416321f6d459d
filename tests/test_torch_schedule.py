"""Twins of the TP and FSDP half of ``tests/test_schedule.py`` (``:54-549``,
``:606``, ``:626``, ``:642``): the port's overlap scheduler
(``tpusystem_torch/parallel/schedule.py``) against the JAX package.

Pure planning (``fsdp_plan``, ``pp_plan``, ``moe_plan``, the schedule
object, its registry hash) runs here, plan for plan and reason for reason
against the reference's. The rings, the scheduled FFN and the ``schedule=``
knob of GPT-2 and Llama run in one world of four port processes
(``tests/torch_ranks.py``, gloo on the CPU) on the reference tests' fsdp=4
and fsdp=2 x model=2 layouts; the reference side runs here on four of the
eight virtual devices, from the same numpy operands, at its own tolerances.

Without twins: ``test_compile_guard_scheduled_step_never_retraces``
(``:549``) pins that a jitted scheduled step traces once; the port's step is
eager and has no trace to repeat. The ``pp=`` arm's model tests
(``:667``, ``:696``, ``:799``, ``:822``, ``:872``) are twinned in
``tests/test_torch_pipeline.py``, the ``moe=`` arm's (``:740``, ``:762``)
in ``tests/test_torch_expert.py``. Both planners are twinned here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusystem import parallel as jpar
from tpusystem import train as jtrain
from tpusystem.checkpoint import Checkpointer as JaxCheckpointer
from tpusystem.models import GPT2 as JaxGPT2
from tpusystem.models.llama import llama_tiny as jax_llama_tiny
from tpusystem.parallel import schedule as jsched
from tpusystem.parallel.sharding import fsdp_shard_dim as jax_fsdp_shard_dim
from tpusystem_torch import parallel as tpar
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import GPT2, llama_tiny
from tpusystem_torch.parallel import schedule as tsched
from tpusystem_torch.parallel.mesh import FSDP, MODEL, Mesh
from tpusystem_torch.parallel.mesh import PartitionSpec as P
from tpusystem_torch.parallel.sharding import (ShardingPolicy,
                                               fsdp_shard_dim)

from tests import torch_ranks

RING = 4
RANKS = 4


def fsdp_mesh():
    return jpar.MeshSpec(fsdp=RING).build(jax.devices()[:RING])


def composed_mesh():
    return jpar.MeshSpec(fsdp=2, model=2).build(jax.devices()[:4])


def shaped(**sizes) -> Mesh:
    """A shape-only port mesh: the axis sizes the plans read, no ranks."""
    return Mesh('cpu', None, sizes)


def _ffn_operands(dtype, batch=4, seq=16, dim=64, grown=256, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(batch, seq, dim)) * 0.5, dtype)
    w_up = jnp.asarray(rng.normal(size=(dim, grown)) * 0.1, dtype)
    b_up = jnp.asarray(rng.normal(size=(grown,)) * 0.1, dtype)
    w_down = jnp.asarray(rng.normal(size=(grown, dim)) * 0.1, dtype)
    b_down = jnp.asarray(rng.normal(size=(dim,)) * 0.1, dtype)
    return x, w_up, b_up, w_down, b_down


def _reference_ffn(x, w_up, b_up, w_down, b_down):
    grown = jax.nn.gelu(jnp.matmul(x, w_up) + b_up)
    return jnp.matmul(grown, w_down) + b_down


def _loss(fn):
    def loss(*operands):
        out = fn(*operands)
        return jnp.sum(jnp.square(out.astype(jnp.float32))) * 1e-3
    return loss


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _gpt2(**knobs):
    return JaxGPT2(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                   dropout=0.0, dtype='float32', **knobs)


def _init(model, tokens):
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:1, :8]))['params'])


def _as_f32(operands):
    return tuple(np.asarray(a, np.float32) for a in operands)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('schedule')
    tokens = _tokens(0, (4, 16))
    rng = np.random.default_rng(1)
    inputs = dict(
        scenarios=['schedule', 'tp_schedule', 'tp_step'],
        ring_value=np.asarray(np.random.default_rng(0).normal(
            size=(16, 24)), np.float32),
        ring_values=np.asarray(rng.normal(size=(RING, 16, 24)), np.float32),
        ffn=_as_f32(_ffn_operands(jnp.float32)),
        ffn_bf16=_as_f32(_ffn_operands(jnp.bfloat16)),
        ffn96=_as_f32(_ffn_operands(jnp.float32, grown=96)),
        gpt2=_init(_gpt2(), tokens),
        gpt2_scan=_init(_gpt2(scan_layers=True), _tokens(2, (4, 16))),
        llama=_init(jax_llama_tiny(dtype='float32'), tokens),
        # the weights init_state(rng=0) draws for the checkpoint drill
        gpt2_ckpt=jax.tree.map(np.asarray, jtrain.init_state(
            _gpt2(), jtrain.AdamW(lr=1e-3),
            jnp.asarray(_tokens(3, (4, 16))[:1, :8]), rng=0).params),
        tokens=tokens, tokens2=_tokens(2, (4, 16)),
        tokens3=_tokens(3, (4, 16)), root=str(root))
    return dict(inputs=inputs,
                ranks=torch_ranks.launch(root, inputs, RANKS))


# ---------------------------------------------------------------------------
# the ring collectives the prefetch is built from


@pytest.mark.parametrize('dimension,chunks', [(0, 1), (0, 2), (1, 1)])
def test_ring_allgather_is_bitwise_identical_to_lax(world, dimension,
                                                    chunks):
    """The decomposed gather is a pure copy: every block lands where the
    one-shot all-gather puts it, bit for bit, on every rank."""
    for result in world['ranks']:
        assert result['schedule']['rings']['gather', dimension, chunks]


@pytest.mark.parametrize('dimension,chunks', [(0, 1), (0, 2), (1, 1)])
def test_ring_reducescatter_matches_psum_scatter(world, dimension, chunks):
    """The decomposed scatter sums every rank's contribution into the home
    block (float32 carry): the reference's tolerance against the sum."""
    got = np.concatenate([result['schedule']['rings']['scatter', dimension,
                                                      chunks]
                          for result in world['ranks']], axis=dimension)
    want = world['inputs']['ring_values'].sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# plan pinning: the reference's plans and reasons, field for field


def _same_fsdp_plan(shape, ring, **knobs):
    got = tpar.fsdp_plan(shape, ring, **knobs)
    assert tuple(got) == tuple(jpar.fsdp_plan(shape, ring, **knobs))
    return got


def test_fsdp_plan_pins_skip_paths():
    plan = _same_fsdp_plan((256, 1024), 1)
    assert plan.path == 'skip' and 'axis_size' in plan.reason
    plan = _same_fsdp_plan((8, 8), RING, min_size=4096)
    assert plan.path == 'skip' and 'fsdp_min_size' in plan.reason
    plan = _same_fsdp_plan((5001, 3), RING, min_size=64)
    assert plan.path == 'skip' and 'divisible' in plan.reason
    plan = _same_fsdp_plan((256, 1024), RING, taken=(0, 1))
    assert plan.path == 'skip'


def test_fsdp_plan_pins_one_shot_when_chunks_cannot_tile():
    plan = _same_fsdp_plan((256, 1024), RING, chunks=3)
    assert plan.path == 'one-shot' and 'chunks' in plan.reason
    assert plan.dim == 1
    plan = _same_fsdp_plan((256, 1024), RING, chunks=2)
    assert plan.path == 'ring' and plan.chunks == 2
    for shape in ((96, 64), (64, 96), (48, 256), (256, 48)):
        for taken in ((), (0,), (1,)):
            for chunks in (1, 2, 3, 32):
                for row_split in (1, 2):
                    _same_fsdp_plan(shape, 2, taken=taken, chunks=chunks,
                                    row_split=row_split, min_size=64)


def test_fsdp_plan_dim_agrees_with_the_placement_policy():
    for shape, taken in [((256, 1024), ()), ((256, 1024), (1,)),
                         ((64, 64), ()), ((4, 256, 256), (0,))]:
        plan = _same_fsdp_plan(shape, RING, taken=taken, min_size=64)
        assert plan.dim == fsdp_shard_dim(shape, RING, taken)


def test_fsdp_shard_dim_tie_breaks_to_the_lowest_index():
    for shape, size, taken, want in (((64, 64), 4, (), 0),
                                     ((4, 64, 64), 4, (), 1),
                                     ((64, 64, 64), 4, (0,), 1),
                                     ((64, 128), 4, (), 1),
                                     ((129, 64), 4, (), 1),
                                     ((5, 3), 4, (), None)):
        assert fsdp_shard_dim(shape, size, taken) == want
        assert jax_fsdp_shard_dim(shape, size, taken) == want


def test_policy_fsdp_placement_tie_break_is_deterministic():
    mesh = shaped(fsdp=RING)
    policy = ShardingPolicy(rules=(), fsdp=True, fsdp_min_size=64)
    assert policy.spec('dense/kernel', (64, 64), mesh) == P(FSDP)
    ruled = ShardingPolicy(rules=((r'kernel', P(MODEL)),), fsdp=True,
                           fsdp_min_size=64)
    assert ruled.spec('dense/kernel', (64, 64), mesh) == P(MODEL, FSDP)


# ---------------------------------------------------------------------------
# the schedule object and the legacy-knob seam


def test_resolve_schedule_folds_legacy_knobs():
    schedule = tpar.resolve_schedule(None, 'overlap', 2)
    assert schedule == tpar.OverlapSchedule(tp='overlap', fsdp='gspmd',
                                            chunks=2)
    assert tpar.resolve_schedule(None) == tpar.OverlapSchedule()
    passed = tpar.OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=4)
    assert tpar.resolve_schedule(passed) is passed


def test_resolve_schedule_rejects_conflicting_knobs():
    for module in (tpar, jpar):
        with pytest.raises(ValueError, match='not both'):
            module.resolve_schedule(module.OverlapSchedule(), 'overlap', 1)
        with pytest.raises(ValueError, match='not both'):
            module.resolve_schedule(module.OverlapSchedule(), 'gspmd', 2)
        with pytest.raises(ValueError, match='tp_impl'):
            module.resolve_schedule(None, 'magic', 1)
        with pytest.raises(TypeError, match='OverlapSchedule'):
            module.resolve_schedule('overlap')


def test_overlap_schedule_validates_knobs():
    with pytest.raises(ValueError, match='tp'):
        tpar.OverlapSchedule(tp='magic')
    with pytest.raises(ValueError, match='fsdp'):
        tpar.OverlapSchedule(fsdp='magic')
    with pytest.raises(ValueError, match='chunks'):
        tpar.OverlapSchedule(chunks=0)


def test_for_policy_matches_the_policy_min_size():
    policy = ShardingPolicy(rules=(), fsdp=True, fsdp_min_size=64)
    schedule = tpar.OverlapSchedule.for_policy(policy, tp='overlap',
                                               chunks=2)
    assert schedule.fsdp_min_size == 64
    assert (schedule.tp, schedule.fsdp) == ('overlap', 'prefetch')


def test_overlap_schedule_registry_hash_is_the_references():
    """The schedule is a registered entity: its identity hash is the
    reference's for the same knobs, and knobs tell schedules apart."""
    from tpusystem.registry import gethash as jax_gethash
    from tpusystem_torch.registry import gethash
    knobs = ({}, {'tp': 'overlap'}, {'fsdp': 'prefetch', 'chunks': 2},
             {'tp': 'overlap', 'fsdp': 'prefetch', 'chunks': 4,
              'fsdp_min_size': 64, 'pp': 'overlap', 'moe': 'overlap'})
    hashes = set()
    for knob in knobs:
        got = gethash(tpar.OverlapSchedule(**knob))
        assert got == jax_gethash(jpar.OverlapSchedule(**knob)), knob
        hashes.add(got)
    assert len(hashes) == len(knobs)


def test_schedule_applicable_gates_per_shape():
    mesh = shaped(fsdp=2, model=2)
    schedule = tpar.OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=1)
    assert tpar.schedule_applicable(schedule, mesh, (4, 16, 64), 256)
    assert not tpar.schedule_applicable(schedule, mesh, (4, 15, 64), 256)
    assert not tpar.schedule_applicable(schedule, None, (4, 16, 64), 256)
    assert not tpar.schedule_applicable(tpar.OverlapSchedule(), mesh,
                                        (4, 16, 64), 256)
    pure = shaped(fsdp=RING)
    assert tpar.schedule_applicable(tpar.OverlapSchedule(fsdp='prefetch'),
                                    pure, (4, 16, 64), 256)
    assert not tpar.schedule_applicable(
        tpar.OverlapSchedule(fsdp='prefetch'), pure, (3, 16, 64), 256)
    # the gate is the reference's over a grid of shapes and meshes
    for sizes in ({'fsdp': 2, 'model': 2}, {'fsdp': 4}, {'model': 4},
                  {'data': 2, 'model': 2}):
        reference = jpar.MeshSpec(**sizes).build(jax.devices()[:4])
        for knob in ({'tp': 'overlap'}, {'fsdp': 'prefetch'},
                     {'tp': 'overlap', 'fsdp': 'prefetch'}, {}):
            for shape in ((4, 16, 64), (4, 15, 64), (3, 16, 64),
                          (2, 8, 64)):
                for grown in (256, 96, 6):
                    assert tpar.schedule_applicable(
                        tpar.OverlapSchedule(**knob), shaped(**sizes),
                        shape, grown) == jpar.schedule_applicable(
                            jpar.OverlapSchedule(**knob), reference,
                            shape, grown)


# ---------------------------------------------------------------------------
# scheduled FFN vs the reference


NAMES = ('x', 'fc.kernel', 'fc.bias', 'proj.kernel', 'proj.bias')


def _case(world, name, rank=None):
    if rank is not None:
        return world['ranks'][rank]['schedule']['cases'][name]
    return [result['schedule']['cases'][name] for result in world['ranks']]


def _rows(world, name, mesh_model=1):
    """The ranks' output rows in batch order (one rank a batch block)."""
    return np.concatenate([case['out'] for case in
                           _case(world, name)[::mesh_model]])


def _grads_match(world, name, mesh_model, want, rtol, atol, argnums):
    for rank, case in enumerate(_case(world, name)):
        for index in argnums:
            key = NAMES[index]
            got = case['grads'][key]
            if key == 'x':       # this rank's rows of x's gradient
                rows = got.shape[0]
                block = rank // mesh_model
                wanted = np.asarray(want[index], np.float32)[
                    block * rows:(block + 1) * rows]
            else:
                wanted = np.asarray(want[index], np.float32)
            np.testing.assert_allclose(got, wanted, rtol=rtol, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize('chunks', [1, 2])
def test_prefetch_forward_is_bitwise_vs_gspmd_f32(world, chunks):
    """fsdp='prefetch' alone on fsdp=4: the ring gather is a copy, so the
    forward is bit for bit the all-gspmd schedule's, and tight against the
    unsharded FFN."""
    operands = _ffn_operands(jnp.float32)
    got = _rows(world, ('prefetch', chunks))
    np.testing.assert_array_equal(got, _rows(world, 'monolithic'))
    np.testing.assert_allclose(got, np.asarray(_reference_ffn(*operands)),
                               rtol=2e-6, atol=2e-6)
    mesh = fsdp_mesh()
    schedule = jpar.OverlapSchedule(fsdp='prefetch', chunks=chunks,
                                    fsdp_min_size=64)
    want = jax.jit(lambda *a: jpar.scheduled_ffn(
        *a, mesh, schedule=schedule))(*operands)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6, atol=2e-6)


def test_prefetch_grads_match_gspmd_f32(world):
    want = jax.grad(_loss(_reference_ffn), argnums=(0, 1, 2, 3, 4))(
        *_ffn_operands(jnp.float32))
    _grads_match(world, ('prefetch', 2), 1, want, 2e-5, 2e-5, range(5))


@pytest.mark.parametrize('chunks', [1, 2])
def test_composed_tp_ring_plus_prefetch_matches_gspmd_f32(world, chunks):
    """TP rings and FSDP prefetch in one region on fsdp=2 x model=2: the
    forward and every gradient against the reference."""
    operands = _ffn_operands(jnp.float32)
    np.testing.assert_allclose(_rows(world, ('composed', chunks), 2),
                               np.asarray(_reference_ffn(*operands)),
                               rtol=2e-5, atol=2e-5)
    mesh = composed_mesh()
    schedule = jpar.OverlapSchedule(tp='overlap', fsdp='prefetch',
                                    chunks=chunks, fsdp_min_size=64)
    scheduled = lambda *a: jpar.scheduled_ffn(*a, mesh, schedule=schedule)
    np.testing.assert_allclose(_rows(world, ('composed', chunks), 2),
                               np.asarray(jax.jit(scheduled)(*operands)),
                               rtol=2e-5, atol=2e-5)
    want = jax.grad(_loss(_reference_ffn), argnums=(0, 1, 2, 3, 4))(
        *operands)
    _grads_match(world, ('composed', chunks), 2, want, 2e-4, 2e-5, range(5))


def test_scheduled_ffn_bf16_bounded(world):
    """bf16 operands with f32 accumulation: the reference test's bounded
    tolerance against the bf16 FFN; the gradients stay bf16."""
    operands = _ffn_operands(jnp.bfloat16)
    np.testing.assert_allclose(_rows(world, 'bf16', 2),
                               np.asarray(_reference_ffn(*operands),
                                          np.float32), rtol=0.05, atol=0.1)
    want = jax.grad(_loss(_reference_ffn), argnums=(0, 1))(*operands)
    for case in _case(world, 'bf16'):
        assert case['grad_dtypes']['fc.kernel'] == 'torch.bfloat16'
    _grads_match(world, 'bf16', 2, want, 0.1, 0.5, (0, 1))


def test_one_shot_fallback_still_matches_reference(world):
    """chunks=3 cannot tile the kernel shards (pinned by the plan): the
    one-shot gather runs, bit for bit the monolithic forward, gradients
    correct."""
    operands = _ffn_operands(jnp.float32)
    assert tpar.fsdp_plan((64, 256), RING, chunks=3,
                          min_size=64).path == 'one-shot'
    got = _rows(world, 'one-shot')
    np.testing.assert_array_equal(got, _rows(world, 'monolithic'))
    np.testing.assert_allclose(got, np.asarray(_reference_ffn(*operands)),
                               rtol=2e-6, atol=2e-6)
    want = jax.grad(_loss(_reference_ffn), argnums=(0, 1, 2, 3, 4))(
        *operands)
    _grads_match(world, 'one-shot', 1, want, 2e-5, 2e-5, (1, 3))


def test_down_kernel_row_split_falls_back_to_one_shot(world):
    """The down kernel's rows are TP-split, so the plan sees the local row
    count: chunks=32 tiles 96 rows but not a model=2 shard's 48, and the
    FFN falls back to one-shot and stays correct."""
    plan = _same_fsdp_plan((96, 64), 2, taken=(0,), chunks=32, row_split=2,
                           min_size=64)
    assert plan.path == 'one-shot' and 'chunks' in plan.reason
    assert _same_fsdp_plan((96, 64), 2, taken=(0,), chunks=32,
                           min_size=64).path == 'ring'
    operands = _ffn_operands(jnp.float32, grown=96)
    np.testing.assert_allclose(_rows(world, 'row-split', 2),
                               np.asarray(_reference_ffn(*operands)),
                               rtol=2e-5, atol=2e-5)
    want = jax.grad(_loss(_reference_ffn), argnums=(0, 1, 2, 3, 4))(
        *operands)
    _grads_match(world, 'row-split', 2, want, 2e-4, 2e-5, (1, 3))


# ---------------------------------------------------------------------------
# model-level: the schedule= knob on GPT-2 and Llama


def _run_model(model, rules, tokens, mesh, min_size=64):
    variables = model.init(jax.random.PRNGKey(0), tokens[:1, :8])
    params = jpar.ShardingPolicy(rules=rules, fsdp=True,
                                 fsdp_min_size=min_size).place(
        variables['params'], mesh)
    placed_tokens = jax.device_put(tokens, jpar.batch_sharding(mesh))
    out = jax.jit(lambda p, t: model.apply({'params': p}, t))(
        params, placed_tokens)

    def loss(p):
        logits = model.apply({'params': p}, placed_tokens)
        return jnp.sum(jnp.square(logits.astype(jnp.float32))) * 1e-3

    grads = jax.jit(jax.grad(loss))(params)
    return variables, out, grads


def _logits(world, key):
    """The ranks' logits rows in batch order on fsdp=2 x model=2."""
    return np.concatenate([world['ranks'][rank]['tp_schedule'][key]['logits']
                           for rank in (0, 2)])


def _port_model(family, **knobs):
    if family == 'gpt2':
        return GPT2(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                    dropout=0.0, dtype='float32', device='cpu', **knobs)
    return llama_tiny(dtype='float32', device='cpu', **knobs)


@pytest.mark.parametrize('family', ['gpt2', 'llama'])
def test_schedule_knob_matches_gspmd_model_level(world, family):
    """schedule=OverlapSchedule(tp='overlap', fsdp='prefetch') is an
    implementation schedule: the same parameter tree (bit for bit, names
    and shapes), matching logits and gradients on fsdp=2 x model=2 with
    FSDP-placed parameters; each leaf's piece is the reference's shard."""
    mesh = composed_mesh()
    tokens = jnp.asarray(world['inputs']['tokens'])
    schedule = jpar.OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=2,
                                    fsdp_min_size=64)

    def build(schedule):
        if family == 'gpt2':
            return _gpt2(mesh=mesh, schedule=schedule), \
                JaxGPT2.partition_rules()
        model = jax_llama_tiny(dtype='float32', mesh=mesh,
                               schedule=schedule)
        return model, type(model).partition_rules()

    v_ref, out_ref, grads_ref = _run_model(*build(None), tokens, mesh)
    _, out_sch, grads_sch = _run_model(*build(schedule), tokens, mesh)
    for leaf, given in zip(jax.tree.leaves(v_ref['params']),
                           jax.tree.leaves(world['inputs'][family])):
        np.testing.assert_array_equal(np.asarray(leaf), given)
    knob = tpar.OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=2,
                                fsdp_min_size=64)
    plain, scheduled = _port_model(family), _port_model(family,
                                                        schedule=knob)
    assert [(name, leaf.shape) for name, leaf in plain.state_dict().items()] \
        == [(name, leaf.shape)
            for name, leaf in scheduled.state_dict().items()]
    assert all(leaf.equal(scheduled.state_dict()[name])
               for name, leaf in plain.state_dict().items())
    scheduled.load_state_dict(params_from_jax(world['inputs'][family]))
    want_grads = params_from_jax(jax.tree.map(np.asarray, grads_sch))
    rules = (JaxGPT2.partition_rules() if family == 'gpt2'
             else type(jax_llama_tiny()).partition_rules())
    placed = jpar.ShardingPolicy(rules=rules, fsdp=True,
                                 fsdp_min_size=64).place(v_ref['params'],
                                                         mesh)
    shards = {'/'.join(str(getattr(entry, 'key', entry)) for entry in path):
              leaf.addressable_shards[0].data.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  placed)[0]}
    for name in ('none', 'schedule'):
        got = _logits(world, (family, name))
        np.testing.assert_allclose(got, np.asarray(out_ref), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(out_sch), rtol=2e-5,
                                   atol=2e-5)
        for result in world['ranks']:
            record = result['tp_schedule'][family, name]
            for key, value in want_grads.items():
                np.testing.assert_allclose(record['grads'][key],
                                           value.numpy(), rtol=2e-4,
                                           atol=3e-5, err_msg=key)
            for path, shard in shards.items():
                assert record['shards'][path.replace('/', '.')] == shard, \
                    path


def test_scan_path_accepts_the_schedule(world):
    """The scanned GPT-2 threads the schedule through its template and
    matches the reference's scan, from the reference's scanned init."""
    mesh = composed_mesh()
    tokens = jnp.asarray(world['inputs']['tokens2'])
    common = dict(mesh=mesh, scan_layers=True)
    schedule = jpar.OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=2,
                                    fsdp_min_size=64)
    v_ref, out_ref, _ = _run_model(_gpt2(**common), JaxGPT2.partition_rules(),
                                   tokens, mesh)
    v_sch, out_sch, _ = _run_model(_gpt2(**common, schedule=schedule),
                                   JaxGPT2.partition_rules(), tokens, mesh)
    for ref, sch, given in zip(jax.tree.leaves(v_ref), jax.tree.leaves(v_sch),
                               jax.tree.leaves(world['inputs']['gpt2_scan'])):
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(sch))
        np.testing.assert_array_equal(np.asarray(ref), given)
    for name in ('none', 'schedule'):
        got = _logits(world, ('scan', name))
        np.testing.assert_allclose(got, np.asarray(out_ref), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(out_sch), rtol=2e-5,
                                   atol=2e-5)


def test_schedule_rejects_unknown_values_at_model_level():
    with pytest.raises(ValueError, match='schedule fsdp'):
        tpar.OverlapSchedule(fsdp='sometimes')
    with pytest.raises(TypeError, match='OverlapSchedule'):
        GPT2(vocab_size=64, layers=1, dim=32, heads=4, max_seq=32,
             dropout=0.0, dtype='float32', schedule='overlap', device='cpu')
    with pytest.raises(TypeError, match='OverlapSchedule'):
        llama_tiny(schedule='overlap', device='cpu')


def test_schedule_with_legacy_knobs_raises_at_model_level():
    with pytest.raises(ValueError, match='not both'):
        GPT2(vocab_size=64, layers=1, dim=32, heads=4, max_seq=32,
             dropout=0.0, dtype='float32', tp_impl='overlap',
             schedule=tpar.OverlapSchedule(), device='cpu')
    with pytest.raises(ValueError, match='not both'):
        llama_tiny(tp_chunks=2, schedule=tpar.OverlapSchedule(),
                   device='cpu')


def test_pre_schedule_checkpoint_restores_under_the_new_knob(world,
                                                             tmp_path):
    """A checkpoint written by the model without the knob restores bit for
    bit into a schedule-on run, whose logits match the old model's, the
    reference's restored model's, on fsdp=2 x model=2."""
    mesh = composed_mesh()
    tokens = jnp.asarray(world['inputs']['tokens3'])
    old_era = _gpt2(mesh=mesh)
    state = jtrain.init_state(old_era, jtrain.AdamW(lr=1e-3), tokens[:1, :8],
                              rng=0)
    with JaxCheckpointer(tmp_path, async_save=False) as checkpointer:
        checkpointer.save('pre-schedule', 0, state)
        blank = jax.tree.map(jnp.zeros_like, state)
        restored = checkpointer.restore('pre-schedule', blank)
    placed = jpar.ShardingPolicy(rules=JaxGPT2.partition_rules(), fsdp=True,
                                 fsdp_min_size=64).place(restored.params,
                                                         mesh)
    scheduled = _gpt2(mesh=mesh, schedule=jpar.OverlapSchedule(
        tp='overlap', fsdp='prefetch', chunks=2, fsdp_min_size=64))
    want = jax.jit(lambda p, t: scheduled.apply({'params': p}, t))(
        placed, jax.device_put(tokens, jpar.batch_sharding(mesh)))
    for rank in (0, 2):
        record = world['ranks'][rank]['tp_schedule']['checkpoint']
        assert record['bitwise']
    old = np.concatenate([world['ranks'][rank]['tp_schedule']['checkpoint'][
        'old'] for rank in (0, 2)])
    new = np.concatenate([world['ranks'][rank]['tp_schedule']['checkpoint'][
        'new'] for rank in (0, 2)])
    np.testing.assert_allclose(old, new, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(new, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_placed_step_over_a_model_axis(world):
    """The placed train step over a ``model`` axis: three guarded, clipped
    AdamW steps of GPT-2 under TensorParallel (data=2 x model=2) and under
    TensorParallel with FSDP and the schedule (fsdp=2 x model=2) give the
    reference's placed losses and the port's unplaced losses and guard
    rows (the clip's and the guard's norms count each piece once); three
    SGD steps give the unplaced parameters."""
    tokens = jnp.asarray(world['inputs']['tokens'])
    want = {}
    for name, sizes, fsdp in (('tp', {'data': 2, 'model': 2}, False),
                              ('scheduled', {'fsdp': 2, 'model': 2}, True)):
        mesh = jpar.MeshSpec(**sizes).build(jax.devices()[:4])
        module = _gpt2(mesh=mesh)
        optimizer = jtrain.AdamW(lr=1e-3, grad_clip=1.0)
        state = jtrain.init_state(module, optimizer, tokens[:1, :8], rng=0)
        state = state.replace(params=jax.tree.map(
            jnp.asarray, world['inputs']['gpt2']))
        state = jpar.ShardingPolicy(rules=JaxGPT2.partition_rules(),
                                    fsdp=fsdp, fsdp_min_size=64).place(
            state, mesh)
        placed = jax.device_put(tokens, jpar.batch_sharding(mesh))
        step = jtrain.build_train_step(jtrain.flax_apply(module),
                                       jtrain.NextTokenLoss(), optimizer)
        losses = []
        for _ in range(3):
            state, (_, loss) = step(state, placed, placed)
            losses.append(float(loss))
        want[name] = losses
    for result in world['ranks']:
        runs = result['tp_step']
        unplaced = runs['unplaced']
        for name in ('tp', 'scheduled'):
            np.testing.assert_allclose(runs[name]['adamw'], want[name],
                                       rtol=2e-5)
            for kind in ('adamw', 'sgd'):
                np.testing.assert_allclose(runs[name][kind], unplaced[kind],
                                           rtol=2e-5)
            np.testing.assert_allclose(runs[name]['health'],
                                       unplaced['health'], rtol=2e-5,
                                       atol=2e-6)
            for key, value in unplaced['params'].items():
                np.testing.assert_allclose(runs[name]['params'][key], value,
                                           rtol=2e-5, atol=2e-6,
                                           err_msg=key)


# ---------------------------------------------------------------------------
# the pp= and moe= arms' planners (the arms themselves are twinned in
# tests/test_torch_pipeline.py and tests/test_torch_expert.py)


def test_overlap_schedule_validates_the_new_arms():
    with pytest.raises(ValueError, match='schedule pp'):
        tpar.OverlapSchedule(pp='sometimes')
    with pytest.raises(ValueError, match='schedule moe'):
        tpar.OverlapSchedule(moe='magic')
    a = tpar.OverlapSchedule(pp='overlap', moe='overlap')
    assert a != tpar.OverlapSchedule() and hash(a) != hash(
        tpar.OverlapSchedule())
    assert 'pp=' in repr(a) and 'moe=' in repr(a)
    assert repr(a) == repr(jpar.OverlapSchedule(pp='overlap', moe='overlap'))
    policy = ShardingPolicy(rules=(), fsdp=True, fsdp_min_size=64)
    paired = tpar.OverlapSchedule.for_policy(policy, tp='overlap',
                                             pp='overlap', moe='overlap')
    assert (paired.pp, paired.moe) == ('overlap', 'overlap')
    assert paired.fsdp_min_size == 64
    legacy = tpar.resolve_schedule(None, 'overlap', 2)
    assert (legacy.pp, legacy.moe) == ('gspmd', 'gspmd')


def test_pp_plan_pins_paths():
    for args in ((4, 1), (3, 4, 2), (4, 4, 1, 2), (4, 4, 2), (8, 2, 3),
                 (8, 2, 0)):
        assert tuple(tsched.pp_plan(*args)) == tuple(jsched.pp_plan(*args))
    plan = tsched.pp_plan(4, 1)
    assert plan.path == 'skip' and 'axis_size' in plan.reason
    plan = tsched.pp_plan(3, 4, chunks=2)
    assert plan.path == 'one-shot' and 'chunks' in plan.reason
    plan = tsched.pp_plan(4, 4, chunks=1, interleave=2)
    assert plan.path == 'one-shot' and 'interleaved' in plan.reason
    plan = tsched.pp_plan(4, 4, chunks=2)
    assert plan.path == 'overlap' and plan.chunks == 2


def test_moe_plan_pins_paths():
    for args in ((8, 1), (8, 2, 'ragged'), (8, 2, 'ragged-emulated'),
                 (5, 2), (8, 2), (6, 2, 'quota', 3), (4, 2, 'quota', 4)):
        assert tuple(tsched.moe_plan(*args)) == tuple(jsched.moe_plan(*args))
    plan = tsched.moe_plan(8, 1)
    assert plan.path == 'skip' and 'axis_size' in plan.reason
    for exchange in ('ragged', 'ragged-emulated'):
        plan = tsched.moe_plan(8, 2, exchange=exchange)
        assert plan.path == 'one-shot' and 'receiver' in plan.reason
    plan = tsched.moe_plan(5, 2)
    assert plan.path == 'one-shot' and 'split' in plan.reason
    plan = tsched.moe_plan(8, 2)
    assert plan.path == 'overlap' and plan.pieces == 2
