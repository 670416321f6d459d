"""Twins of the tensor-parallel serving tests of
``tests/test_serve_disagg.py``: ``TestDecodeTpPlan`` (``:91``),
``TestShardedEngine`` (``:122``) and the mesh cases of ``TestReasonMatrix``
(``:196``, ``:223``).

``Engine(mesh=MeshSpec(model=2))`` runs in a world of two port processes
(``tests/torch_ranks.py``, gloo on the CPU), every rank the same engine in
lockstep; the ranks' tokens are gathered and must be one stream. In float32
they equal, token for token, the port's one-rank engine and the reference's
sharded engine over two virtual devices, on ``gpt2_tiny`` and
``llama_tiny`` with the reference's weights. The plans and the pool's
split are the reference's, field for field.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.models import llama_tiny as jax_llama_tiny
from tpusystem.parallel import MeshSpec as JaxMeshSpec
from tpusystem.parallel import decode_tp_plan as jax_decode_tp_plan
from tpusystem.serve import Engine as JaxEngine
from tpusystem.serve import pool_shardings as jax_pool_shardings
from tpusystem_torch.parallel import decode_tp_plan
from tpusystem_torch.parallel.mesh import Mesh

from tests import torch_ranks

PROMPT_LENGTHS = (5, 9)
BUDGET = 6


def submesh(count=2, **axes):
    return JaxMeshSpec(**axes).build(jax.devices()[:count])


def shaped(**sizes) -> Mesh:
    return Mesh('cpu', None, sizes)


def _params(make, seed):
    prompt = jnp.asarray(np.random.default_rng(seed).integers(0, 256, (1, 8)),
                         jnp.int32)
    module = make(dtype='float32')
    return module, module.init(jax.random.PRNGKey(seed), prompt)['params']


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (n,)).tolist() for n in PROMPT_LENGTHS]


def drain(engine, steps=64):
    tokens: dict = {}
    for _ in range(steps):
        report = engine.step()
        for tag, new in report.emitted.items():
            tokens.setdefault(tag, []).extend(int(t) for t in new)
        if not engine.active_rows:
            break
    return tokens


@pytest.fixture(scope='module')
def families():
    return {'gpt2': _params(jax_gpt2_tiny, 0),
            'llama': _params(jax_llama_tiny, 1)}


@pytest.fixture(scope='module')
def world(tmp_path_factory, families):
    root = tmp_path_factory.mktemp('serve_tp')
    inputs = dict(scenarios=['serve_tp'], prompts=_prompts(), root=None,
                  **{name: jax.tree.map(np.asarray, params)
                     for name, (_, params) in families.items()})
    return dict(inputs=inputs, ranks=torch_ranks.launch(root, inputs, 2))


class TestDecodeTpPlan:

    def test_plans_are_the_references(self):
        for sizes in ({}, {'model': 1}, {'model': 2}, {'data': 2},
                      {'model': 2, 'fsdp': 2}, {'seq': 2}):
            count = int(np.prod(list(sizes.values()) or [1]))
            assert tuple(decode_tp_plan(shaped(**sizes))) == tuple(
                jax_decode_tp_plan(submesh(count, **sizes)))
        assert tuple(decode_tp_plan(None)) == tuple(jax_decode_tp_plan(None))

    def test_no_mesh_is_single(self):
        plan = decode_tp_plan(None)
        assert (plan.path, plan.model) == ('single', 1)

    def test_model_axis_shards_gspmd(self):
        plan = decode_tp_plan(shaped(model=2))
        assert (plan.path, plan.model) == ('gspmd', 2)
        assert decode_tp_plan(shaped(model=1)).path == 'single'

    def test_nontrivial_data_axis_is_typed_unsupported(self):
        plan = decode_tp_plan(shaped(data=2))
        assert plan.path == 'unsupported'
        assert "'model' axis only" in plan.reason

    def test_engine_raises_the_plan_reason(self, world):
        for result in world['ranks']:
            assert "'model' axis only" in result['serve_tp']['refusals'][
                'data']


class TestShardedEngine:

    @pytest.mark.parametrize('family', ['gpt2', 'llama'])
    def test_tp_decode_token_exact(self, world, families, family):
        """The ranks emit one stream, the port's one-rank engine's and the
        reference's sharded and one-device engines', token for token."""
        module, params = families[family]
        prompts = world['inputs']['prompts']
        single = JaxEngine(module, params, rows=2, block_size=8)
        sharded = JaxEngine(module, params, rows=2, block_size=8,
                            mesh=submesh(2, model=2))
        for engine in (single, sharded):
            for index, prompt in enumerate(prompts):
                engine.admit(prompt, BUDGET, tag=f'r{index}')
        want = drain(sharded)
        assert want == drain(single)
        for result in world['ranks']:
            record = result['serve_tp'][family]
            assert record['sharded'] == want
            assert record['single'] == want
            assert all(tokens == want for tokens in record['ranks'])
            assert record['plan'] == ('gspmd', 2, '')
            assert record['decode_impl'] == 'flax'
            assert record['audit']['live'] == 0

    def test_pool_shardings_split_heads_replicate_tables(self, world,
                                                         families):
        """The pool's split is the reference's leaf for leaf: KV over heads
        on ``model``, tables and cursors whole; each rank's KV holds its
        heads."""
        for family, (module, params) in families.items():
            engine = JaxEngine(module, params, rows=2, block_size=8)
            specs = jax_pool_shardings(engine._cache, submesh(2, model=2))
            want = {'/'.join(str(getattr(entry, 'key', entry))
                             for entry in path): tuple(spec.spec)
                    for path, spec in
                    jax.tree_util.tree_leaves_with_path(specs)}
            for result in world['ranks']:
                record = result['serve_tp'][family]
                got = {path: spec for path, spec in record['specs'].items()
                       if path in want}
                assert set(got) == {path for path in want
                                    if path in record['specs']}
                for path, spec in got.items():
                    assert spec == tuple(want[path]), path
                assert any('model' in spec for spec in got.values())
                heads = (module.heads if family == 'gpt2'
                         else module.kv_heads)
                for shape in record['kv'].values():
                    assert shape[-2] == heads // 2

    def test_speculative_rows_refuse_the_mesh(self, world):
        for result in world['ranks']:
            assert 'speculative rows' in result['serve_tp']['refusals'][
                'speculative']


class TestReasonMatrix:

    def test_fused_paged_gate_under_tp_names_the_fallback(self, world):
        for result in world['ranks']:
            refusals = result['serve_tp']['refusals']
            assert 'no ring arms' in refusals['fused']
            assert 'sharded flax' in refusals['fused']
            assert 'token-exact' in refusals['fused']
            assert refusals['auto'] == 'flax'

    def test_tp_mesh_rejection_reason_is_the_planner_text(self, world):
        reason = jax_decode_tp_plan(submesh(2, data=2)).reason
        assert reason == decode_tp_plan(shaped(data=2)).reason
        for result in world['ranks']:
            assert reason in result['serve_tp']['refusals']['data']
