"""Streamed int8/fp8 serving of the port against the JAX package's, on the
CPU.

Quantization must equal the reference's bit for bit (the same float32
arithmetic, round half to even, the same e4m3 cast). The decode kernels'
plain versions take the reference's :class:`QuantizedLeaf` arithmetic
(``qdot``: narrow values widened to the compute dtype, float32 sums, the
scale on the sum): in float32 they match the reference's Pallas kernels in
interpret mode at ``rtol = atol = 1e-5`` (sums in another order). Served
greedy tokens must equal the reference's on ``gpt2_tiny`` in float32 through
both decode paths, the reference's own contract between its paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.ops import precision as jprecision
from tpusystem.ops.pallas import decode_matmul as jdecode
from tpusystem.serve import Engine as JaxEngine
from tpusystem.train import generate as jax_generate
from tpusystem.train.generate import streamed_bytes as jax_streamed_bytes
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.ops import precision
from tpusystem_torch.ops.cuda import decode_matmul as dm
from tpusystem_torch.serve import Engine
from tpusystem_torch.train import generate
from tpusystem_torch.train.generate import streamed_bytes

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ['int8', 'fp8']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(values) -> np.ndarray:
    """The raw bytes of int8 / e4m3 values (numpy from either package)."""
    if isinstance(values, torch.Tensor):
        return values.view(torch.uint8).numpy()
    return np.asarray(values).view(np.uint8)


def _matrix(mode: str) -> np.ndarray:
    """Normal values, an all-zero column, a column whose scale is 1 and
    which holds exact ties and values at +-QMAX, a tiny column."""
    rng = np.random.default_rng(17)
    matrix = (rng.standard_normal((64, 48)) * 0.3).astype(np.float32)
    matrix[:, 3] = 0.0
    qmax = precision.QMAX[mode]
    ties = ([2.5, -3.5, 0.5, -0.5, 126.5] if mode == 'int8'
            else [1.0625, -1.1875, 3.25, 0.0, 200.0])   # e4m3 midpoints
    matrix[:, 7] = 0.0
    matrix[:len(ties) + 2, 7] = ties + [qmax, -qmax]
    matrix[:, 9] *= 1e-30
    return matrix


@pytest.mark.parametrize('mode', MODES)
def test_quantize_leaf_equals_the_reference_bitwise(mode):
    matrix = _matrix(mode)
    want = jprecision.quantize_leaf(jnp.asarray(matrix), mode)
    got = precision.quantize_leaf(torch.from_numpy(matrix), mode)
    assert got.values.dtype == precision.QDTYPES[mode]
    assert got.scales.shape == (1, 48) and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.values), _bits(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.scales[0, 3] == 1.0 and got.scales[0, 7] == 1.0
    np.testing.assert_array_equal(
        precision.dequantize_leaf(got).numpy(),
        np.asarray(jprecision.dequantize_leaf(want)))
    np.testing.assert_array_equal(
        precision.dequantize_leaf(got, torch.bfloat16).float().numpy(),
        np.asarray(jprecision.dequantize_leaf(want, jnp.bfloat16),
                   np.float32))


@pytest.mark.parametrize('mode', MODES)
def test_quantize_streamed_selects_the_reference_leaves(mode):
    """Matrices quantize; embedding tables and vectors stay; the streamed
    byte count is the reference's."""
    module = jax_gpt2_tiny(dtype='float32')
    params = module.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))['params']
    state = params_from_jax(params)
    quantized = precision.quantize_streamed(state, mode)
    reference = params_from_jax(jax.tree.map(
        lambda leaf: _bits(leaf.values) if isinstance(
            leaf, jprecision.QuantizedLeaf) else np.asarray(leaf),
        jprecision.quantize_streamed(params, mode),
        is_leaf=lambda node: isinstance(node, jprecision.QuantizedLeaf)))
    for name, leaf in quantized.items():
        is_matrix = leaf is not state[name]
        assert is_matrix == (state[name].dim() == 2
                             and 'embedding' not in name), name
        if is_matrix:
            np.testing.assert_array_equal(_bits(leaf.values),
                                          reference[name].numpy())
    assert precision.dequantize_streamed(state) is state
    port = gpt2_tiny(dtype='float32', device='cpu')
    port.load_state_dict(state)
    assert streamed_bytes(port, state, mode) == jax_streamed_bytes(
        module, params, mode)


def _operands(seed=0, rows=3, inner=16, hidden=64, cols=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, inner)).astype(np.float32)
    w1 = (rng.standard_normal((inner, hidden)) * 0.3).astype(np.float32)
    b1 = rng.standard_normal(hidden).astype(np.float32)
    w2 = (rng.standard_normal((hidden, cols)) * 0.3).astype(np.float32)
    b2 = rng.standard_normal(cols).astype(np.float32)
    return x, w1, b1, w2, b2


def _pair(matrix, mode):
    return (jprecision.quantize_leaf(jnp.asarray(matrix), mode),
            precision.quantize_leaf(torch.from_numpy(matrix), mode))


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('activation', [None, 'gelu'])
def test_quantized_decode_matmul_plain_matches_the_pallas_kernel(mode,
                                                                 activation):
    """K4 with in-kernel dequant (``_matmul_kernel:99-113``): the scale on
    the float32 sum before bias and activation; the reference in interpret
    mode over four column tiles."""
    x, w, bias, _, _ = _operands(1)
    jax_w, w_leaf = _pair(w, mode)
    want = jdecode.decode_matmul(
        jnp.asarray(x), jax_w, jnp.asarray(bias),
        activation=jax.nn.gelu if activation else None, block_cols=16,
        interpret=True)
    got = dm.decode_matmul(torch.from_numpy(x), w_leaf,
                           torch.from_numpy(bias), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qdot = precision.qdot(torch.from_numpy(x), w_leaf)
    np.testing.assert_allclose(
        qdot.numpy(), np.asarray(jprecision.qdot(jnp.asarray(x), jax_w)),
        **TOL)


@pytest.mark.parametrize('mode', MODES)
def test_quantized_decode_ffn_plain_matches_the_pallas_kernel(mode):
    """K5 with in-kernel dequant (``_ffn_kernel:181-210``): w1's scale per
    hidden channel before b1 and GELU, w2's once on the full sum before
    b2; the reference in interpret mode over four hidden tiles."""
    x, w1, b1, w2, b2 = _operands(2)
    (jax_w1, w1_leaf), (jax_w2, w2_leaf) = _pair(w1, mode), _pair(w2, mode)
    want = jdecode.decode_ffn(jnp.asarray(x), jax_w1, jnp.asarray(b1),
                              jax_w2, jnp.asarray(b2), block_hidden=16,
                              interpret=True)
    got = dm.decode_ffn(torch.from_numpy(x), w1_leaf, torch.from_numpy(b1),
                        w2_leaf, torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_kernels_refuse_mixed_or_unscaled_narrow_weights():
    """The CUDA wrappers' weight check (run before any launch; here on meta
    tensors): a narrow matrix without its scales, bf16 beside int8, or
    scales of the wrong width are refused."""
    meta = torch.device('meta')
    narrow = torch.zeros((16, 32), dtype=torch.int8, device=meta)
    leaf = precision.QuantizedLeaf(narrow, torch.ones((1, 32), device=meta))
    wide = torch.zeros((32, 16), dtype=torch.bfloat16, device=meta)
    assert dm._weight_mode('decode_matmul', meta, (leaf,)) == 'int8'
    assert dm._weight_mode('decode_matmul', meta, (wide,)) == 'bf16'
    with pytest.raises(ValueError, match='QuantizedLeaf'):
        dm._weight_mode('decode_matmul', meta, (narrow,))
    with pytest.raises(ValueError, match='one type'):
        dm._weight_mode('decode_ffn', meta, (leaf, wide))
    with pytest.raises(ValueError, match='scales'):
        dm._weight_mode('decode_matmul', meta, (precision.QuantizedLeaf(
            narrow, torch.ones((1, 16), device=meta)),))


@pytest.fixture(scope='module')
def served():
    reference = jax_gpt2_tiny(dtype='float32')
    params = reference.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))['params']
    port = gpt2_tiny(dtype='float32', device='cpu')
    return reference, params, port, params_from_jax(params)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('decode_impl', ['flax', 'fused'])
def test_quantized_generate_token_exact_with_jax(served, mode, decode_impl):
    reference, params, port, state = served
    prompt = np.random.default_rng(3).integers(0, 256, (2, 7))
    want = jax_generate(reference, params, jnp.asarray(prompt, jnp.int32),
                        steps=12, decode_impl='flax', stream_dtype=mode)
    got = generate(port, state, prompt, steps=12, decode_impl=decode_impl,
                   stream_dtype=mode, device='cpu')
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _drive(engine, prompts, budgets):
    """Two requests, three steps, a third request into a freed row, and
    steps until every row is done: the tokens of every request."""
    admissions = [engine.admit(prompts[0], budgets[0]),
                  engine.admit(prompts[1], budgets[1])]
    finished = {}
    for _ in range(3):
        for row, _, tokens in engine.step().finished:
            finished[row] = tokens
    engine.evict(admissions[1].row)
    admissions.append(engine.admit(prompts[2], budgets[2]))
    log = []
    while engine.active_rows:
        report = engine.step()
        log.append(report.emitted)
        for row, _, tokens in report.finished:
            finished[row] = tokens
    return [admission.token for admission in admissions], log, finished


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('decode_impl', ['flax', 'fused'])
def test_quantized_engine_token_exact_with_jax(served, mode, decode_impl):
    reference, params, port, state = served
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 256, (n,)) for n in (5, 11, 8)]
    budgets = [12, 6, 9]
    want = _drive(JaxEngine(reference, params, rows=2, block_size=8,
                            decode_impl='fused', stream_dtype=mode),
                  prompts, budgets)
    engine = Engine(port, state, rows=2, block_size=8, decode_impl=decode_impl,
                    stream_dtype=mode, device='cpu')
    assert isinstance(engine._params['h_0.fc.kernel'],
                      precision.QuantizedLeaf)
    assert _drive(engine, prompts, budgets) == want


@pytest.mark.parametrize('mode', MODES)
def test_quantized_engine_fused_logits_agree_with_the_module_path(served,
                                                                  mode):
    """One fused step over the narrow leaves against the module path on
    their dequantized view, same state: float32 sums in another order."""
    _, _, port, state = served
    engine = Engine(port, state, rows=2, block_size=8, stream_dtype=mode,
                    device='cpu')
    engine.admit(np.arange(5) + 3, max_new=6)
    engine.step()
    fused, module_path = (engine.next_logits('fused'),
                          engine.next_logits('flax'))
    np.testing.assert_allclose(fused.numpy(), module_path.numpy(), **TOL)
