"""On-card checks of the port's CUDA kernels against their plain versions,
and of the slice's entry points running them.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch and the CUDA toolkit; ``--noconftest`` keeps pytest from loading the
JAX-side ``tests/conftest.py`` there::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs are bfloat16, the working type of the serving path; kernel and plain
version see the same tensors on the card. Tolerances: the decode kernels
round their float32 sums to bfloat16 once, as the plain versions do, so they
may differ by the summation order's effect on that rounding: at most two
bfloat16 steps (2**-7) of the largest output. The flash kernel's output may
differ by two bfloat16 steps of values below 2 (2e-2); its float32
logsumexp by 1e-3. The backward kernels round P and dS to bfloat16 where the
plain version does, but their float32 sums run in another order, so a
rounding may land one bfloat16 step apart and the step propagates through
the sums: dq, dk and dv may differ by four bfloat16 steps (2**-6) of the
largest gradient of their tensor. The grouped kernels (K6, K7) round each
product once to bfloat16 as the plain versions do, after float32 sums in
another order: their rows may differ by two bfloat16 steps (2**-7) of the
largest row; K7's combined output sums up to k such rows, each add rounded
to bfloat16, so it may differ by 2**-5 of its largest value. The decode
kernels with int8 / e4m3 weights widen them exactly, so they keep the bf16
kernels' tolerance; the dropout keep mask and the sampler's per-row
uniforms of the threefry kernels are integer arithmetic (the uniforms an
exact subtraction after it) and equal their plain versions bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from tpusystem_torch.ops.cuda import decode_matmul as dm
from tpusystem_torch.ops.cuda import flash
from tpusystem_torch.ops.cuda import grouped_matmul as gm
from tpusystem_torch.ops.cuda import threefry as tf
from tpusystem_torch.ops.precision import QuantizedLeaf, quantize_leaf

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the hand-written kernels run only on an '
                    'NVIDIA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _normal(generator, shape, scale, device):
    values = torch.randn(shape, generator=generator, device=device) * scale
    return values.to(torch.bfloat16)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f'max abs err {err} > {tol}'


@pytest.mark.parametrize('batch', [1, 8, 19])
@pytest.mark.parametrize('cols,activation', [(2304, None), (768, 'gelu')])
def test_decode_matmul_matches_plain(device, batch, cols, activation):
    generator = torch.Generator(device).manual_seed(batch + cols)
    x = _normal(generator, (batch, 768), 1.0, device)
    w = _normal(generator, (768, cols), 768 ** -0.5, device)
    bias = torch.randn(cols, generator=generator, device=device) * 0.1
    before = dm.decode_matmul.launches
    got = dm.decode_matmul(x, w, bias, activation=activation)
    want = dm.decode_matmul_plain(x, w, bias, activation=activation)
    torch.cuda.synchronize()
    assert got.shape == (batch, cols) and got.dtype == torch.bfloat16
    assert dm.decode_matmul.launches - before == -(-batch // 16)
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('batch', [1, 8, 19])
def test_decode_ffn_matches_plain(device, batch):
    generator = torch.Generator(device).manual_seed(batch)
    x = _normal(generator, (batch, 768), 1.0, device)
    w1 = _normal(generator, (768, 3072), 768 ** -0.5, device)
    w2 = _normal(generator, (3072, 768), 3072 ** -0.5, device)
    b1 = torch.randn(3072, generator=generator, device=device) * 0.1
    b2 = torch.randn(768, generator=generator, device=device) * 0.1
    got = dm.decode_ffn(x, w1, b1, w2, b2)
    want = dm.decode_ffn_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert got.shape == (batch, 768) and got.dtype == torch.bfloat16
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('mode', ['int8', 'fp8'])
@pytest.mark.parametrize('batch', [1, 8, 19])
@pytest.mark.parametrize('cols,activation', [(2304, None), (768, 'gelu')])
def test_quantized_decode_matmul_matches_plain(device, mode, batch, cols,
                                               activation):
    """K4 on int8 / e4m3 weights with float32 scales, 8 rows a launch."""
    generator = torch.Generator(device).manual_seed(batch + cols + len(mode))
    x = _normal(generator, (batch, 768), 1.0, device)
    w = quantize_leaf(torch.randn((768, cols), generator=generator,
                                  device=device) * 768 ** -0.5, mode)
    bias = torch.randn(cols, generator=generator, device=device) * 0.1
    before = dm.decode_matmul.mode_launches[mode]
    got = dm.decode_matmul(x, w, bias, activation=activation)
    want = dm.decode_matmul_plain(x, w, bias, activation=activation)
    torch.cuda.synchronize()
    assert got.shape == (batch, cols) and got.dtype == torch.bfloat16
    assert dm.decode_matmul.mode_launches[mode] - before == -(-batch // 8)
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('mode', ['int8', 'fp8'])
@pytest.mark.parametrize('batch', [1, 8, 19])
def test_quantized_decode_ffn_matches_plain(device, mode, batch):
    """K5 on int8 / e4m3 weights: w1's scale before the GELU, w2's on the
    ordered sum of the hidden splits."""
    generator = torch.Generator(device).manual_seed(batch + len(mode))
    x = _normal(generator, (batch, 768), 1.0, device)
    w1, w2 = (quantize_leaf(torch.randn(shape, generator=generator,
                                        device=device) * shape[0] ** -0.5,
                            mode)
              for shape in ((768, 3072), (3072, 768)))
    b1 = torch.randn(3072, generator=generator, device=device) * 0.1
    b2 = torch.randn(768, generator=generator, device=device) * 0.1
    before = dm.decode_ffn.mode_launches[mode]
    got = dm.decode_ffn(x, w1, b1, w2, b2)
    want = dm.decode_ffn_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert got.shape == (batch, 768) and got.dtype == torch.bfloat16
    assert dm.decode_ffn.mode_launches[mode] - before == -(-batch // 8)
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


# K4's edges: batches under, at and over one launch's rows; K at GPT-2's
# widths and one that splits unevenly over the cluster (200 = 8 x 25, not a
# multiple of 8 x 16); N at GPT-2's widths, under one 32-column tile, and a
# multiple of 16 that is not one of 32 (the last tile half empty)
K4_EDGES = [(768, 2304), (768, 768), (3072, 768), (200, 16), (768, 784)]


def _decode_weight(generator, mode, shape, device):
    if mode == 'bf16':
        return _normal(generator, shape, shape[0] ** -0.5, device)
    return quantize_leaf(torch.randn(shape, generator=generator,
                                     device=device) * shape[0] ** -0.5, mode)


@pytest.mark.parametrize('mode', ['bf16', 'int8', 'fp8'])
@pytest.mark.parametrize('batch', [1, 8, 16, 19])
@pytest.mark.parametrize('inner,cols', K4_EDGES)
def test_decode_matmul_edges_match_plain_and_repeat(device, mode, batch,
                                                    inner, cols):
    """The cluster-split K4 at every weight type within 2**-7 of the
    largest output, one launch per slice of 16 (bf16) or 8 rows, and
    bitwise on a repeat (the cluster sums in rank order)."""
    generator = torch.Generator(device).manual_seed(batch * inner + cols)
    x = _normal(generator, (batch, inner), 1.0, device)
    w = _decode_weight(generator, mode, (inner, cols), device)
    bias = torch.randn(cols, generator=generator, device=device) * 0.1
    activation = 'gelu' if cols % 3 else None
    before = dm.decode_matmul.mode_launches[mode]
    got = dm.decode_matmul(x, w, bias, activation=activation)
    again = dm.decode_matmul(x, w, bias, activation=activation)
    want = dm.decode_matmul_plain(x, w, bias, activation=activation)
    torch.cuda.synchronize()
    rows = 16 if mode == 'bf16' else 8
    assert got.shape == (batch, cols) and got.dtype == torch.bfloat16
    assert dm.decode_matmul.mode_launches[mode] - before == 2 * -(-batch // rows)
    assert torch.equal(got, again)
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_a_refused_cluster_launch_raises(device, mode, monkeypatch):
    """A cluster of 32 blocks is past what the card takes (8 portable, 16
    with an opt-in): the launch is refused, the wrapper raises, and nothing
    is counted."""
    generator = torch.Generator(device).manual_seed(7)
    x = _normal(generator, (4, 768), 1.0, device)
    w = _decode_weight(generator, mode, (768, 768), device)
    monkeypatch.setattr(dm, 'CLUSTER', 32)
    before = dm.decode_matmul.launches
    with pytest.raises(RuntimeError, match='CUDA launch failed'):
        dm.decode_matmul(x, w)
    assert dm.decode_matmul.launches == before
    monkeypatch.setattr(dm, 'CLUSTER', 8)
    torch.cuda.synchronize()
    _close(dm.decode_matmul(x, w), dm.decode_matmul_plain(x, w),
           2 ** -7 * dm.decode_matmul_plain(x, w).float().abs().max().item())


# K5's edges (inner, hidden, cols): GPT-2's FFN, GPT-2 tiny's, K uneven over
# 16 with H off a cluster's hidden slab (b1 large, so a leaked gelu(b1)
# would show) and N under one 32-column tile, N off a multiple of 32, and
# GPT-2 XL's FFN, whose weight boxes pass through a block's ring of slots
# more than once
K5_EDGES = [(768, 3072, 768), (64, 256, 64), (200, 272, 48), (768, 3072, 784),
            (1600, 6400, 1600)]


def _ffn_inputs(generator, mode, batch, inner, hidden, cols, device):
    x = _normal(generator, (batch, inner), 1.0, device)
    w1 = _decode_weight(generator, mode, (inner, hidden), device)
    w2 = _decode_weight(generator, mode, (hidden, cols), device)
    b1 = torch.randn(hidden, generator=generator, device=device) * (
        4.0 if hidden % 256 else 0.1)
    b2 = torch.randn(cols, generator=generator, device=device) * 0.1
    return x, w1, b1, w2, b2


@pytest.mark.parametrize('mode', ['bf16', 'int8', 'fp8'])
@pytest.mark.parametrize('batch', [1, 8, 16, 19])
@pytest.mark.parametrize('inner,hidden,cols', K5_EDGES)
def test_decode_ffn_edges_match_plain_and_repeat(device, mode, batch, inner,
                                                 hidden, cols):
    """The cluster K5 at every weight type within 2**-7 of the largest
    output of the plain version, one launch per slice of 16 (bf16) or 8
    rows, and bitwise on a repeat (the slabs are summed in slab order)."""
    generator = torch.Generator(device).manual_seed(batch * inner + hidden
                                                    + cols)
    args = _ffn_inputs(generator, mode, batch, inner, hidden, cols, device)
    before = dm.decode_ffn.mode_launches[mode]
    got = dm.decode_ffn(*args)
    again = dm.decode_ffn(*args)
    want = dm.decode_ffn_plain(*args)
    torch.cuda.synchronize()
    rows = 16 if mode == 'bf16' else 8
    assert got.shape == (batch, cols) and got.dtype == torch.bfloat16
    assert dm.decode_ffn.mode_launches[mode] - before == 2 * -(-batch // rows)
    assert torch.equal(got, again)
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('mode', ['int8', 'fp8'])
def test_k5_widens_every_narrow_value_exactly(device, mode):
    """Every int8 byte and every finite e4m3 byte, subnormals included,
    through K5: x picks row b of w1 for output row b and w2 is the identity,
    all scales 1 and biases 0, so output [b, n] is gelu(widen(w1[b, n]))
    rounded to bf16. It must be the plain version's within 2**-7 of
    |widen(w1[b, n])|: a flushed subnormal would be off by half of itself."""
    dtype = torch.int8 if mode == 'int8' else torch.float8_e4m3fn
    codes = (torch.arange(16).view(16, 1) * 32
             + torch.arange(256).view(1, 256)) % 256
    codes[8:] = 0
    if mode == 'fp8':
        codes[codes % 128 == 127] = 0             # the two NaN codes
    values = codes.to(torch.uint8).view(dtype).to(device)
    ones = torch.ones(1, 256, device=device)
    w1 = QuantizedLeaf(values, ones)
    w2 = QuantizedLeaf(torch.eye(256, device=device).to(dtype), ones)
    x = torch.eye(8, 16, device=device).to(torch.bfloat16)
    zeros = torch.zeros(256, device=device)
    got = dm.decode_ffn(x, w1, zeros, w2, zeros)
    want = dm.decode_ffn_plain(x, w1, zeros, w2, zeros)
    torch.cuda.synchronize()
    widened = values[:8].float()
    assert ((got.float() - want.float()).abs() <= 2 ** -7 * widened.abs()).all()


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_a_refused_cluster_launch_of_k5_raises(device, mode, monkeypatch):
    """K5 at a cluster of 32 blocks, past what the card takes: the launch
    is refused, the wrapper raises, nothing is counted, and the next call
    at 8 blocks gives the plain result."""
    generator = torch.Generator(device).manual_seed(11)
    args = _ffn_inputs(generator, mode, 4, 768, 3072, 768, device)
    monkeypatch.setattr(dm, 'CLUSTER', 32)
    before = dm.decode_ffn.launches
    with pytest.raises(RuntimeError, match='CUDA launch failed'):
        dm.decode_ffn(*args)
    assert dm.decode_ffn.launches == before
    monkeypatch.setattr(dm, 'CLUSTER', 8)
    torch.cuda.synchronize()
    want = dm.decode_ffn_plain(*args)
    _close(dm.decode_ffn(*args), want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_k5_past_its_shared_memory_raises(device, mode):
    """K5 at K = 12,800, where x's 8 rows no longer fit a block beside one
    weight box, raises and counts nothing; at K = 6,400 the same 8 rows
    fit, the boxes pass through the ring many times, and the result is the
    plain version's. bf16 at 16 rows reaches only about K = 6,100, so 6,400
    raises there too."""
    generator = torch.Generator(device).manual_seed(17)
    for inner in (12800,) + ((6400,) if mode == 'bf16' else ()):
        batch = 8 if inner == 12800 else 16
        args = _ffn_inputs(generator, mode, batch, inner, 256, 64, device)
        before = dm.decode_ffn.launches
        with pytest.raises(RuntimeError, match='CUDA launch failed'):
            dm.decode_ffn(*args)
        assert dm.decode_ffn.launches == before
    args = _ffn_inputs(generator, mode, 8, 6400, 256, 64, device)
    got = dm.decode_ffn(*args)
    want = dm.decode_ffn_plain(*args)
    torch.cuda.synchronize()
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


def test_k5_on_two_streams_gives_the_plain_result(device):
    """K5 launches in flight on two streams at once: each stream has its
    own ticket counters and partials, so every result equals the default
    stream's bit for bit and the plain version within tolerance."""
    generator = torch.Generator(device).manual_seed(13)
    sets = [_ffn_inputs(generator, mode, 8, 768, 3072, 768, device)
            for mode in ('bf16', 'bf16')]
    alone = [dm.decode_ffn(*args) for args in sets]
    streams = [torch.cuda.Stream(device) for _ in sets]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream(device))
    outputs = [[], []]
    for _ in range(20):
        for k, (stream, args) in enumerate(zip(streams, sets)):
            with torch.cuda.stream(stream):
                outputs[k].append(dm.decode_ffn(*args))
    torch.cuda.synchronize()
    for k, args in enumerate(sets):
        assert all(torch.equal(got, alone[k]) for got in outputs[k])
        want = dm.decode_ffn_plain(*args)
        _close(outputs[k][-1], want,
               2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('shape', [(1,), (1000,), (3, 77, 5), (16, 128, 768)])
@pytest.mark.parametrize('keep', [0.9, 0.5])
def test_threefry_mask_kernel_equals_the_plain_bits(device, shape, keep):
    key = (0x12345678, 0x9ABCDEF0)
    before = tf.bernoulli_mask.launches
    got = tf.bernoulli_mask(key, keep, shape, device)
    torch.cuda.synchronize()
    assert tf.bernoulli_mask.launches - before == 1
    assert got.dtype == torch.bool and got.shape == shape
    assert torch.equal(got.cpu(), tf.bernoulli_mask_plain(key, keep, shape))


@pytest.mark.parametrize('rows', [1, 8, 13])
@pytest.mark.parametrize('cols', [256, 50257, 128256])
def test_row_uniforms_kernel_equals_the_plain_bits(device, rows, cols):
    """The sampler's per-row uniforms, bitwise the plain version's: one key
    a row (``stride`` 0), and one key over the rows (``stride == cols``,
    ``generate``'s draw); 50,257 and 128,256 are off the 256-thread block."""
    from tpusystem_torch.ops import threefry
    keys = [threefry.fold_in(threefry.PRNGKey(seed), 3 * seed + 1)
            for seed in range(rows)]
    for stride, keyset in ((0, keys), (cols, [keys[-1]] * rows)):
        table = threefry.key_tensor(keyset)
        before = tf.row_uniforms.launches
        got = tf.row_uniforms(table.to(device), cols, stride)
        torch.cuda.synchronize()
        assert tf.row_uniforms.launches - before == 1
        assert got.dtype == torch.float32 and got.shape == (rows, cols)
        want = tf.row_uniforms_plain(table, cols, stride)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


def test_sampler_on_the_card_matches_the_cpu(device):
    """``sample_rows`` on the same logits on the card (the uniforms from the
    kernel) and on the CPU (the plain bits) picks the same tokens; the
    ``log`` s are the card's and the CPU's, an ulp apart at most, which moves
    no token on these rows."""
    from tpusystem_torch.ops import threefry
    from tpusystem_torch.train.generate import sample_rows, sampling_key
    generator = torch.Generator().manual_seed(5)
    logits = torch.randn((8, 50257), generator=generator) * 3
    mask = torch.rand((8, 50257), generator=generator) > 0.2
    temperature = torch.tensor([0.0, 0.8, 0.8, 1.0, 1.3, 0.7, 2.0, 0.9])
    top_k = torch.tensor([0, 0, 40, 0, 1, 8, 0, 16])
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.9, 1.0, 1.0, 0.5, 0.95])
    for position in range(4):
        keys = threefry.key_tensor([sampling_key(seed, position)
                                    for seed in range(8)])
        before = tf.row_uniforms.launches
        got = sample_rows(*(t.to(device) for t in (
            logits, keys, temperature, top_k, top_p, mask)))
        assert tf.row_uniforms.launches - before == 1
        want = sample_rows(logits, keys, temperature, top_k, top_p, mask)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize('shape', [(50257,), (3, 50257), (2, 4, 256)])
def test_categorical_on_the_card_is_one_kernel_draw(device, shape):
    """``categorical`` on a card tensor draws its uniforms with the kernel,
    once a call, and picks the CPU's tokens on the same logits."""
    from tpusystem_torch.ops import threefry
    generator = torch.Generator().manual_seed(len(shape))
    logits = torch.randn(shape, generator=generator) * 3
    for seed in range(4):
        key = threefry.PRNGKey(seed)
        before = tf.row_uniforms.launches
        got = threefry.categorical(key, logits.to(device))
        assert tf.row_uniforms.launches - before == 1
        assert torch.equal(got.cpu(), threefry.categorical(key, logits))


def test_an_mlp_built_on_the_card_draws_other_weights(device):
    """An ``MLP`` draws its first weights from a generator seeded 0 on its
    own device, and the card's generator gives other numbers than the
    CPU's: two MLPs built on the two devices start apart, so a parity test
    loads one's weights into the other."""
    from tpusystem_torch.models import MLP
    card = MLP(features=(128, 64), device=device).state_dict()
    cpu = MLP(features=(128, 64), device='cpu').state_dict()
    assert not torch.equal(card['Dense_0.weight'].cpu(),
                           cpu['Dense_0.weight'])


@pytest.mark.parametrize('rule', ['sgd', 'adam'])
def test_mlp_dropout_step_on_the_card_matches_the_cpu(device, rule):
    """Three steps of the verybasic MLP at dropout 0.1 on the card and on
    the CPU, from the same weights (the CPU module's, loaded into the
    card's: see the test above) and seed: the mask kernel once a step and
    hidden layer, the same masks, so losses and parameters agree within
    1e-5 (float32 sums in another order), with SGD and with the example's
    Adam."""
    from tpusystem_torch.data import SyntheticDigits
    from tpusystem_torch.models import MLP
    from tpusystem_torch.train import (SGD, Adam, CrossEntropyLoss,
                                       build_train_step, init_state,
                                       module_apply)

    images, labels = SyntheticDigits(samples=64)[np.arange(64)]
    weights = MLP(features=(128, 64), device='cpu').state_dict()
    results = []
    for where in (device, torch.device('cpu')):
        module = MLP(features=(128, 64), device=where)
        module.load_state_dict(weights)
        optimizer = SGD(lr=0.1) if rule == 'sgd' else Adam(lr=1e-3)
        state = init_state(module, optimizer, rng=3)
        step = build_train_step(module_apply(module), CrossEntropyLoss(),
                                optimizer)
        before = tf.bernoulli_mask.launches
        losses = [step(state, torch.from_numpy(images).to(where),
                       torch.from_numpy(labels).to(where))[1][1].item()
                  for _ in range(3)]
        if where.type == 'cuda':
            assert tf.bernoulli_mask.launches - before == 3 * 2
        results.append((losses, {name: p.detach().cpu()
                                 for name, p in state.params.items()}))
    (card, card_params), (cpu, cpu_params) = results
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-5)
    for name, tensor in cpu_params.items():
        np.testing.assert_allclose(card_params[name].numpy(), tensor.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_gpt2_tiny_dropout_step_on_the_card_matches_the_cpu(device):
    """Two SGD steps of gpt2_tiny(dropout=0.1) in float32 on ``'xla'``
    attention (every mask, the attention probabilities' too, from the mask
    kernel) from the same weights and seed on the card and on the CPU (the
    plain bits): the same masks, so losses and parameters agree within
    1e-5 (float32 sums in another order)."""
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.train import (SGD, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    tokens = torch.as_tensor(np.random.default_rng(8).integers(0, 256,
                                                               (2, 64)))
    weights = gpt2_tiny(device='cpu').state_dict()
    results = []
    for where in (device, torch.device('cpu')):
        module = gpt2_tiny(dtype='float32', attention='xla', dropout=0.1,
                           return_features=True, device=where)
        module.load_state_dict(weights)
        optimizer = SGD(lr=0.1)
        state = init_state(module, optimizer, rng=3)
        step = build_train_step(module_apply(module),
                                ChunkedNextTokenLoss(chunks=2), optimizer)
        before = tf.bernoulli_mask.launches
        losses = [step(state, tokens.to(where), tokens.to(where))[1][1].item()
                  for _ in range(2)]
        masks = 2 * (1 + 3 * module.layers)
        if where.type == 'cuda':
            assert tf.bernoulli_mask.launches - before == masks
        results.append((losses, {name: p.detach().cpu()
                                 for name, p in state.params.items()}))
    (card, card_params), (cpu, cpu_params) = results
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-5)
    for name, value in card_params.items():
        torch.testing.assert_close(value, cpu_params[name], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('batch,seq,heads,kv_heads,head_dim,causal', [
    (1, 512, 12, 12, 64, True),
    (1, 1024, 12, 12, 64, True),
    (2, 200, 4, 2, 32, True),
    (1, 65, 6, 3, 16, False),
    # head dim 128 (Llama): MHA, GQA groups 4 and 8, ragged, non-causal
    (2, 256, 8, 8, 128, True),
    (1, 512, 32, 8, 128, True),
    (1, 1000, 8, 1, 128, True),
    (1, 2048, 32, 8, 128, True),
    (1, 300, 4, 4, 128, False),
    (2, 130, 8, 2, 128, False),
    # the edges of K1's 128-row tiles: S of 1 to 1000 around 64 and 128,
    # every head dim, GQA groups 1, 3, 4 and 8, causal or not, B > 1
    (1, 1, 4, 4, 64, True),
    (2, 1, 8, 1, 128, False),
    (1, 63, 6, 2, 16, True),
    (2, 63, 8, 2, 32, False),
    (1, 65, 8, 8, 128, True),
    (2, 127, 12, 4, 64, True),
    (1, 127, 4, 4, 16, False),
    (1, 128, 8, 1, 64, True),
    (2, 128, 6, 2, 128, False),
    (1, 129, 16, 2, 32, True),
    (2, 129, 8, 8, 16, False),
    (1, 255, 12, 3, 128, True),
    (2, 255, 4, 4, 64, False),
    (1, 1000, 24, 8, 64, False),
    (2, 1000, 8, 1, 32, True),
    (1, 1000, 6, 2, 16, True),
])
def test_flash_matches_plain(device, batch, seq, heads, kv_heads, head_dim,
                             causal):
    generator = torch.Generator(device).manual_seed(seq)
    q = _normal(generator, (batch, seq, heads, head_dim), 1.0, device)
    k = _normal(generator, (batch, seq, kv_heads, head_dim), 1.0, device)
    v = _normal(generator, (batch, seq, kv_heads, head_dim), 1.0, device)
    before = flash.flash_attention_lse.launches
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal)
    want_out, want_lse = flash.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_attention_lse.launches - before == 1
    assert out.shape == q.shape and lse.shape == (batch, seq, heads)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    _close(out, want_out, 2e-2)
    _close(lse, want_lse, 1e-3)


@pytest.mark.parametrize('head_dim', flash.HEAD_DIMS)
def test_flash_at_head_dim_128_repeats_bitwise(device, head_dim):
    """K1 gives the same bits on a repeat (no atomics), at 128 and at every
    other head dim it takes."""
    generator = torch.Generator(device).manual_seed(head_dim)
    q = _normal(generator, (1, 1000, 16, head_dim), 1.0, device)
    k = _normal(generator, (1, 1000, 4, head_dim), 1.0, device)
    v = _normal(generator, (1, 1000, 4, head_dim), 1.0, device)
    first = flash.flash_attention_lse(q, k, v)
    again = flash.flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize('which', ['query', 'key'])
def test_flash_refuses_a_view_off_16_bytes(device, which):
    """K1's TMA needs each tensor on a 16-byte boundary: a contiguous view
    two bytes off one raises ``ValueError`` and launches nothing (no copy,
    no fallback)."""
    shape = (1, 64, 2, 64)
    flat = torch.zeros(math.prod(shape) + 1, dtype=torch.bfloat16,
                       device=device)
    tensors = {name: torch.zeros(shape, dtype=torch.bfloat16, device=device)
               for name in ('query', 'key', 'value')}
    tensors[which] = flat[1:].view(shape)
    assert tensors[which].is_contiguous() and tensors[which].data_ptr() % 16
    before = flash.flash_attention_lse.launches
    with pytest.raises(ValueError, match='16-byte'):
        flash.flash_attention_lse(tensors['query'], tensors['key'],
                                  tensors['value'])
    assert flash.flash_attention_lse.launches == before


@pytest.mark.parametrize('heads,kv_heads', [(2, 2), (4, 1)])
def test_head_dim_128_dropout_masks_equal_the_plain_hash_bitwise(
        device, heads, kv_heads):
    """K1 at head dim 128 applies exactly the plain hash's keep masks at
    p = 0.1, read back from its output as ``chip_smoke.py`` reads them; and
    its dropped output and lse agree with the plain version."""
    import chip_smoke

    generator = torch.Generator(device).manual_seed(heads * 16 + kv_heads)
    seed, batch, seq = 123_456_789, 2, 128
    got = chip_smoke.forward_masks(torch, generator, batch, seq, heads,
                                   kv_heads, seed, head_dim=128)
    positions = torch.arange(seq, device=device)
    head_rows = torch.arange(batch * heads, device=device).reshape(
        batch, heads, 1, 1)
    want = flash.keep_mask(seed, head_rows, positions[:, None],
                           positions[None, :], 0.1)
    visible = torch.ones(seq, seq, dtype=torch.bool, device=device).tril()
    assert not (((got < 0) | (got.bool() != want)) & visible).any()
    q = _normal(generator, (batch, 300, heads, 128), 1.0, device)
    k = _normal(generator, (batch, 300, kv_heads, 128), 1.0, device)
    v = _normal(generator, (batch, 300, kv_heads, 128), 1.0, device)
    out, lse = flash.flash_attention_lse(q, k, v, dropout=0.1, seed=seed)
    want_out, want_lse = flash.flash_attention_plain(q, k, v, dropout=0.1,
                                                     seed=seed)
    torch.cuda.synchronize()
    _close(out, want_out, 2e-2)
    _close(lse, want_lse, 1e-3)


def test_flash_backward_at_head_dim_128_launches_each_kernel_once(device):
    """At head dim 128 a forward that autograd differentiates runs K1, and
    its backward launches the fused kernel K2b once (GQA); each backward
    entry launches its own kernel once; all match the plain backward."""
    generator = torch.Generator(device).manual_seed(7)
    q, d_out = (_normal(generator, (1, 256, 4, 128), 1.0, device)
                for _ in range(2))
    k, v = (_normal(generator, (1, 256, 2, 128), 1.0, device)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused_g1,
                flash.flash_bwd_fused, flash.flash_bwd_dq,
                flash.flash_bwd_dkv)
    before = [counter.launches for counter in counters]
    out, lse = flash.flash_attention_lse(*leaves)
    got = torch.autograd.grad(out, leaves, d_out)
    assert [c.launches - b for c, b in zip(counters, before)] == [
        1, 0, 1, 0, 0]
    want = flash.flash_attention_bwd_plain(q, k, v, out.detach(),
                                           lse.detach(), d_out)
    _close_grads(got, want)
    delta = flash.attention_delta(out.detach(), d_out).contiguous()
    args = (q, k, v, d_out, lse.detach(), delta)
    before = [counter.launches for counter in counters]
    _close_grads(flash.flash_bwd_fused(*args), want)
    _close_grads((flash.flash_bwd_dq(*args), *flash.flash_bwd_dkv(*args)),
                 want)
    out, lse = flash.flash_attention_plain(q, k.repeat(1, 1, 2, 1),
                                           v.repeat(1, 1, 2, 1))
    mha = (q, k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1), d_out, lse,
           flash.attention_delta(out, d_out).contiguous())
    _close_grads(flash.flash_bwd_fused_g1(*mha),
                 flash.flash_attention_bwd_plain(*mha[:3], out, lse, d_out))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        0, 1, 1, 1, 1]


@pytest.mark.parametrize('batch,seq,heads,kv_heads,head_dim', [
    (2, 1024, 6, 6, 64),        # GPT-2 125M at TP = 2: a rank's 6 heads
    (1, 1024, 16, 4, 128),      # Llama-3 8B at TP = 2: 16 q / 4 kv heads
])
def test_flash_at_tensor_parallel_shapes_matches_plain(
        device, batch, seq, heads, kv_heads, head_dim):
    """K1 and, in autograd's backward, K2b at the head counts one rank of a
    two-rank ``model`` axis gives them (the sharded flash call), each
    launched once and held to its plain version."""
    generator = torch.Generator(device).manual_seed(heads * 1000 + head_dim)
    q, d_out = (_normal(generator, (batch, seq, heads, head_dim), 1.0,
                        device) for _ in range(2))
    k, v = (_normal(generator, (batch, seq, kv_heads, head_dim), 1.0, device)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused)
    before = [counter.launches for counter in counters]
    out, lse = flash.flash_attention_lse(*leaves)
    got = torch.autograd.grad(out, leaves, d_out)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1]
    want_out, want_lse = flash.flash_attention_plain(q, k, v)
    _close(out, want_out, 2e-2)
    _close(lse, want_lse, 1e-3)
    _close_grads(got, flash.flash_attention_bwd_plain(
        q, k, v, out.detach(), lse.detach(), d_out))


def test_llama_serves_through_the_engine_on_the_card(device):
    """A head-dim-128 Llama on the card through generate and the Engine:
    a 600-token prompt prefills through K1 (one launch a layer), the decode
    runs the module paged step (K4/K5 never launch), and the logits
    through the paged cache agree with the non-cached forward within
    2**-4 of the largest logit (bf16 rounding at other points)."""
    from tpusystem_torch.models import llama_tiny
    from tpusystem_torch.serve import Engine
    from tpusystem_torch.train import generate

    module = llama_tiny(dim=256, heads=2, kv_heads=1, max_seq=1024,
                        device=device)
    prompt = np.random.default_rng(3).integers(0, 256, (600,))
    before = (dm.decode_matmul.launches, dm.decode_ffn.launches,
              flash.flash_attention_lse.launches)
    out = generate(module, None, prompt[None], steps=4)
    assert out.shape == (1, 604) and out.device.type == 'cuda'
    engine = Engine(module, None, rows=2, block_size=16)
    assert engine.decode_impl == 'flax'
    tokens = list(prompt) + [engine.admit(prompt, max_new=6).token]
    with torch.no_grad():
        full = module(torch.as_tensor([tokens], device=device))[0, -1]
    _close(engine.next_logits()[0], full, 2 ** -4 * full.abs().max().item())
    while engine.active_rows:
        engine.step()
    assert (dm.decode_matmul.launches, dm.decode_ffn.launches) == before[:2]
    assert flash.flash_attention_lse.launches - before[2] == 2 * module.layers


def test_generate_and_engine_run_the_kernels_on_the_card(device):
    """The slice's entry points on the card at test size (bf16): generate
    through both decode paths, and an Engine whose 300-token prompt pads to
    the 512 bucket (flash) — the fused step's logits within bf16 reach of
    the module path's (2**-4 of the largest logit, as in chip_smoke)."""
    import numpy as np

    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.serve import Engine
    from tpusystem_torch.train import generate

    module = gpt2_tiny(max_seq=512, device=device)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 9))
    before = dm.decode_matmul.launches, dm.decode_ffn.launches
    for impl in ('flax', 'fused'):
        out = generate(module, None, prompt, steps=6, decode_impl=impl)
        assert out.shape == (2, 15) and out.dtype == torch.int32
        assert out.device.type == 'cuda'
    assert dm.decode_matmul.launches - before[0] == 2 * 2 * 5
    assert dm.decode_ffn.launches - before[1] == 2 * 5

    engine = Engine(module, None, rows=2, block_size=16)
    assert engine.decode_impl == 'fused'
    flashes = flash.flash_attention_lse.launches
    engine.admit(np.arange(300) % 256, max_new=4)
    assert flash.flash_attention_lse.launches - flashes == module.layers
    fused = engine.next_logits('fused')
    module_path = engine.next_logits('flax')
    assert torch.isfinite(fused).all()
    _close(fused, module_path, 2 ** -4 * module_path.abs().max().item())
    while engine.active_rows:
        engine.step()


@pytest.mark.parametrize('mode', ['int8', 'fp8'])
def test_quantized_generate_and_engine_run_the_narrow_kernels(device, mode):
    """generate and the Engine at ``stream_dtype=mode`` on the card: the
    fused path launches the int8 / fp8 kernels, and one fused step's logits
    stay within bf16 reach of the module path's on the same quantized state
    (2**-4 of the largest logit, as in chip_smoke)."""
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.serve import Engine
    from tpusystem_torch.train import generate

    module = gpt2_tiny(device=device)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 9))
    before = (dm.decode_matmul.mode_launches[mode],
              dm.decode_ffn.mode_launches[mode])
    outputs = [generate(module, None, prompt, steps=6, decode_impl=impl,
                        stream_dtype=mode) for impl in ('flax', 'fused')]
    assert all(out.shape == (2, 15) for out in outputs)
    assert dm.decode_matmul.mode_launches[mode] - before[0] == 2 * 2 * 5
    assert dm.decode_ffn.mode_launches[mode] - before[1] == 2 * 5

    engine = Engine(module, None, rows=2, block_size=16, stream_dtype=mode)
    assert engine.decode_impl == 'fused'
    engine.admit(np.arange(40) % 256, max_new=4)
    fused = engine.next_logits('fused')
    module_path = engine.next_logits('flax')
    assert torch.isfinite(fused).all()
    _close(fused, module_path, 2 ** -4 * module_path.abs().max().item())
    while engine.active_rows:
        engine.step()


def _serve(engine, prompts, max_new):
    """Admit ``prompts`` and step until every request finishes: each
    request's tokens and the step count."""
    rows = [engine.admit(prompt, max_new=max_new).row for prompt in prompts]
    tokens, steps = {}, 0
    while engine.active_rows:
        for row, _reason, out in engine.step().finished:
            tokens[row] = out
        steps += 1
    return [tokens[row] for row in rows], steps


def test_speculative_engine_steps_on_the_card(device):
    """Speculative rows on the card (a float32 GPT-2 tiny drafting for
    itself, fanout 1 and 2): the module paged verify (K4/K5 never launch),
    fewer steps than tokens, the streams equal the plain module-path
    engine's on the card, and the pool ends clean."""
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.serve import Engine

    module = gpt2_tiny(dtype='float32', device=device)
    prompts = [np.random.default_rng(seed).integers(0, 256, (n,))
               for seed, n in ((0, 9), (1, 20), (2, 5))]
    want, _ = _serve(Engine(module, None, rows=4, block_size=16,
                            decode_impl='flax'), prompts, 12)
    before = dm.decode_matmul.launches, dm.decode_ffn.launches
    for fanout in (1, 2):
        engine = Engine(module, None, rows=3 * fanout, block_size=16,
                        draft_module=module, speculate=3,
                        tree_fanout=fanout)
        assert engine.decode_impl == 'flax'
        got, steps = _serve(engine, prompts, 12)
        assert got == want and steps < 12
        audit = engine.pool.audit()
        assert audit['live'] == 0 and audit['free'] == engine.pool.blocks - 1
    assert (dm.decode_matmul.launches, dm.decode_ffn.launches) == before


def test_moe_engine_steps_run_the_grouped_kernels_on_the_card(device):
    """An MoE GPT-2 tiny (bf16, ``moe_sparse_impl='fused'``) through the
    engine on the card: the module paged step, K6 and K7 once per MoE block
    a prefill and a decode step, K4/K5 never; the next step's logits within
    2**-4 of the largest logit of the same state through the gather impl
    (bf16 rounding at other points)."""
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.serve import Engine

    module = gpt2_tiny(moe_experts=4, moe_every=2, moe_sparse_impl='fused',
                       device=device)
    engine = Engine(module, None, rows=2, block_size=16)
    assert engine.decode_impl == 'flax'
    prompts = [np.arange(n) % 256 for n in (9, 30)]
    grouped = gm.gather_rows_matmul.launches, gm.matmul_scatter_rows.launches
    decode = dm.decode_matmul.launches, dm.decode_ffn.launches
    for prompt in prompts:
        engine.admit(prompt, max_new=6)
    engine.step()
    moe_layers = sum(module.is_moe(i) for i in range(module.layers))
    assert gm.gather_rows_matmul.launches - grouped[0] == 3 * moe_layers
    assert gm.matmul_scatter_rows.launches - grouped[1] == 3 * moe_layers
    fused = engine.next_logits()
    gather = Engine(module.replace(moe_sparse_impl='gather'), None, rows=2,
                    block_size=16)
    for prompt in prompts:
        gather.admit(prompt, max_new=6)
    gather.step()
    want = gather.next_logits()
    assert torch.isfinite(fused).all()
    _close(fused, want, 2 ** -4 * want.abs().max().item())
    while engine.active_rows:
        engine.step()
    assert (dm.decode_matmul.launches, dm.decode_ffn.launches) == decode


def test_llama_tiny_serves_int8_weights_on_the_card(device):
    """``llama_tiny`` through the engine at ``stream_dtype='int8'`` on the
    card: the module paged step on the dequantized view (K4/K5 never
    launch), in-vocabulary tokens, and the logits through the paged cache
    within 2**-4 of the largest logit of the non-cached forward on the same
    dequantized weights."""
    from tpusystem_torch.models import llama_tiny
    from tpusystem_torch.ops.precision import dequantize_streamed
    from tpusystem_torch.serve import Engine

    module = llama_tiny(device=device)
    engine = Engine(module, None, rows=2, block_size=16, stream_dtype='int8')
    assert engine.decode_impl == 'flax'
    assert any(isinstance(leaf, QuantizedLeaf)
               for leaf in engine._params.values())
    before = dm.decode_matmul.launches, dm.decode_ffn.launches
    prompt = np.random.default_rng(5).integers(0, 256, (40,))
    admission = engine.admit(prompt, max_new=8)
    tokens = list(prompt) + [admission.token]
    got = engine.next_logits()[admission.row]
    weights = dequantize_streamed(engine._params, module.compute_dtype)
    with torch.no_grad():
        full = torch.func.functional_call(
            module.replace(decode=False), weights,
            (torch.as_tensor([tokens], device=device),))[0, -1]
    _close(got, full, 2 ** -4 * full.abs().max().item())
    while engine.active_rows:
        for _row, _reason, out in engine.step().finished:
            assert len(out) == 8 and all(0 <= t < 256 for t in out)
    assert (dm.decode_matmul.launches, dm.decode_ffn.launches) == before


def _bwd_inputs(device, batch, seq, heads, kv_heads, seed, head_dim=64):
    generator = torch.Generator(device).manual_seed(seed)
    shape = (batch, seq, heads, head_dim)
    kv_shape = (batch, seq, kv_heads, head_dim)
    q, k, v, d_out = (_normal(generator, s, 1.0, device)
                      for s in (shape, kv_shape, kv_shape, shape))
    d_lse = torch.randn((batch, seq, heads), generator=generator,
                        device=device) * 0.1
    return q, k, v, d_out, d_lse


def _close_grads(got, want):
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g.float()).all(), name
        _close(g, w, 2 ** -6 * w.float().abs().max().item())


def _head_dim_cases(cases, cases_128, edges=()):
    """``cases`` at head dim 64 under their earlier ids, then ``cases_128``
    at head dim 128, ids ending ``-d128``, then ``edges``: ``(case,
    head_dim)`` pairs, ids ending ``-edge-d{head_dim}``."""
    return ([pytest.param(*case, 64, id='-'.join(map(str, case)))
             for case in cases]
            + [pytest.param(*case, 128, id='-'.join(map(str, case)) + '-d128')
               for case in cases_128]
            + [pytest.param(*case, head_dim, id='-'.join(map(str, case))
                            + f'-edge-d{head_dim}')
               for case, head_dim in edges])


# The fused kernel's tile edges at every head dim: one 64-row q tile (64),
# one 128-row kv tile (127, 128), one past it (129), a q tile past the
# diagonal pair (192) and a long ragged length (1000); GQA groups 1, 2, 4
# and 8 and causal or not in turn. (batch, seq, heads, kv_heads, causal).
EDGE_SEQS = (64, 127, 128, 129, 192, 1000)
BWD_EDGES = tuple(
    ((2, seq, 8, 8 // group, index % 2 == 0), head_dim)
    for head_dim in (16, 32, 64, 128)
    for index, (seq, group) in enumerate(zip(EDGE_SEQS, (2, 1, 4, 8, 2, 4))))
# The split pair's tile edges at every head dim: one row (1), either side
# of K3b's 64-row q tile (63, 65) and of K3a's 128-row tiles (127, 129), a
# long ragged length (1000); GQA groups 1, 3 and 4 and causal or not in
# turn, an lse cotangent in every case.
SPLIT_EDGE_SEQS = (1, 63, 65, 127, 129, 1000)
SPLIT_EDGES = tuple(
    ((2, seq, 12, 12 // group, index % 2 == 1), head_dim)
    for head_dim in (16, 32, 64, 128)
    for index, (seq, group) in enumerate(zip(SPLIT_EDGE_SEQS,
                                             (1, 3, 4, 1, 3, 4))))


@pytest.mark.parametrize('batch,seq,heads,kv_heads,causal,head_dim',
                         _head_dim_cases([
                             (1, 1024, 12, 12, True),
                             (8, 512, 12, 12, True),
                             (2, 256, 12, 4, True),      # GQA group 3
                             (1, 300, 4, 4, False),      # non-causal, ragged
                             (2, 1000, 4, 2, True),      # ragged, GQA
                             (1, 1, 2, 2, True),
                         ], [
                             (1, 2048, 32, 8, True),     # Llama-3 8B's heads
                             (2, 256, 8, 8, True),       # MHA
                             (1, 1000, 8, 2, True),      # ragged, GQA
                             (1, 300, 4, 4, False),      # non-causal, ragged
                             (2, 130, 8, 1, False),      # non-causal, GQA 8
                         ], BWD_EDGES + SPLIT_EDGES))
@pytest.mark.parametrize('backward', ['fused', 'split'])
def test_flash_backward_matches_plain(device, batch, seq, heads, kv_heads,
                                      causal, head_dim, backward):
    """The fused kernel K2b, or K3a + K3b split, against the plain backward,
    one launch each; at GPT-2's and Llama's shapes and at the kernels' tile
    edges (``BWD_EDGES``, ``SPLIT_EDGES``: every head dim, GQA groups
    1-8)."""
    q, k, v, d_out, d_lse = _bwd_inputs(device, batch, seq, heads, kv_heads,
                                        seq + heads, head_dim=head_dim)
    out, lse = flash.flash_attention_plain(q, k, v, causal=causal)
    counters = ((flash.flash_bwd_fused,) if backward == 'fused'
                else (flash.flash_bwd_dq, flash.flash_bwd_dkv))
    before = [counter.launches for counter in counters]
    got = flash.flash_attention_bwd(q, k, v, out, lse, d_out, d_lse,
                                    causal=causal, backward=backward)
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, d_out, d_lse,
                                           causal=causal)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1] * len(
        counters)
    _close_grads(got, want)


@pytest.mark.parametrize('backward,head_dim', [
    pytest.param(backward, head_dim, id=backward + suffix)
    for head_dim, suffix in ((64, ''), (128, '-d128'), (16, '-d16'),
                             (32, '-d32'))
    for backward in ('fused', 'split')])
def test_flash_backward_repeats_bitwise(device, backward, head_dim):
    q, k, v, d_out, d_lse = _bwd_inputs(device, 2, 640, 8, 4, 5,
                                        head_dim=head_dim)
    out, lse = flash.flash_attention_plain(q, k, v)
    first = flash.flash_attention_bwd(q, k, v, out, lse, d_out, d_lse,
                                      backward=backward)
    second = flash.flash_attention_bwd(q, k, v, out, lse, d_out, d_lse,
                                       backward=backward)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize('batch,seq,heads,causal,head_dim', _head_dim_cases([
    (1, 2048, 4, True),             # the routed case: MHA past 1024 keys
    (2, 1100, 4, False),            # non-causal, ragged
    (1, 4100, 2, True),             # ragged, 65 tiles
    (2, 200, 3, True),              # shorter than the route, same kernel
    (1, 1, 2, True),
], [
    (1, 2048, 8, True),
    (1, 1100, 4, False),
    (2, 200, 2, True),
], [((2, 64, 4, True), 16), ((2, 129, 4, False), 32),
    ((1, 127, 2, True), 64), ((2, 64, 2, False), 128)]))
def test_k2a_equals_k2b_bitwise_and_matches_plain(device, batch, seq, heads,
                                                  causal, head_dim):
    """K2a and K2b are one kernel, which sums each dq row in kv order
    behind a ticket: under MHA dq, dk and dv equal bit for bit, repeat, and
    match the plain backward."""
    q, k, v, d_out, d_lse = _bwd_inputs(device, batch, seq, heads, heads,
                                        seq + 7, head_dim=head_dim)
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal)
    delta = flash.attention_delta(out, d_out, d_lse).contiguous()
    args = (q, k, v, d_out, lse, delta)
    before = flash.flash_bwd_fused_g1.launches
    got = flash.flash_bwd_fused_g1(*args, causal=causal)
    again = flash.flash_bwd_fused_g1(*args, causal=causal)
    k2b = flash.flash_bwd_fused(*args, causal=causal)
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, d_out, d_lse,
                                           causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_bwd_fused_g1.launches - before == 2
    for a, b, c in zip(got, again, k2b):
        assert torch.equal(a, b) and torch.equal(a, c)
    _close_grads(got, want)


@pytest.mark.parametrize('batch,seq,heads,kv_heads,causal,dropout,head_dim', [
    (2, 129, 8, 8, True, 0.0, 16),
    (2, 65, 12, 4, False, 0.0, 32),
    (1, 1000, 12, 3, True, 0.1, 64),
    (2, 640, 8, 4, True, 0.0, 64),
    (1, 2048, 32, 8, True, 0.0, 128),        # Llama-3 8B's heads
    (2, 127, 12, 12, False, 0.1, 128),
])
def test_k3b_equals_k2b_dk_dv_bitwise(device, batch, seq, heads, kv_heads,
                                      causal, dropout, head_dim):
    """K3b is the fused kernel's body without dq: its dk and dv equal K2b's
    bit for bit, with or without dropout, under MHA and GQA."""
    q, k, v, d_out, d_lse = _bwd_inputs(device, batch, seq, heads, kv_heads,
                                        seq + 3, head_dim=head_dim)
    options = dict(causal=causal, dropout=dropout,
                   seed=31_337 if dropout else None)
    out, lse = flash.flash_attention_lse(q, k, v, **options)
    delta = flash.attention_delta(out, d_out, d_lse).contiguous()
    args = (q, k, v, d_out, lse, delta)
    before = flash.flash_bwd_dkv.launches
    got = flash.flash_bwd_dkv(*args, **options)
    k2b = flash.flash_bwd_fused(*args, **options)
    torch.cuda.synchronize()
    assert flash.flash_bwd_dkv.launches - before == 1
    for a, b in zip(got, k2b[1:]):
        assert torch.equal(a, b)


def test_fused_mha_past_1024_keys_launches_k2a(device):
    q, k, v, d_out, d_lse = _bwd_inputs(device, 1, 1030, 4, 4, 11)
    out, lse = flash.flash_attention_lse(q, k, v)
    counts = (flash.flash_bwd_fused_g1.launches,
              flash.flash_bwd_fused.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash.flash_attention_lse(*leaves),
                              leaves, (d_out, d_lse))
    assert (flash.flash_bwd_fused_g1.launches - counts[0],
            flash.flash_bwd_fused.launches - counts[1]) == (1, 0)
    _close_grads(got, flash.flash_attention_bwd_plain(
        q, k, v, out, lse, d_out, d_lse))


@pytest.mark.parametrize('batch,seq,heads,kv_heads,causal,backward,head_dim', [
    (2, 384, 4, 4, True, 'fused', 64),        # K2b
    (2, 384, 6, 2, True, 'fused', 64),        # K2b, GQA
    (1, 1100, 4, 4, True, 'fused', 64),       # K2a
    (1, 300, 4, 4, False, 'split', 64),       # K3a + K3b
    (2, 256, 4, 2, True, 'split', 64),
    # the split pair's tile edges at p = 0.1, every head dim
    (2, 63, 12, 4, True, 'split', 16),
    (2, 129, 12, 4, False, 'split', 32),
    (1, 65, 12, 12, True, 'split', 64),
    (2, 127, 12, 3, False, 'split', 128),
    (1, 1000, 12, 4, True, 'split', 128),
    # the fused kernel's tile edges at p = 0.1, every head dim
    (2, 127, 8, 2, True, 'fused', 16),
    (2, 129, 8, 1, False, 'fused', 32),
    (2, 192, 8, 4, True, 'fused', 128),
    (1, 1000, 8, 8, False, 'fused', 128),
])
def test_dropout_kernels_match_plain(device, batch, seq, heads, kv_heads,
                                     causal, backward, head_dim):
    """At p = 0.1 every flash kernel hashes the plain version's masks from
    the same seed: K1's output and lse and the backward within the
    tolerances above, through the autograd Function."""
    q, k, v, d_out, d_lse = _bwd_inputs(device, batch, seq, heads, kv_heads,
                                        seq + heads, head_dim=head_dim)
    options = dict(causal=causal, dropout=0.1, seed=424_242)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash.flash_attention_lse(*leaves, backward=backward,
                                         **options)
    got = torch.autograd.grad((out, lse), leaves, (d_out, d_lse))
    want_out, want_lse = flash.flash_attention_plain(q, k, v, **options)
    want = flash.flash_attention_bwd_plain(q, k, v, out.detach(),
                                           lse.detach(), d_out, d_lse,
                                           **options)
    torch.cuda.synchronize()
    _close(out, want_out, 2e-2)
    _close(lse, want_lse, 1e-3)
    _close_grads(got, want)
    undropped, _ = flash.flash_attention_lse(q, k, v, causal=causal)
    assert not torch.equal(out.detach(), undropped)


@pytest.mark.parametrize('heads,kv_heads,head_dim', _head_dim_cases(
    [(2, 2), (4, 2), (2, 1)], [(2, 2), (4, 1)]))
def test_dropout_masks_equal_the_plain_hash_bitwise(device, heads, kv_heads,
                                                    head_dim):
    """K1, K2a, K2b, K3a and K3b apply exactly the plain hash's masks, the
    query head's row under GQA: read back from their outputs at a small
    shape (two batch rows, two tiles), every visible entry, by the same
    read-back ``chip_smoke.py`` runs."""
    import chip_smoke

    generator = torch.Generator(device).manual_seed(heads + kv_heads)
    mismatches = chip_smoke.mask_mismatches(torch, generator, heads,
                                            kv_heads, seed=987_654_321,
                                            head_dim=head_dim)
    assert len(mismatches) == (7 if heads == kv_heads else 5)
    assert not any(mismatches.values()), mismatches
    batch, seq = 2, 128
    positions = torch.arange(seq, device=device)
    head_rows = torch.arange(batch * heads, device=device).reshape(
        batch, heads, 1, 1)
    kept = flash.keep_mask(987_654_321, head_rows, positions[:, None],
                           positions[None, :], 0.1)
    visible = torch.ones(seq, seq, dtype=torch.bool, device=device).tril()
    assert abs(kept[..., visible].float().mean().item() - 0.9) < 0.01


def test_autograd_through_flash_attention_lse_on_the_card(device):
    """torch.autograd.grad through the kernels' Function, both outputs
    carrying a cotangent, against the plain backward; 'fused' and 'split'
    agree."""
    q, k, v, d_out, d_lse = _bwd_inputs(device, 2, 384, 6, 3, 9)
    grads = {}
    for backward in ('fused', 'split'):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = flash.flash_attention_lse(*leaves, backward=backward)
        grads[backward] = torch.autograd.grad((out, lse), leaves,
                                              (d_out, d_lse))
    want = flash.flash_attention_bwd_plain(q, k, v, out.detach(),
                                           lse.detach(), d_out, d_lse)
    torch.cuda.synchronize()
    _close_grads(grads['fused'], want)
    _close_grads(grads['split'], grads['fused'])


def test_gpt2_tiny_trains_on_the_card(device):
    """Three AdamW steps of gpt2_tiny (bf16, flash, chunked loss): finite
    losses that fall, the kernels launched once per layer per step."""
    import numpy as np

    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    module = gpt2_tiny(attention='flash', return_features=True,
                       device=device)
    optimizer = AdamW(lr=3e-3, grad_clip=1.0)
    state = init_state(module, optimizer)
    step = build_train_step(module_apply(module),
                            ChunkedNextTokenLoss(chunks=4), optimizer)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                               (4, 128)),
                             device=device)
    before = flash.flash_attention_lse.launches, flash.flash_bwd_fused.launches
    losses = []
    for _ in range(3):
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert (flash.flash_attention_lse.launches - before[0],
            flash.flash_bwd_fused.launches - before[1]) == (
                3 * module.layers, 3 * module.layers)
    assert int(state.step) == 3 and state.step.device.type == 'cuda'


def test_gpt2_tiny_trains_at_long_context_with_remat_on_the_card(device):
    """gpt2_tiny(remat=True) at 1,100 tokens a row (MHA past 1024 keys):
    the remat model's loss and gradient equal the plain model's bit for
    bit, and three AdamW steps launch K1 twice a layer (the recompute) and
    K2a once, with falling losses."""
    import numpy as np

    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    module = gpt2_tiny(attention='flash', return_features=True, remat=True,
                       max_seq=1100, device=device)
    criterion = ChunkedNextTokenLoss(chunks=4)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256,
                                                               (2, 1100)),
                             device=device)
    params = list(module.parameters())
    results = []
    for remat in (True, False):
        loss = criterion(module.replace(remat=remat)(tokens, train=True),
                         tokens)
        results.append((loss.detach(), torch.autograd.grad(loss, params)))
    (loss, grads), (plain_loss, plain_grads) = results
    assert torch.equal(loss, plain_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain_grads))
    optimizer = AdamW(lr=3e-3, grad_clip=1.0)
    state = init_state(module, optimizer)
    step = build_train_step(module_apply(module), criterion, optimizer)
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused_g1,
                flash.flash_bwd_fused)
    before = [counter.launches for counter in counters]
    losses = [step(state, tokens, tokens)[1][1].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert [c.launches - b for c, b in zip(counters, before)] == [
        6 * module.layers, 3 * module.layers, 0]


def test_head_dim_128_llama_trains_on_the_card_as_on_the_cpu(device):
    """A head-dim-128 Llama (bf16, flash, remat, the chunked untied head):
    one step's loss and gradient on the card (K1, K2b) against the same
    weights on the CPU (the plain versions), the loss within 1e-2 and the
    gradients' cosine above 0.999 (bf16 rounding at other points); then
    three AdamW steps on the card with falling losses, K1 twice a layer
    (the recompute) and K2b once a layer per step."""
    from tpusystem_torch.models import llama_tiny
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    config = dict(dim=256, heads=2, kv_heads=1, ffn_dim=512, max_seq=256,
                  attention='flash', remat=True, return_features=True)
    weights = llama_tiny(device='cpu', **config).state_dict()
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, 256,
                                                               (2, 256)))
    criterion = ChunkedNextTokenLoss(chunks=4, tied=False)
    results = []
    for where in (device, torch.device('cpu')):
        module = llama_tiny(device=where, **config)
        module.load_state_dict(weights)
        params = list(module.parameters())
        batch = tokens.to(where)
        loss = criterion(module(batch), batch)
        grads = torch.autograd.grad(loss, params)
        results.append((loss.item(), torch.cat([g.float().flatten().cpu()
                                                for g in grads])))
    (loss, grad), (cpu_loss, cpu_grad) = results
    assert abs(loss - cpu_loss) <= 1e-2, (loss, cpu_loss)
    assert torch.nn.functional.cosine_similarity(grad, cpu_grad,
                                                 dim=0).item() > 0.999
    module = llama_tiny(device=device, **config)
    module.load_state_dict(weights)
    optimizer = AdamW(lr=3e-3, grad_clip=1.0)
    state = init_state(module, optimizer)
    step = build_train_step(module_apply(module), criterion, optimizer)
    batch = tokens.to(device)
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused,
                flash.flash_bwd_fused_g1)
    before = [counter.launches for counter in counters]
    losses = [step(state, batch, batch)[1][1].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert [c.launches - b for c, b in zip(counters, before)] == [
        6 * module.layers, 3 * module.layers, 0]


def test_gpt2_tiny_trains_with_dropout_on_the_card(device):
    """gpt2_tiny(dropout=0.1) on flash: a fixed carried seed gives the same
    losses twice, and they fall."""
    import numpy as np

    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 256,
                                                               (4, 128)),
                             device=device)
    runs = []
    for _ in range(2):
        module = gpt2_tiny(attention='flash', return_features=True,
                           dropout=0.1, device=device)
        optimizer = AdamW(lr=3e-3, grad_clip=1.0)
        state = init_state(module, optimizer, rng=5)
        step = build_train_step(module_apply(module),
                                ChunkedNextTokenLoss(chunks=4), optimizer)
        runs.append([step(state, tokens, tokens)[1][1].item()
                     for _ in range(3)])
    assert runs[0] == runs[1]
    assert all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0], runs


def _seating(tokens, experts, k, capacity, seed):
    """Buffer row -> token (``tokens`` for an empty slot) of a top-k
    routing with k distinct experts per token, seated choice-major as the
    MoE layer seats them, over-capacity choices dropped."""
    rng = np.random.default_rng(seed)
    choices = np.argsort(rng.random((tokens, experts)), axis=1)[:, :k]
    slot_token = np.full(experts * capacity, tokens, np.int32)
    filled = np.zeros(experts, np.int64)
    for choice in range(k):
        for token in range(tokens):
            expert = choices[token, choice]
            if filled[expert] < capacity:
                slot_token[expert * capacity + filled[expert]] = token
                filled[expert] += 1
    return slot_token


def _grouped_inputs(device, tokens, experts, k, capacity, dim, hidden, seed):
    generator = torch.Generator(device).manual_seed(seed)
    slot_token = torch.as_tensor(
        _seating(tokens, experts, k, capacity, seed), device=device)
    valid = slot_token < tokens
    scale = torch.rand(experts * capacity, generator=generator,
                       device=device) * valid
    return dict(
        slot_token=slot_token, clamped=slot_token.clamp(max=tokens - 1),
        scale=scale, src=_normal(generator, (tokens, dim), 1.0, device),
        w1=_normal(generator, (experts, dim, hidden), dim ** -0.5, device),
        lhs=_normal(generator, (experts * capacity, hidden), 1.0, device),
        w2=_normal(generator, (experts, hidden, dim), hidden ** -0.5, device),
        b2=_normal(generator, (experts, dim), 0.1, device))


GROUPED_CASES = [   # tokens, experts, k, capacity, dim, hidden
    (48, 4, 2, 12, 16, 24),          # ragged tiles, sentinels
    (40, 4, 2, 12, 20, 30),          # widths off the 16-byte loads
    (40, 6, 4, 12, 32, 16),          # k = 4
    (2048, 8, 2, 640, 768, 3072),    # one MoE layer's widths
    (1024, 8, 4, 640, 256, 512),     # k = 4, no drops
    (400, 4, 2, 200, 128, 256),      # C off the 128-row tile, a seated tail
    (256, 4, 2, 160, 72, 200),       # K, N multiples of 8, not of 64
    (128, 4, 2, 80, 40, 48),         # N under one 64-column box
    (300, 1, 1, 256, 256, 512),      # one group
    (1024, 8, 4, 640, 768, 3072),    # k = 4 at full width
    (8, 8, 2, 8, 768, 3072),         # MoE serving: a decode step's 8 tokens
    (1024, 8, 2, 1024, 768, 3072),   # MoE serving: a 1,024-token prefill
]


@pytest.mark.parametrize('tokens,experts,k,capacity,dim,hidden',
                         GROUPED_CASES)
@pytest.mark.parametrize('transpose_rhs', [False, True])
def test_gather_rows_matmul_matches_plain(device, tokens, experts, k,
                                          capacity, dim, hidden,
                                          transpose_rhs):
    x = _grouped_inputs(device, tokens, experts, k, capacity, dim, hidden,
                        tokens + k)
    rhs = x['w1'].transpose(1, 2).contiguous() if transpose_rhs else x['w1']
    before = gm.gather_rows_matmul.launches
    got = gm.gather_rows_matmul(x['src'], rhs, x['clamped'], x['scale'],
                                rows_per_group=capacity,
                                transpose_rhs=transpose_rhs)
    want = gm.gather_rows_matmul_plain(x['src'], rhs, x['clamped'],
                                       x['scale'], rows_per_group=capacity,
                                       transpose_rhs=transpose_rhs)
    torch.cuda.synchronize()
    assert gm.gather_rows_matmul.launches - before == 1
    assert got.shape == (experts * capacity, hidden)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize('tokens,experts,k,capacity,dim,hidden',
                         GROUPED_CASES)
@pytest.mark.parametrize('transpose_rhs,bias,save_rows',
                         [(False, True, True), (True, False, False)])
def test_matmul_scatter_rows_matches_plain(device, tokens, experts, k,
                                           capacity, dim, hidden,
                                           transpose_rhs, bias, save_rows):
    x = _grouped_inputs(device, tokens, experts, k, capacity, dim, hidden,
                        tokens + 2 * k)
    rhs = x['w2'].transpose(1, 2).contiguous() if transpose_rhs else x['w2']
    b2 = x['b2'] if bias else None
    args = (x['lhs'], rhs, b2, x['slot_token'], x['scale'], tokens)
    options = dict(rows_per_group=capacity, transpose_rhs=transpose_rhs,
                   save_rows=save_rows)
    before = gm.matmul_scatter_rows.launches
    out, rows = gm.matmul_scatter_rows(*args, **options)
    want_out, want_rows = gm.matmul_scatter_rows_plain(
        *args, **dict(options, save_rows=True))
    torch.cuda.synchronize()
    assert gm.matmul_scatter_rows.launches - before == 1
    assert out.shape == (tokens, dim) and out.dtype == torch.bfloat16
    assert (rows is None) == (not save_rows)
    if save_rows:
        _close(rows, want_rows, 2 ** -7 * want_rows.float().abs().max().item())
    _close(out, want_out, 2 ** -5 * want_out.float().abs().max().item())
    # tokens no slot seats come out exactly zero
    seated = torch.zeros(tokens + 1, dtype=torch.bool, device=device)
    seated[x['slot_token'].long()] = True
    assert (out[~seated[:tokens]] == 0).all()


@pytest.mark.parametrize('tokens,experts,k,capacity,dim,hidden',
                         GROUPED_CASES)
@pytest.mark.parametrize('transpose_rhs', [False, True])
def test_matmul_scatter_rows_passes_match_plain(device, tokens, experts, k,
                                                capacity, dim, hidden,
                                                transpose_rhs):
    """K7's two passes alone: the grouped product's rows against the plain
    product, and the combine bit for bit against ``combine_rows_plain``
    over the same rows on a CPU copy (both walk a token's rows in ascending
    order and round every product and add to bfloat16)."""
    x = _grouped_inputs(device, tokens, experts, k, capacity, dim, hidden,
                        tokens + 3 * k)
    rhs = x['w2'].transpose(1, 2).contiguous() if transpose_rhs else x['w2']
    b2 = None if transpose_rhs else x['b2']
    rows = gm._matmul_rows(x['lhs'], rhs, b2, rows_per_group=capacity,
                           transpose_rhs=transpose_rhs)
    _, want_rows = gm.matmul_scatter_rows_plain(
        x['lhs'], rhs, b2, x['slot_token'], x['scale'], tokens,
        rows_per_group=capacity, transpose_rhs=transpose_rhs)
    out = gm._combine_rows(rows, x['scale'],
                           gm.combine_index(x['slot_token'], tokens), tokens)
    torch.cuda.synchronize()
    _close(rows, want_rows, 2 ** -7 * want_rows.float().abs().max().item())
    want = gm.combine_rows_plain(rows.cpu(), x['slot_token'].cpu(),
                                 x['scale'].cpu(), tokens)
    assert torch.equal(out.cpu(), want)


def test_k7_product_timed_alone(device, record_property):
    """At one MoE layer's widths the grouped product alone takes less time
    than the whole K7 call (the product, the token index and the combine):
    CUDA events over 10 calls after 3, both recorded."""
    x = _grouped_inputs(device, 2048, 8, 2, 640, 768, 3072, 11)
    args = (x['lhs'], x['w2'], x['b2'])

    def timed(fn):
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    product = timed(lambda: gm._matmul_rows(*args, rows_per_group=640))
    whole = timed(lambda: gm.matmul_scatter_rows(
        *args, x['slot_token'], x['scale'], 2048, rows_per_group=640))
    record_property('product_ms', product)
    record_property('k7_ms', whole)
    assert 0 < product < whole


def test_grouped_kernels_repeat_bitwise(device):
    x = _grouped_inputs(device, 2048, 8, 2, 640, 768, 3072, 7)
    for _ in range(2):
        up = gm.gather_rows_matmul(x['src'], x['w1'], x['clamped'],
                                   x['scale'], rows_per_group=640)
        out, rows = gm.matmul_scatter_rows(x['lhs'], x['w2'], x['b2'],
                                           x['slot_token'], x['scale'], 2048,
                                           rows_per_group=640)
        if _ == 0:
            first = (up, out, rows)
    for a, b in zip(first, (up, out, rows)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('tokens,experts,k,factor', [
    (4096, 8, 2, 1.25), (4096, 8, 2, 0.5), (999, 6, 3, 1.0)])
def test_routing_on_the_card_matches_the_cpu_bitwise(device, tokens, experts,
                                                     k, factor):
    """Top-k by rounds of argmax breaks ties toward the lower index and the
    stable sort seats in input order on the card too: gates full of exact
    ties route to the same slots as on the CPU (whose routing the CPU tests
    hold bitwise to the reference's)."""
    from tpusystem_torch.ops import moe

    rng = np.random.default_rng(tokens + k)
    gates = torch.tensor(rng.integers(0, 3, (tokens, experts)) / 8.0,
                         dtype=torch.float32)
    capacity = moe.expert_capacity(tokens, experts, k, factor)
    on_cpu = moe.route_top_k_sparse(gates, k, capacity)
    for got, want in zip(moe.route_top_k_sparse(gates.to(device), k,
                                                capacity), on_cpu):
        assert torch.equal(got.cpu(), want)
    slots = on_cpu[1]
    for got, want in zip(
            moe._invert_seating(slots.to(device), k, tokens,
                                experts * capacity),
            moe._invert_seating(slots, k, tokens, experts * capacity)):
        assert torch.equal(got.cpu(), want)


def test_autograd_through_the_fused_moe_on_the_card(device):
    """The fused MoE Function (K6 and K7, each once forward and once
    backward) against the gather impl on the same weights: output, aux and
    every gradient within the reference's bf16 cross-impl tolerance (rtol
    0.05, atol 2e-2: the kernels sum the products in float32 in another
    order than cuBLAS)."""
    from tpusystem_torch.ops.moe import MoEMLP

    generator = torch.Generator(device).manual_seed(3)
    hidden = torch.randn((4, 256, 64), generator=generator, device=device)
    results = {}
    for impl in ('gather', 'fused'):
        layer = MoEMLP(64, 8, capacity_factor=1.25, sparse_impl=impl,
                       device=device)
        x = hidden.to(torch.bfloat16).requires_grad_()
        before = (gm.gather_rows_matmul.launches,
                  gm.matmul_scatter_rows.launches)
        out, aux = layer(x)
        loss = out.float().square().mean() + aux
        grads = torch.autograd.grad(loss, list(layer.parameters()) + [x])
        torch.cuda.synchronize()
        launched = (gm.gather_rows_matmul.launches - before[0],
                    gm.matmul_scatter_rows.launches - before[1])
        assert launched == ((2, 2) if impl == 'fused' else (0, 0))
        results[impl] = (out, aux, grads)
    (out_g, aux_g, grads_g), (out_f, aux_f, grads_f) = (results['gather'],
                                                        results['fused'])
    torch.testing.assert_close(out_f.float(), out_g.float(), rtol=0.05,
                               atol=2e-2)
    torch.testing.assert_close(aux_f, aux_g, rtol=1e-6, atol=0)
    for got, want in zip(grads_f, grads_g):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=0.05,
                                   atol=2e-2)


def test_gpt2_tiny_moe_trains_on_the_card(device):
    """Three AdamW steps of the MoE gpt2_tiny (bf16, flash, fused experts,
    WithAuxLoss over the chunked loss): finite falling losses, K6 and K7
    each launched twice per MoE layer per step."""
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       WithAuxLoss, build_train_step,
                                       init_state, module_apply)

    module = gpt2_tiny(attention='flash', return_features=True,
                       moe_experts=4, moe_every=2, moe_sparse_impl='fused',
                       device=device)
    optimizer = AdamW(lr=3e-3, grad_clip=1.0)
    state = init_state(module, optimizer)
    step = build_train_step(module_apply(module),
                            WithAuxLoss(ChunkedNextTokenLoss(chunks=4)),
                            optimizer)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                               (4, 128)),
                             device=device)
    before = gm.gather_rows_matmul.launches, gm.matmul_scatter_rows.launches
    losses = []
    for _ in range(3):
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    moe_layers = sum(module.is_moe(i) for i in range(module.layers))
    assert (gm.gather_rows_matmul.launches - before[0],
            gm.matmul_scatter_rows.launches - before[1]) == (
                3 * 2 * moe_layers, 3 * 2 * moe_layers)


# --- the recommender: K8 gather_rows, K9 scatter_add_rows ---------------

def _lookup_case(device, rows, dim, count, distinct, dtype, seed):
    """A table, ids drawn from the first ``distinct`` rows (duplicates),
    every 7th a sentinel (``rows``), weights in [0.5, 1.5), cotangents."""
    generator = torch.Generator(device).manual_seed(seed)
    table = torch.randn((rows, dim), generator=generator,
                        device=device).to(dtype)
    ids = torch.randint(0, distinct, (count,), generator=generator,
                        device=device, dtype=torch.int32)
    ids[::7] = rows
    scale = ((ids < rows).float()
             * (torch.rand(count, generator=generator, device=device) + 0.5))
    grads = torch.randn((count, dim), generator=generator,
                        device=device).to(dtype)
    return table, ids, scale, grads


LOOKUP_SHAPES = [          # rows, dim, count, distinct, dtype
    (1000, 128, 4096, 1000, torch.float32),
    (50, 128, 3000, 3, torch.float32),       # segments past 1,000 rows
    (100000, 64, 65536, 100000, torch.float32),
    (300, 130, 777, 300, torch.float32),     # off the 16-byte loads
    (4096, 128, 2048, 40, torch.bfloat16),
    (64, 24, 513, 64, torch.bfloat16),       # bf16 off the 16-byte loads
    (10, 7, 100, 2, torch.float32)]


@pytest.mark.parametrize('rows,dim,count,distinct,dtype', LOOKUP_SHAPES)
def test_gather_rows_matches_plain_bitwise(device, rows, dim, count,
                                           distinct, dtype):
    """One multiply in float32 and one rounding (to nearest even for bf16)
    in both: bitwise, on the card and against the CPU."""
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    table, ids, scale, _ = _lookup_case(device, rows, dim, count, distinct,
                                        dtype, rows + dim)
    clamped = ids.clamp(max=rows - 1)
    before = el.gather_rows.launches
    got = el.gather_rows(table, clamped, scale)
    torch.cuda.synchronize()
    assert el.gather_rows.launches - before == 1
    assert got.dtype == dtype and got.shape == (count, dim)
    assert torch.equal(got, el.gather_rows_plain(table, clamped, scale))
    assert torch.equal(got.cpu(), el.gather_rows_plain(
        table.cpu(), clamped.cpu(), scale.cpu()))
    if dtype == torch.bfloat16:
        wide = el.gather_rows(table, clamped, scale, out_dtype=torch.float32)
        assert torch.equal(wide, el.gather_rows_plain(
            table, clamped, scale, out_dtype=torch.float32))


@pytest.mark.parametrize('rows,dim,count,distinct,dtype', LOOKUP_SHAPES)
def test_scatter_add_rows_matches_plain_bitwise(device, rows, dim, count,
                                                distinct, dtype):
    """Each id's rows summed from 0.0 in ascending position, one rounding
    per product and per add, sentinels skipped: bitwise the plain version
    on the CPU (``index_add_`` adds in index order there)."""
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    _, ids, scale, grads = _lookup_case(device, rows, dim, count, distinct,
                                        dtype, rows * dim)
    before = el.scatter_add_rows.launches
    got = el.scatter_add_rows(grads, ids, scale, rows)
    torch.cuda.synchronize()
    assert el.scatter_add_rows.launches - before == 1
    assert got.dtype == torch.float32 and got.shape == (rows, dim)
    want = el.scatter_add_rows_plain(grads.cpu(), ids.cpu(), scale.cpu(),
                                     rows)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize('case', [
    'one-id', 'vocab3-head', 'distinct', 'sentinels', 'threshold',
    'threshold-shifted', 'bf16', 'dim8', 'dim130', 'dim512'])
def test_fold_sweep_matches_plain_bitwise_and_repeats(device, case):
    """K9's two paths (segments of ``LONG_SEGMENT`` positions or more by a
    block per 32 columns through a ring of bulk copies, shorter ones many
    to a warp) on ``chip_smoke.py``'s fold sweep: bitwise the plain version
    on the CPU, and on a repeat."""
    import chip_smoke
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    rows, ids, scale, table_rows = chip_smoke.fold_case(
        case, el.LONG_SEGMENT, len(case))
    want = el.scatter_add_rows_plain(rows, ids, scale, table_rows)
    on_card = [t.to(device) for t in (rows, ids, scale)]
    got = el.scatter_add_rows(*on_card, table_rows)
    again = el.scatter_add_rows(*on_card, table_rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


def test_lookup_kernels_repeat_bitwise(device):
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    table, ids, scale, grads = _lookup_case(device, 50, 128, 3000, 3,
                                            torch.float32, 1)
    clamped = ids.clamp(max=49)
    assert torch.equal(el.gather_rows(table, clamped, scale),
                       el.gather_rows(table, clamped, scale))
    assert torch.equal(el.scatter_add_rows(grads, ids, scale, 50),
                       el.scatter_add_rows(grads, ids, scale, 50))


def test_lookup_kernels_refuse_what_they_do_not_take(device):
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    table, ids, scale, grads = _lookup_case(device, 10, 8, 16, 10,
                                            torch.float32, 2)
    with pytest.raises(ValueError, match='takes'):
        el.gather_rows(table.half(), ids.clamp(max=9), scale)
    with pytest.raises(ValueError, match='float32 or'):
        el.scatter_add_rows(grads.half(), ids, scale, 10)
    with pytest.raises(ValueError, match=r'row_scale \(16,\), expected'):
        el.gather_rows(table, ids[:5], scale)


def test_embedding_lookup_gradient_on_the_card_matches_the_cpu(device):
    """The fused lookup with weights that need a gradient: K8 forward, K9
    for the table, the K8 re-gather for the weights; all within 1e-6 of
    the CPU (the weights' dot products sum in another order)."""
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    table, ids, scale, grads = _lookup_case(device, 200, 32, 500, 20,
                                            torch.float32, 3)
    ids = torch.where(ids == 200, torch.full_like(ids, -1), ids)
    results = {}
    for where in ('cuda', 'cpu'):
        leaf = table.to(where).clone().requires_grad_()
        weights = scale.to(where).clone().requires_grad_()
        before = (el.gather_rows.launches, el.scatter_add_rows.launches)
        out = el.embedding_lookup(leaf, ids.to(where), weights)
        d_table, d_weights = torch.autograd.grad(
            (out * grads.to(where)).sum(), (leaf, weights))
        launched = (el.gather_rows.launches - before[0],
                    el.scatter_add_rows.launches - before[1])
        assert launched == ((2, 1) if where == 'cuda' else (0, 0))
        results[where] = [t.detach().cpu() for t in (out, d_table,
                                                     d_weights)]
    assert torch.equal(results['cuda'][0], results['cpu'][0])
    assert torch.equal(results['cuda'][1], results['cpu'][1])
    torch.testing.assert_close(results['cuda'][2], results['cpu'][2],
                               rtol=1e-6, atol=1e-6)


def _carried_step(device, factory, criterion, batch, targets, state_dict):
    """One SGD step of ``factory(device=device)`` from ``state_dict``."""
    from tpusystem_torch.train import SGD, build_train_step, init_state, \
        module_apply
    module = factory(device=device)
    module.load_state_dict(state_dict)
    optimizer = SGD(lr=0.5)
    state = init_state(module, optimizer)
    step = build_train_step(module_apply(module), criterion, optimizer)
    losses = []
    for _ in range(2):
        state, (_, loss) = step(state, {key: value.to(device) for key, value
                                        in batch.items()}, targets.to(device))
        losses.append(loss.item())
    return losses, {name: p.detach().cpu()
                    for name, p in state.params.items()}


@pytest.mark.parametrize('model', ['dlrm_tiny', 'two_tower_tiny'])
def test_recommender_steps_on_the_card_match_the_cpu(device, model):
    """Two SGD steps from the same weights on the card (K8, K9) and on the
    CPU (the plain versions): losses and parameters within 1e-5."""
    from tpusystem_torch import models
    from tpusystem_torch.data import SyntheticClicks
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    from tpusystem_torch.train import BCEWithLogitsLoss, CrossEntropyLoss
    factory = getattr(models, model)
    if model == 'dlrm_tiny':
        features, labels = SyntheticClicks(samples=64, seed=2)[slice(0, 64)]
        batch = {key: torch.as_tensor(value) for key, value in
                 features.items()}
        targets, criterion = torch.as_tensor(labels), BCEWithLogitsLoss()
        tables = 2
    else:
        rng = np.random.default_rng(4)
        users = torch.as_tensor(rng.integers(0, 64, (32, 3)), dtype=torch.int32)
        users[::4, 2] = -1
        batch = {'user': users, 'item': (users[:, 0] % 32)}
        targets, criterion = torch.arange(32), CrossEntropyLoss()
        tables = 2
    weights = factory(device='cpu').state_dict()
    before = (el.gather_rows.launches, el.scatter_add_rows.launches)
    card = _carried_step(device, factory, criterion, batch, targets, weights)
    assert (el.gather_rows.launches - before[0],
            el.scatter_add_rows.launches - before[1]) == (
                2 * tables, 2 * 2 * tables)
    cpu = _carried_step('cpu', factory, criterion, batch, targets, weights)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-5)
    for name, value in card[1].items():
        torch.testing.assert_close(value, cpu[1][name], rtol=1e-5, atol=1e-5)
