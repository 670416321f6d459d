"""Attention-probability and activation dropout of the port against the JAX
package, on the CPU.

The flash kernels' keep mask is the reference's positional hash
(``_keep_mask``), so the port's plain hash must equal it bit for bit, and the
flash forward and backward at ``p = 0.1`` with one int seed must match the
reference's ``_flash_lse`` given that seed (interpret mode) at
``rtol = atol = 1e-5``: float32, the same masks, sums in another order. The
model's other masks (embeddings, attention and MLP outputs, and the
attention probabilities on ``'xla'``) are flax's own threefry bits, from the
keys flax's ``make_rng`` derives at the reference's module paths, and the
flash kernels' seed is the reference's ``randint`` of the attention's key:
three SGD steps at ``p = 0.1`` match the reference's ``build_train_step``
(losses at ``rtol = 1e-5``, parameters at ``atol = 1e-5``: the same masks,
float32 sums in another order). They are also held to their semantics, to
determinism under a fixed seed, to ``remat`` (bitwise the same step with
and without it) and to a kept share within three standard deviations of
``1 - p``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.ops.pallas import flash as jflash
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.ops import attention as tattention
from tpusystem_torch.ops import threefry
from tpusystem_torch.ops.cuda import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 1_234_567
KEY = threefry.PRNGKey(SEED)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small shapes gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _within_three_sigma(kept: torch.Tensor, rate: float) -> None:
    count = kept.numel()
    sigma = math.sqrt(rate * (1 - rate) / count)
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) <= 3 * sigma, (share, 1 - rate, sigma)


# --- the hash -------------------------------------------------------------

# (q_idx, kv_idx, block): the first tiles, tiles deep in a 16k sequence, and
# tiles whose global positions wrap past 2**32 (q_idx * block overflows the
# reference's int32 and is taken modulo 2**32, as the port's positions are)
TILES = [(0, 0, 16), (3, 7, 32), (255, 130, 64),
         (2 ** 28 - 1, 2 ** 28 - 1, 16), (2 ** 27 - 1, 5, 32)]


@pytest.mark.parametrize('q_idx,kv_idx,block', TILES)
@pytest.mark.parametrize('rate', [0.1, 0.5, 0.9])
def test_keep_mask_equals_the_reference_bitwise(q_idx, kv_idx, block, rate):
    rng = np.random.default_rng(q_idx % 1000 + int(rate * 10))
    seeds = [0, 1, 2 ** 31 - 2] + rng.integers(0, 2 ** 31 - 1, 5).tolist()
    head_rows = [0, 1, 11, 191, 65534]
    row0 = q_idx * block % 2 ** 32
    col0 = kv_idx * block % 2 ** 32
    rows = (torch.arange(block) + row0) % 2 ** 32
    cols = (torch.arange(block) + col0) % 2 ** 32
    for seed in seeds:
        for head_row in head_rows:
            want = np.asarray(jflash._keep_mask(
                jnp.int32(seed), jnp.int32(head_row), jnp.int32(q_idx),
                jnp.int32(kv_idx), block, block, rate))
            got = tflash.keep_mask(seed, head_row, rows[:, None], cols[None],
                                   rate)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f'{seed} {head_row}')


def test_keep_mask_share_and_tiling_independence():
    """Over a 2048 x 2048 grid of one head row the kept share is within 3
    sigma of ``1 - p``; a mask hashed tile by tile equals the whole."""
    rows = torch.arange(2048)
    whole = tflash.keep_mask(SEED, 3, rows[:, None], rows[None], 0.1)
    _within_three_sigma(whole, 0.1)
    for start in range(0, 2048, 64):
        cols = rows[start:start + 64]
        assert torch.equal(tflash.keep_mask(SEED, 3, rows[:, None],
                                            cols[None], 0.1),
                           whole[:, start:start + 64])
    assert tflash.keep_threshold(0.1) == int(round(0.9 * (1 << 24)))


# --- the flash kernels' plain versions at p = 0.1 ------------------------

def _reference(q, k, v, d_out, d_lse, *, causal, backward, block, rate):
    """``(out, lse, grads)`` of the reference's ``_flash_lse`` given the int
    seed ``SEED`` (the seed ``flash_attention_lse`` would draw)."""
    batch, seq, heads, head_dim = q.shape
    group = heads // k.shape[2]

    def to_bh(t):
        return t.transpose(0, 2, 1, 3).reshape(-1, seq, head_dim)

    def attention(q, k, v):
        out, lse = jflash._flash_lse(
            to_bh(q), to_bh(k), to_bh(v), jnp.array([SEED], jnp.int32),
            causal, head_dim ** -0.5, block, block, True, group, rate,
            backward)
        return (out.reshape(batch, heads, seq, head_dim).transpose(0, 2, 1, 3),
                lse.reshape(batch, heads, seq).transpose(0, 2, 1))

    (out, lse), vjp = jax.vjp(attention, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(d_out), jnp.asarray(d_lse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


# (seq, block, kv_heads, causal, backward): the reference's K2a (MHA, two kv
# tiles), K2b (one kv tile; GQA at two), and the split pair K3a + K3b; the
# last case takes K2a in the port too (MHA past 1024 keys)
FLASH_CASES = [
    (256, 128, 4, True, 'fused'),
    (256, 128, 4, False, 'fused'),
    (128, 128, 4, True, 'fused'),
    (256, 128, 2, True, 'fused'),
    (256, 128, 2, False, 'fused'),
    (256, 128, 4, True, 'split'),
    (256, 128, 2, False, 'split'),
    (2048, 1024, 2, True, 'fused'),
]


@pytest.mark.parametrize('seq,block,kv_heads,causal,backward', FLASH_CASES)
def test_flash_dropout_matches_the_reference(seq, block, kv_heads, causal,
                                             backward):
    heads = kv_heads if seq > 1024 else 4
    rng = np.random.default_rng(seq + kv_heads + causal)
    shape, kv_shape = (1, seq, heads, 16), (1, seq, kv_heads, 16)
    q, d_out = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
    k, v = (rng.standard_normal(kv_shape).astype(np.float32)
            for _ in range(2))
    d_lse = rng.standard_normal(shape[:3]).astype(np.float32)
    out, lse, want = _reference(q, k, v, d_out, d_lse, causal=causal,
                                backward=backward, block=block, rate=0.1)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got_out, got_lse = tflash.flash_attention_lse(
        *leaves, causal=causal, backward=backward, dropout=0.1, seed=SEED)
    np.testing.assert_allclose(got_out.detach().numpy(), out, **TOL)
    np.testing.assert_allclose(got_lse.detach().numpy(), lse, **TOL)
    got = torch.autograd.grad((got_out, got_lse), leaves,
                              (torch.from_numpy(d_out),
                               torch.from_numpy(d_lse)))
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def test_flash_dropout_needs_a_seed_and_zero_is_unchanged():
    q = torch.randn(1, 70, 2, 16, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match='seed'):
        tflash.flash_attention_lse(q, q, q, dropout=0.1)
    with pytest.raises(ValueError, match='dropout'):
        tflash.flash_attention_lse(q, q, q, dropout=1.0, seed=1)
    plain = tflash.flash_attention_plain(q, q, q)
    for got, want in zip(tflash.flash_attention_plain(q, q, q, dropout=0.0,
                                                      seed=5), plain):
        assert torch.equal(got, want)
    # the lse is the full denominator: dropout leaves it alone
    _, lse = tflash.flash_attention_plain(q, q, q, dropout=0.3, seed=5)
    assert torch.equal(lse, plain[1])


# --- the model ------------------------------------------------------------

def test_dropout_helper_semantics_and_share():
    x = torch.full((64, 1024), 2.0)
    out = tattention.apply_dropout(x, 0.1, KEY)
    kept = out != 0
    _within_three_sigma(kept, 0.1)
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / 0.9))
    assert torch.equal(tattention.apply_dropout(x, 0.1, KEY), out)
    assert not torch.equal(tattention.apply_dropout(
        x, 0.1, threefry.PRNGKey(SEED + 1)), out)
    assert tattention.apply_dropout(x, 0.0, None) is x
    assert not tattention.apply_dropout(x, 1.0, KEY).any()


def test_xla_attention_dropout_drops_normalised_weights():
    """Survivors keep their softmax weight over all keys, scaled by
    ``1 / (1 - p)``; nothing is renormalised (``attention.py:373-375``)."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.standard_normal((1, 12, 2, 8)).astype(
        np.float32)) for _ in range(2))
    # value row j is the unit vector e_j: the output rows are the weights
    eye = torch.eye(12).reshape(1, 12, 1, 12).expand(1, 12, 2, 12)
    eye = eye.contiguous()
    weights = tattention.dot_product_attention(q, k, eye)   # [B, q, H, k]
    got = tattention.dot_product_attention(q, k, eye, dropout=0.25, rng=KEY)
    keep = tattention.dropout_mask((1, 2, 12, 12), 0.25, KEY,
                                   torch.device('cpu'))      # [B, H, q, k]
    want = torch.where(keep.transpose(1, 2), weights / 0.75,
                       torch.zeros_like(weights))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def _train(attention, *, remat=False, seed=0, steps=2, rate=0.1,
           accumulate=1):
    """Losses and the final parameters of ``steps`` AdamW steps of a
    ``gpt2_tiny(dropout=rate)`` whose carried generator is seeded ``seed``."""
    module = gpt2_tiny(dtype='float32', device='cpu', attention=attention,
                       dropout=rate, remat=remat, return_features=True)
    optimizer = ttrain.AdamW(lr=1e-2, grad_clip=1.0)
    state = ttrain.init_state(module, optimizer, rng=seed)
    step = ttrain.build_train_step(
        ttrain.module_apply(module), ttrain.ChunkedNextTokenLoss(chunks=2),
        optimizer, accumulate=accumulate)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 256,
                                                               (2, 24)))
    losses = [step(state, tokens, tokens)[1][1].item() for _ in range(steps)]
    return losses, {name: p.detach().clone()
                    for name, p in state.params.items()}


@pytest.mark.parametrize('attention', ['xla', 'flash'])
def test_gpt2_dropout_training_is_deterministic_per_seed(attention):
    first, params = _train(attention)
    again, params_again = _train(attention)
    other, _ = _train(attention, seed=1)
    undropped, _ = _train(attention, rate=0.0)
    assert first == again and first != other and first != undropped
    assert all(torch.equal(params[n], params_again[n]) for n in params)
    assert all(math.isfinite(loss) for loss in first + other)


@pytest.mark.parametrize('attention', ['xla', 'flash'])
def test_gpt2_dropout_remat_equals_no_remat_bitwise(attention):
    """The masks are functions of seeds drawn before each block, so the
    recomputed blocks draw the masks the forward drew."""
    losses, params = _train(attention, remat=True)
    plain_losses, plain_params = _train(attention, remat=False)
    assert losses == plain_losses
    for name in params:
        assert torch.equal(params[name], plain_params[name]), name


def test_gpt2_dropout_microbatches_draw_their_own_masks():
    """``accumulate=2`` splits the step's key, one per microbatch, as the
    reference splits its key: the result is deterministic and differs from
    the full batch's (other masks)."""
    micro, _ = _train('flash', accumulate=2, steps=1)
    again, _ = _train('flash', accumulate=2, steps=1)
    full, _ = _train('flash', steps=1)
    assert micro == again and micro != full
    keys = threefry.split(threefry.PRNGKey(0), 2)
    draws = [threefry.random_bits(key, (4,)).tolist() for key in keys]
    assert keys[0] != keys[1] and draws[0] != draws[1]


def test_gpt2_attn_dropout_follows_dropout_unless_set():
    module = gpt2_tiny(device='cpu', dropout=0.1)
    assert module.dropout_rates(True) == (0.1, 0.1)
    assert module.dropout_rates(False) == (0.0, 0.0)
    assert module.replace(attn_dropout=0.0).dropout_rates(True) == (0.1, 0.0)
    assert gpt2_tiny(device='cpu', dropout=0.0,
                     attn_dropout=0.2).dropout_rates(True) == (0.0, 0.2)


# --- the reference's masks: three steps against build_train_step ----------

# the model's configurations with dropout: both attention kernels, remat on
# each (the recomputed blocks derive the same keys), an MoE model (its
# expert FFN output is the block's Dropout_1), and microbatches
PARITY_CASES = {
    'xla': (dict(attention='xla'), 1),
    'flash': (dict(attention='flash'), 1),
    'xla-remat': (dict(attention='xla', remat=True), 1),
    'flash-remat': (dict(attention='flash', remat=True), 1),
    'moe': (dict(attention='flash', moe_experts=2, moe_sparse_impl='fused'),
            1),
    'flash-accumulate': (dict(attention='flash'), 2),
}


@pytest.mark.parametrize('case', list(PARITY_CASES))
def test_gpt2_dropout_steps_match_the_reference(case):
    """Three SGD steps of ``gpt2_tiny(dropout=0.1)`` (every site, and the
    attention probabilities) from ``init_state(rng=0)`` in both packages:
    the losses agree at ``rtol = 1e-5`` and the parameters at ``atol =
    1e-5``, which only the same masks give. SGD, because Adam's
    normalisation turns float32 noise in near-zero gradients into
    lr-sized steps of either sign."""
    config, accumulate = PARITY_CASES[case]
    config = dict(config, dtype='float32', dropout=0.1, return_features=True)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 32))
    jax_loss, loss = (module.ChunkedNextTokenLoss(chunks=4)
                      for module in (jtrain, ttrain))
    if 'moe_experts' in config:
        jax_loss, loss = jtrain.WithAuxLoss(jax_loss), ttrain.WithAuxLoss(loss)

    reference = jax_gpt2_tiny(**config)
    batch = jnp.asarray(tokens, jnp.int32)
    state = jtrain.init_state(reference, jtrain.SGD(lr=0.1), batch, rng=0)
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    step = jtrain.build_train_step(jtrain.flax_apply(reference), jax_loss,
                                   jtrain.SGD(lr=0.1), accumulate=accumulate)
    want = []
    for _ in range(3):
        state, (_, value) = step(state, batch, batch)
        want.append(float(value))

    module = gpt2_tiny(device='cpu', **config)
    module.load_state_dict(params)
    optimizer = ttrain.SGD(lr=0.1)
    port = ttrain.init_state(module, optimizer, rng=0)
    port_step = ttrain.build_train_step(ttrain.module_apply(module), loss,
                                        optimizer, accumulate=accumulate)
    inputs = torch.as_tensor(tokens)
    got = [port_step(port, inputs, inputs)[1][1].item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert port.rng == threefry.as_key(np.asarray(state.rng))
    final = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_gpt2_dropout_keys_follow_flax_module_paths():
    """The embeddings' mask key is the root scope's ``Dropout_0``; block
    ``i`` takes ``h_i/attn``, ``h_i/Dropout_0`` and ``h_i/Dropout_1``."""
    from tpusystem_torch.models.gpt2 import dropout_keys
    embed, blocks = dropout_keys(KEY, 3)
    assert embed == threefry.make_rng(KEY, ('Dropout_0',))
    assert blocks[2] == tuple(threefry.make_rng(KEY, ('h_2', site))
                              for site in ('attn', 'Dropout_0', 'Dropout_1'))
    assert len({embed, *(key for block in blocks for key in block)}) == 10
