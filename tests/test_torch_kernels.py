"""The port's kernel modules against the JAX package's Pallas kernels.

The same seeded numpy inputs go through the JAX kernel (interpret mode on
the CPU, as the JAX package's own tests run it) and through the port's
wrapper, which takes its plain PyTorch version for a CPU tensor. Both run in
float32, where the two differ only by summation order: tolerance
``rtol = atol = 1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.ops.pallas import decode_matmul as jdm
from tpusystem.ops.pallas import flash as jflash
from tpusystem_torch.ops.cuda import decode_matmul as tdm
from tpusystem_torch.ops.cuda import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize('with_bias', [False, True])
@pytest.mark.parametrize('activation', [None, 'gelu'])
def test_decode_matmul_matches_jax(with_bias, activation):
    rng = np.random.default_rng(1)
    x, w = _normal(rng, (4, 96)), _normal(rng, (96, 160), 96 ** -0.5)
    bias = _normal(rng, (160,), 0.1) if with_bias else None
    want = jdm.decode_matmul(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias),
        activation=None if activation is None else jax.nn.gelu)
    before = tdm.decode_matmul.launches
    got = tdm.decode_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias),
        activation=activation)
    assert tdm.decode_matmul.launches == before     # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# K5's edge shapes (inner, hidden, cols), the ones the on-card tests hold the
# kernel to against this plain version: GPT-2's FFN, GPT-2 tiny's, K uneven
# over 16 with H off a cluster's hidden slab and N under one 32-column tile
# (b1 large, so a leaked gelu(b1) would show), N off a multiple of 32, and
# GPT-2 XL's FFN
K5_EDGES = [(768, 3072, 768), (64, 256, 64), (200, 272, 48), (768, 3072, 784),
            (1600, 6400, 1600)]


@pytest.mark.parametrize('inner,hidden,cols', K5_EDGES)
def test_decode_ffn_matches_jax(inner, hidden, cols):
    rng = np.random.default_rng(2)
    x = _normal(rng, (3, inner))
    w1 = _normal(rng, (inner, hidden), inner ** -0.5)
    b1 = _normal(rng, (hidden,), 4.0 if hidden % 256 else 0.1)
    w2, b2 = _normal(rng, (hidden, cols), hidden ** -0.5), _normal(rng, (cols,), 0.1)
    want = jdm.decode_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    before = tdm.decode_ffn.launches
    got = tdm.decode_ffn(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    assert tdm.decode_ffn.launches == before        # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('kv_heads', [4, 2])          # MHA, GQA group 2
def test_flash_attention_lse_matches_jax(kv_heads):
    rng = np.random.default_rng(3)
    q = _normal(rng, (1, 512, 4, 16))
    k = _normal(rng, (1, 512, kv_heads, 16))
    v = _normal(rng, (1, 512, kv_heads, 16))
    want_out, want_lse = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got_out, got_lse = tflash.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    assert got_lse.shape == (1, 512, 4) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize('head_dim,heads,kv_heads,causal', [
    (16, 6, 2, False),         # GQA group 3, non-causal
    (32, 4, 4, True),
    (32, 6, 2, True),          # GQA group 3
    (64, 4, 4, True),
    (64, 6, 2, False),
    (128, 6, 2, False),
])
def test_flash_forward_modes_match_jax(head_dim, heads, kv_heads, causal):
    """The modes K1 keeps, head dims 16-128, a GQA group of 3 and
    non-causal, beside the causal cases above and at head dim 128
    (``test_torch_llama.py``): the plain forward K1 is held to on the card
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(head_dim + heads + causal)
    q = _normal(rng, (1, 256, heads, head_dim))
    k = _normal(rng, (1, 256, kv_heads, head_dim))
    v = _normal(rng, (1, 256, kv_heads, head_dim))
    want_out, want_lse = jflash.flash_attention_lse(   # two kv blocks
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_kv=128)
    before = tflash.flash_attention_lse.launches
    got_out, got_lse = tflash.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert tflash.flash_attention_lse.launches == before   # CPU: plain
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_decode_kernels_reject_what_the_card_cannot_take():
    """A tensor on neither the CPU nor CUDA is refused, never computed."""
    x = torch.zeros(2, 8, device='meta')
    with pytest.raises(ValueError, match='not supported'):
        tdm.decode_matmul(x, x.new_zeros(8, 8))


def test_k5_workspaces_are_kept_per_stream_and_bounded():
    """K5's partials and ticket counters: one set a stream, reused by its
    next call, grown when a call needs more, and let go least recently
    used first past ``WORKSPACE_STREAMS`` streams."""
    saved = dict(tdm._WORKSPACES)
    tdm._WORKSPACES.clear()
    try:
        cpu = torch.device('cpu')
        first = tdm._workspace(cpu, 1, 64, 8)
        assert tdm._workspace(cpu, 1, 32, 8)[1] is first[1]
        grown = tdm._workspace(cpu, 1, 128, 8)
        assert grown[0].numel() == 128 and grown[1] is first[1]
        assert not grown[1].any()
        for stream in range(2, tdm.WORKSPACE_STREAMS + 2):
            tdm._workspace(cpu, stream, 64, 8)
        assert len(tdm._WORKSPACES) == tdm.WORKSPACE_STREAMS
        assert (cpu, 1) not in tdm._WORKSPACES
        assert (cpu, tdm.WORKSPACE_STREAMS + 1) in tdm._WORKSPACES
    finally:
        tdm._WORKSPACES.clear()
        tdm._WORKSPACES.update(saved)
