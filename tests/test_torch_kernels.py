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


def test_decode_ffn_matches_jax():
    rng = np.random.default_rng(2)
    x = _normal(rng, (3, 64))
    w1, b1 = _normal(rng, (64, 256), 64 ** -0.5), _normal(rng, (256,), 0.1)
    w2, b2 = _normal(rng, (256, 64), 256 ** -0.5), _normal(rng, (64,), 0.1)
    want = jdm.decode_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    got = tdm.decode_ffn(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
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


def test_decode_kernels_reject_what_the_card_cannot_take():
    """A tensor on neither the CPU nor CUDA is refused, never computed."""
    x = torch.zeros(2, 8, device='meta')
    with pytest.raises(ValueError, match='not supported'):
        tdm.decode_matmul(x, x.new_zeros(8, 8))
