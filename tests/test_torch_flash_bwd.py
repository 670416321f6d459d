"""The port's flash backward against the JAX package's Pallas backward.

The same seeded numpy inputs go through ``jax.vjp`` of the reference's
``flash_attention_lse`` (interpret mode on the CPU, as the JAX package's own
tests run it, with ``backward='fused'`` and ``'split'``) and through the
port's plain backward, which the wrappers take for CPU tensors. Both run in
float32 with a non-zero lse cotangent, where the two differ only by
summation order: ``rtol = atol = 1e-5``. A second check holds the plain
backward against autograd of ``dot_product_attention`` in float64, where
only rounding separates them: ``rtol = atol = 1e-10``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.ops.pallas import flash as jflash
from tpusystem_torch.ops.attention import dot_product_attention
from tpusystem_torch.ops.cuda import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)
F64_TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small attention shapes gain nothing from torch's thread pool, whose
    spinning threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, batch, seq, heads, kv_heads, head_dim, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (batch, seq, heads, head_dim)
    kv_shape = (batch, seq, kv_heads, head_dim)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(kv_shape).astype(dtype),
            rng.standard_normal(kv_shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype),            # d_out
            rng.standard_normal((batch, seq, heads)).astype(dtype))  # d_lse


def _jax_vjp(q, k, v, d_out, d_lse, *, causal, backward, block):
    def attention(q, k, v):
        return jflash.flash_attention_lse(q, k, v, causal=causal,
                                          block_q=block, block_kv=block,
                                          interpret=True, backward=backward)
    (out, lse), vjp = jax.vjp(attention, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(d_out), jnp.asarray(d_lse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


# (seq, block): one reference block, and two kv steps (the partial-dq sum
# under GQA, the resident-dq kernel under MHA)
@pytest.mark.parametrize('seq,block', [(64, 32), (256, 128)])
@pytest.mark.parametrize('head_dim,kv_heads', [
    pytest.param(16, 4, id='4'),                          # MHA
    pytest.param(16, 2, id='2'),                          # GQA group 2
    pytest.param(128, 4, id='d128-4'),                    # Llama's head dim
    pytest.param(128, 1, id='d128-1'),                    # GQA group 4
])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('backward', ['fused', 'split'])
def test_plain_backward_matches_jax_vjp(seq, block, head_dim, kv_heads,
                                        causal, backward):
    q, k, v, d_out, d_lse = _inputs(seq + kv_heads, 1, seq, 4, kv_heads,
                                    head_dim)
    out, lse, want = _jax_vjp(q, k, v, d_out, d_lse, causal=causal,
                              backward=backward, block=block)
    got = tflash.flash_attention_bwd_plain(
        *(torch.tensor(a) for a in (q, k, v, out, lse, d_out, d_lse)),
        causal=causal, backward=backward)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize('kv_heads,causal,head_dim', [
    pytest.param(4, True, 16, id='4-True'),
    pytest.param(2, True, 16, id='2-True'),
    pytest.param(2, False, 16, id='2-False'),
    pytest.param(4, True, 128, id='d128-4-True'),
    pytest.param(1, True, 128, id='d128-1-True'),
    pytest.param(1, False, 128, id='d128-1-False'),
])
def test_autograd_through_flash_attention_lse_matches_jax(kv_heads, causal,
                                                          head_dim):
    """The autograd Function on CPU tensors: plain forward, plain backward,
    no kernel launches; both outputs carry a cotangent."""
    q, k, v, d_out, d_lse = _inputs(7, 2, 96, 4, kv_heads, head_dim)
    _, _, want = _jax_vjp(q, k, v, d_out, d_lse, causal=causal,
                          backward='fused', block=96)
    tensors = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (tflash.flash_attention_lse.launches,
              tflash.flash_bwd_fused.launches)
    out, lse = tflash.flash_attention_lse(*tensors, causal=causal)
    got = torch.autograd.grad(
        (out, lse), tensors,
        (torch.from_numpy(d_out), torch.from_numpy(d_lse)))
    assert (tflash.flash_attention_lse.launches,
            tflash.flash_bwd_fused.launches) == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize('kv_heads,causal', [(4, True), (2, True),
                                             (2, False)])
def test_plain_backward_matches_float64_autograd(kv_heads, causal):
    q, k, v, d_out, d_lse = (
        torch.from_numpy(a) for a in _inputs(11, 2, 80, 4, kv_heads, 16,
                                             np.float64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = dot_product_attention(*leaves, causal=causal)
    group = 4 // kv_heads
    scores = torch.einsum('bqhd,bkhd->bhqk', leaves[0],
                          leaves[1].repeat_interleave(group, 2)) * 16 ** -0.5
    if causal:
        scores = scores.masked_fill(
            ~torch.ones(80, 80, dtype=torch.bool).tril(), tflash.NEG_INF)
    lse = torch.logsumexp(scores, -1).transpose(1, 2)        # [B, S, H]
    want = torch.autograd.grad((out, lse), leaves, (d_out, d_lse))
    got = tflash.flash_attention_bwd_plain(
        q, k, v, out.detach(), lse.detach(), d_out, d_lse, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F64_TOL)


def test_lse_cotangent_alone_and_output_cotangent_alone():
    """An unused output's cotangent arrives as None: each output alone
    differentiates like the pair with a zero cotangent for the other."""
    q, k, v, d_out, d_lse = (torch.from_numpy(a)
                             for a in _inputs(3, 1, 40, 2, 2, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = tflash.flash_attention_lse(*leaves)
    only_out = torch.autograd.grad(out, leaves, d_out, retain_graph=True)
    only_lse = torch.autograd.grad(lse, leaves, d_lse)
    want_out = tflash.flash_attention_bwd_plain(
        q, k, v, out.detach(), lse.detach(), d_out, torch.zeros_like(d_lse))
    want_lse = tflash.flash_attention_bwd_plain(
        q, k, v, out.detach(), lse.detach(), torch.zeros_like(d_out), d_lse)
    for got, want in ((only_out, want_out), (only_lse, want_lse)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fused_mha_past_1024_keys_is_k2a_and_raises():
    """Fused MHA past 1024 keys routes to K2a (the reference's resident-dq
    kernel), whose plain version on the CPU is the one plain backward; a
    bad ``backward`` still raises. GQA takes K2b at any length, ``'split'``
    K3a and K3b at any length."""
    q = torch.zeros(1, 1032, 2, 16)
    args = (q, q, q, q, torch.zeros(1, 1032, 2), q)
    assert tflash.backward_kernels(q, q) == (tflash.flash_bwd_fused_g1,)
    assert tflash.backward_kernels(q[:, :1024], q[:, :1024]) == (
        tflash.flash_bwd_fused,)
    launches = tflash.flash_bwd_fused_g1.launches
    fused = tflash.flash_attention_bwd(*args, backward='fused')
    assert tflash.flash_bwd_fused_g1.launches == launches        # CPU: plain
    for got, want in zip(fused, tflash.flash_attention_bwd_plain(*args)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match='backward'):
        tflash.flash_attention_lse(q, q, q, backward='both')
    with pytest.raises(ValueError, match='multi-head'):
        tflash.flash_bwd_fused_g1(q, q[:, :, :1], q[:, :, :1], q,
                                  args[4], args[4])
    kv = torch.zeros(1, 1032, 1, 16)
    assert tflash.backward_kernels(q, kv) == (tflash.flash_bwd_fused,)
    assert tflash.backward_kernels(q, q, 'split') == (tflash.flash_bwd_dq,
                                                      tflash.flash_bwd_dkv)
    assert tflash.flash_attention_bwd(q, kv, kv, q, args[4], q)[1].shape == (
        1, 1032, 1, 16)
    assert tflash.flash_attention_bwd(*args, backward='split')[0].shape == (
        q.shape)


def test_backward_refuses_tensors_the_card_cannot_take():
    x = torch.zeros(1, 8, 2, 16, device='meta')
    lse = torch.zeros(1, 8, 2, device='meta')
    with pytest.raises(ValueError, match='not supported'):
        tflash.flash_attention_bwd(x, x, x, x, lse, x)


class _RecordingLibrary:
    """A stand-in for the backward kernels' library (they run only on the
    card): the layout helpers as the library computes them, and every
    kernel entry point recording its arguments and returning success."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def flash_bwd_padded_rows(seq):
        return -(-seq // 64) * 64

    @staticmethod
    def flash_bwd_tickets(batch, seq, heads):
        return 1 + batch * heads * -(-seq // 64)

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize('wrapper,seq', [
    pytest.param(wrapper, seq, id=str(seq) if wrapper == 'flash_bwd_fused'
                 else f'{wrapper}-{seq}')
    for wrapper in ('flash_bwd_fused', 'flash_bwd_fused_g1', 'flash_bwd_dkv')
    for seq in (1, 64, 100, 129)])
def test_fused_kernel_reads_row_statistics_by_head(monkeypatch, wrapper, seq):
    """The fused kernel (K2a, K2b) and K3b, its body without dq, read lse
    (times log2 e, their exp2's argument) and delta laid out
    ``[B, H, S_pad]`` (S rounded up to a 64-row q tile), so a q tile's 64
    values are one bulk copy: each wrapper hands its kernel every
    ``[B, S, H]`` value at (b, h, s) and zeros past S (the library stubbed;
    the kernels run only on the card)."""
    library = _RecordingLibrary()
    monkeypatch.setattr(tflash, '_bwd_library', lambda: library)
    monkeypatch.setattr(tflash, '_pointer', lambda tensor: tensor)
    monkeypatch.setattr(tflash, '_stream', lambda device: None)
    kernel = getattr(tflash, wrapper)
    monkeypatch.setattr(kernel, 'launches', 0)
    rows = -(-seq // 64) * 64
    rng = np.random.default_rng(seq)
    lse, delta = (torch.from_numpy(rng.standard_normal((2, seq, 3)).astype(
        np.float32)) for _ in range(2))
    x = torch.zeros(2, seq, 3, 16, dtype=torch.bfloat16)
    kernel(x, x, x, x, lse, delta)
    assert kernel.launches == 1 and len(library.calls) == 1
    laid = library.calls[0][1][4:6]
    for got, stats in zip(laid, (lse * tflash.LOG2E, delta)):
        assert got.shape == (2, 3, rows) and got.is_contiguous()
        assert torch.equal(got[:, :, :seq], stats.transpose(1, 2))
        assert not got[:, :, seq:].any()
