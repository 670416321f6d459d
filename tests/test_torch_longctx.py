"""The long-context training path of the port against the JAX package's,
on the CPU: the fused backward past 1024 keys (the reference's resident-dq
kernel K2a), ``GPT2(remat=True)`` and ``max_seq`` past 1024.

The same seeded numpy inputs and the same weights (``params_from_jax``) go
through both packages; the reference's Pallas kernels run in interpret
mode, the port's CUDA kernels through their plain versions. In float32 the
two differ by summation order and the last bit of a few transcendentals:
gradients and losses agree at ``rtol = atol = 1e-5`` (a model's gradients
within ``1e-5`` of the largest). ``remat`` changes only what is kept for the
backward, so on the CPU the port with and without it agrees bit for bit.
"""

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
from tpusystem_torch.ops.cuda import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small shapes gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize('causal', [True, False])
def test_fused_mha_past_1024_keys_matches_the_reference_k2a(causal):
    """MHA at 2048 keys with a non-zero lse cotangent: the port routes the
    fused backward to K2a (its plain version here), the reference at its
    default 1024 tiles to ``_flash_fused_bwd_g1_kernel``."""
    rng = np.random.default_rng(2048 + causal)
    shape = (1, 2048, 2, 16)
    q, k, v, d_out = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
    d_lse = rng.standard_normal(shape[:3]).astype(np.float32)

    def attention(q, k, v):
        return jflash.flash_attention_lse(q, k, v, causal=causal,
                                          interpret=True, backward='fused')
    (out, lse), vjp = jax.vjp(attention, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(d_out), jnp.asarray(d_lse)))
    query = torch.from_numpy(q)
    assert tflash.backward_kernels(query, query) == (
        tflash.flash_bwd_fused_g1,)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got_out, got_lse = tflash.flash_attention_lse(*leaves, causal=causal)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **TOL)
    np.testing.assert_allclose(got_lse.detach().numpy(), np.asarray(lse),
                               **TOL)
    got = torch.autograd.grad((got_out, got_lse), leaves,
                              (torch.from_numpy(d_out),
                               torch.from_numpy(d_lse)))
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def _reference_run(module, criterion, tokens, steps=3):
    """Init params, first-step grads and per-step losses of the
    reference's AdamW ``build_train_step`` on one batch."""
    optimizer = jtrain.AdamW(grad_clip=1.0)
    batch = jnp.asarray(tokens, jnp.int32)
    state = jtrain.init_state(module, optimizer, batch, rng=0)
    params = jax.tree.map(np.asarray, state.params)
    apply = jtrain.flax_apply(module)
    grads = jax.grad(lambda p: criterion(apply(p, batch, None, True),
                                         batch))(state.params)
    step = jtrain.build_train_step(apply, criterion, optimizer)
    losses = []
    for _ in range(steps):
        state, (_, loss) = step(state, batch, batch)
        losses.append(float(loss))
    return params, jax.tree.map(np.asarray, grads), losses


def _port_run(params, criterion, tokens, steps=3, **overrides):
    """The same through the port: first-step grads, per-step losses and
    the final parameters."""
    module = gpt2_tiny(dtype='float32', device='cpu', **overrides)
    module.load_state_dict(params_from_jax(params))
    optimizer = ttrain.AdamW(grad_clip=1.0)
    state = ttrain.init_state(module, optimizer)
    apply = ttrain.module_apply(module)
    batch = torch.as_tensor(tokens)
    loss = criterion(apply(state.params, batch, None, True), batch)
    grads = dict(zip(state.params, torch.autograd.grad(
        loss, list(state.params.values()))))
    step = ttrain.build_train_step(apply, criterion, optimizer)
    losses = [step(state, batch, batch)[1][1].item() for _ in range(steps)]
    return grads, losses, {name: leaf.detach().clone()
                           for name, leaf in state.params.items()}


def _assert_grads_close(grads, jax_grads):
    want = {name: tensor.numpy() for name, tensor in
            params_from_jax(jax_grads).items()}
    assert set(grads) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize('moe', [False, True], ids=['dense', 'moe'])
def test_gpt2_remat_train_steps_match_jax_and_equal_no_remat(moe):
    """Three AdamW flash steps of gpt2_tiny(remat=True) against the
    reference's ``remat=True`` model; on the CPU the port with ``remat`` is
    bitwise the port without it (dense, and MoE with two experts, whose
    routing the recompute repeats exactly)."""
    config = dict(attention='flash', return_features=True)
    criterion = ttrain.ChunkedNextTokenLoss(chunks=4)
    jax_criterion = jtrain.ChunkedNextTokenLoss(chunks=4)
    if moe:
        config.update(moe_experts=2, moe_sparse_impl='fused')
        criterion = ttrain.WithAuxLoss(criterion)
        jax_criterion = jtrain.WithAuxLoss(jax_criterion)
    tokens = _tokens(60 + moe, (2, 32))
    params, jax_grads, jax_losses = _reference_run(
        jax_gpt2_tiny(dtype='float32', remat=True, **config), jax_criterion,
        tokens)
    grads, losses, final = _port_run(params, criterion, tokens, remat=True,
                                     **config)
    _assert_grads_close(grads, jax_grads)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    plain_grads, plain_losses, plain_final = _port_run(
        params, criterion, tokens, remat=False, **config)
    assert losses == plain_losses
    for name in grads:
        assert torch.equal(grads[name], plain_grads[name]), name
        assert torch.equal(final[name], plain_final[name]), name


def test_gpt2_remat_recomputes_the_flash_forward():
    """With ``remat`` the backward runs each block's forward again: on the
    card K1 launches twice per layer per step (the plain version here,
    counted by calls), and the step's grads stay bitwise."""
    tokens = torch.as_tensor(_tokens(62, (2, 16)))
    calls = []
    original = tflash.flash_attention_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    grads = {}
    for remat in (False, True):
        module = gpt2_tiny(dtype='float32', device='cpu', attention='flash',
                           remat=remat)
        calls.clear()
        tflash.flash_attention_plain = counted
        try:
            loss = ttrain.NextTokenLoss()(module(tokens, train=True), tokens)
            grads[remat] = torch.autograd.grad(loss, list(module.parameters()))
        finally:
            tflash.flash_attention_plain = original
        assert len(calls) == (2 if remat else 1) * module.layers
    for plain, rematted in zip(grads[False], grads[True]):
        assert torch.equal(plain, rematted)


def test_gpt2_max_seq_2048_step_matches_jax():
    """One sequence of 2048 tokens through ``gpt2_tiny(max_seq=2048)`` on
    flash attention: the reference's fused backward takes K2a there (two
    kv tiles of 1024), the port's too; grads and three losses agree."""
    tokens = _tokens(63, (1, 2048))
    config = dict(attention='flash', return_features=True, max_seq=2048)
    params, jax_grads, jax_losses = _reference_run(
        jax_gpt2_tiny(dtype='float32', **config),
        jtrain.ChunkedNextTokenLoss(chunks=4), tokens, steps=2)
    grads, losses, _ = _port_run(params, ttrain.ChunkedNextTokenLoss(chunks=4),
                                 tokens, steps=2, **config)
    _assert_grads_close(grads, jax_grads)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)


def test_params_from_jax_carries_wpe_at_max_seq_2048():
    """The position table at ``max_seq=2048`` crosses name for name, and the
    port's forward over 2048 positions matches the reference's."""
    tokens = _tokens(64, (1, 2048))
    module = jax_gpt2_tiny(dtype='float32', max_seq=2048)
    params = module.init(jax.random.PRNGKey(4),
                         jnp.asarray(tokens, jnp.int32))['params']
    port = gpt2_tiny(dtype='float32', device='cpu', max_seq=2048)
    port.load_state_dict(params_from_jax(params))
    assert port.wpe.embedding.shape == (2048, 64)
    np.testing.assert_array_equal(port.wpe.embedding.detach().numpy(),
                                  np.asarray(params['wpe']['embedding']))
    want = module.apply({'params': params}, jnp.asarray(tokens, jnp.int32))
    got = port(torch.as_tensor(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
