"""The port's Llama against the JAX package's, with the same weights.

Two configurations are built in both packages: ``llama_tiny`` (head dim
16, GQA 4/2) and a head-dim-128 tiny (dim 256 over 2 query heads and 1 KV
head, ``max_seq`` 1024), whose prefills of 512 tokens or more take the flash
route: the reference's Pallas kernel in interpret mode, the port's plain
version of K1. The JAX init's params cross through
:func:`tpusystem_torch.convert.params_from_jax`.

Tolerances. In float32 the two packages differ only by summation order:
module outputs and logits agree at ``rtol = atol = 1e-5`` (the rotary
tables at ``atol = 1e-5``: XLA's and PyTorch's ``cos``/``sin`` reduce
arguments of up to ~1000 radians in their own ways, a few float32 ulps
apart). Greedy ``generate`` and the ``Engine`` must be token-exact in
float32. In bfloat16 the two round the same operands at the same points but
may land one bfloat16 step (2**-8 relative) apart wherever a float32 sum
differs in its last bits; through two blocks those steps reach the logits
at about 2**-6 of their largest magnitude, so bf16 logits agree within
2**-5 of the reference's largest |logit|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import llama as jllama
from tpusystem.ops.pallas import flash as jflash
from tpusystem.registry import gethash as jax_gethash
from tpusystem.serve import Engine as JaxEngine
from tpusystem.train import generate as jax_generate
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import Llama, llama3_8b, llama_tiny
from tpusystem_torch.models import llama as tllama
from tpusystem_torch.ops.cuda import flash as tflash
from tpusystem_torch.registry import gethash
from tpusystem_torch.serve import Engine
from tpusystem_torch.train import generate

TOL = dict(rtol=1e-5, atol=1e-5)
# the two configurations, as keyword overrides of llama_tiny
CONFIGS = {'tiny': {},
           'hd128': dict(dim=256, heads=2, kv_heads=1, max_seq=1024)}
# the head-dim-128 training slice: flash attention, remat, the chunked head
HD128_TRAIN = dict(dim=256, heads=2, kv_heads=1, ffn_dim=512, max_seq=256,
                   dtype='float32', attention='flash', remat=True,
                   return_features=True)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(config: str, dtype: str = 'float32', seed: int = 0):
    overrides = dict(CONFIGS[config], dtype=dtype)
    reference = jllama.llama_tiny(**overrides)
    params = reference.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))['params']
    port = llama_tiny(device='cpu', **overrides)
    state = params_from_jax(params)
    port.load_state_dict(state, strict=True)
    return reference, params, port, state


@pytest.fixture(scope='module')
def pairs():
    return {config: _pair(config) for config in CONFIGS}


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize('per_row', [False, True])
def test_rotary_matches_jax(per_row):
    rng = np.random.default_rng(0)
    x = _normal(rng, (2, 7, 3, 128))
    if per_row:           # rows at their own cursors, as decode reads them
        positions = np.array([[0], [5]]) + np.arange(7)[None] + 990
    else:
        positions = np.arange(7) + 3
    want_cos, want_sin = jllama.rotary_embedding(jnp.asarray(positions), 128)
    cos, sin = tllama.rotary_embedding(torch.as_tensor(positions), 128)
    assert cos.shape == (*positions.shape, 64) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(want_cos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(want_sin), atol=1e-5)
    want = jllama.apply_rotary(jnp.asarray(x), want_cos, want_sin)
    got = tllama.apply_rotary(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the pairs are interleaved: the first pair turns by the first angle
    first = torch.from_numpy(x)[..., :2]
    c, s = (t[..., 0] if t.dim() == 3 else t[None, :, 0] for t in (cos, sin))
    np.testing.assert_allclose(
        got[..., 0].numpy(),
        (first[..., 0] * c[..., None] - first[..., 1] * s[..., None]).numpy(),
        atol=1e-6)
    halves = tllama.apply_rotary(torch.from_numpy(x).bfloat16(), cos, sin)
    assert halves.dtype == torch.bfloat16


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    x, scale = _normal(rng, (2, 5, 64), 3.0), _normal(rng, (64,))
    want = jllama.RMSNorm().apply({'params': {'scale': jnp.asarray(scale)}},
                                  jnp.asarray(x))
    norm = tllama.RMSNorm(64, device='cpu')
    norm.load_state_dict({'scale': torch.from_numpy(scale)})
    got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert norm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize('config', list(CONFIGS))
def test_block_matches_jax(config):
    heads, kv_heads = (CONFIGS[config].get('heads', 4),
                       CONFIGS[config].get('kv_heads', 2))
    dim = CONFIGS[config].get('dim', 64)
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 11, dim))
    block = jllama.LlamaBlock(heads, kv_heads, 128, jnp.float32)
    params = block.init(jax.random.PRNGKey(3), jnp.asarray(x))['params']
    want = block.apply({'params': params}, jnp.asarray(x))
    port = tllama.LlamaBlock(dim, heads, kv_heads, 128, device='cpu')
    port.load_state_dict(params_from_jax(params), strict=True)
    attention = lambda q, k, v: tllama.attend(q, k, v, kernel='xla')
    got = port(torch.from_numpy(x), torch.float32, attention,
               torch.arange(11), 500_000.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('config', list(CONFIGS))
def test_params_cross_name_for_name(pairs, config):
    _, params, port, state = pairs[config]
    assert set(state) == set(port.state_dict())
    dim, heads = port.dim, port.heads
    assert state['layer_0.attn.q.kernel'].shape == (dim, dim)     # [in, out]
    assert state['layer_0.attn.k.kernel'].shape == (
        dim, port.kv_heads * dim // heads)
    assert state['layer_1.gate.kernel'].shape == (dim, 128)
    assert state['lm_head.kernel'].shape == (dim, 256)             # untied
    assert state['embed.embedding'].dtype == torch.float32


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('config', list(CONFIGS))
def test_forward_logits_match(config, dtype):
    reference, params, port, _ = _pair(config, dtype)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 40))
    want = np.asarray(reference.apply({'params': params},
                                      jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got = port(torch.as_tensor(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        err = np.abs(got.numpy() - want).max()
        assert err <= 2 ** -5 * np.abs(want).max(), err


@pytest.mark.parametrize('config', list(CONFIGS))
def test_decode_prefill_then_steps_match(pairs, config):
    reference, params, port, _ = pairs[config]
    decoder = dataclasses.replace(reference, decode=True)
    port_decoder = port.replace(decode=True)
    prompt = np.random.default_rng(5).integers(0, 256, (2, 9))
    want, state = decoder.apply({'params': params},
                                jnp.asarray(prompt, jnp.int32),
                                mutable=['cache'])
    with torch.no_grad():
        got, cache = port_decoder(torch.as_tensor(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    token = np.array(jnp.argmax(want[:, -1], -1))
    for step in range(3):
        want, state = decoder.apply(
            {'params': params, 'cache': state['cache']},
            jnp.asarray(token[:, None], jnp.int32), mutable=['cache'])
        with torch.no_grad():
            got, cache = port_decoder(torch.as_tensor(token[:, None]), cache,
                                      depth=9 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        token = np.array(jnp.argmax(want[:, -1], -1))
    assert 'position' not in cache
    assert cache['layer_1/attn/key'].shape == (2, port.max_seq,
                                               port.kv_heads, port.head_dim)
    fresh = port_decoder.init_cache(2)         # the same layout, zeroed
    assert {path: leaf.shape for path, leaf in fresh.items()} == {
        path: leaf.shape for path, leaf in cache.items()}
    np.testing.assert_array_equal(cache['layer_1/attn/index'].numpy(),
                                  [12, 12])


@pytest.mark.parametrize('config,length,stream_dtype', [
    ('tiny', 7, 'auto'), ('hd128', 7, 'auto'), ('hd128', 520, 'auto'),
    ('tiny', 7, 'int8'), ('tiny', 7, 'fp8')])
def test_generate_token_exact_with_jax(pairs, config, length, stream_dtype):
    """Greedy tokens equal the reference's; a 520-token prompt prefills
    through the flash route in both packages; int8/fp8-streamed weights
    run the module path on their dequantized view in both."""
    reference, params, port, state = pairs[config]
    prompt = np.random.default_rng(length).integers(0, 256, (2, length))
    want = jax_generate(reference, params, jnp.asarray(prompt, jnp.int32),
                        steps=10, stream_dtype=stream_dtype)
    got = generate(port, state, prompt, steps=10, stream_dtype=stream_dtype,
                   device='cpu')
    assert got.dtype == torch.int32 and got.shape == (2, length + 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _plain(result):
    """An engine call's result as plain data, comparable across packages."""
    if hasattr(result, 'emitted'):
        return ('step', result.emitted, result.finished)
    if hasattr(result, 'finished'):
        return ('admit', result.row, result.token, result.finished,
                result.reason)
    return ('evicted', list(result.tokens))


def _drive(engine, prompts, budgets):
    """Two requests, a cancellation (evict) with an admission into the freed
    row, then the last request as soon as a row frees."""
    log = [engine.admit(prompts[0], budgets[0]),
           engine.admit(prompts[1], budgets[1])]
    for _ in range(3):
        log.append(engine.step())
    log.append(engine.evict(log[1].row))
    log.append(engine.admit(prompts[2], budgets[2]))
    waiting = True
    while engine.active_rows:
        log.append(engine.step())
        if waiting and engine.free_rows:
            log.append(engine.admit(prompts[3], budgets[3]))
            waiting = False
    return [_plain(entry) for entry in log]


@pytest.mark.parametrize('config,lengths', [
    ('tiny', (5, 11, 8, 3)),
    ('hd128', (5, 600, 8, 30)),    # the 600-token prompt takes the flash route
])
def test_engine_token_exact_with_jax_engine_under_churn(pairs, config,
                                                        lengths, monkeypatch):
    reference, params, port, state = pairs[config]
    routed = []
    original = tflash.flash_attention

    def counting(*args, **kwargs):
        routed.append(tuple(args[0].shape))
        return original(*args, **kwargs)

    monkeypatch.setattr(tflash, 'flash_attention', counting)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (n,)) for n in lengths]
    budgets = [14, 6, 10, 9]
    want = _drive(JaxEngine(reference, params, rows=2, block_size=8),
                  prompts, budgets)
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    assert engine.decode_impl == 'flax'
    got = _drive(engine, prompts, budgets)
    assert got == want
    assert sum(entry[0] == 'step' for entry in got) >= 10
    assert engine.pool.audit() == {'free': engine.pool.blocks - 1,
                                   'cached': 0, 'live': 0}
    flash_prompts = sum(n >= 512 for n in lengths)
    assert routed == [(1, 1024, port.heads, port.head_dim)] * (
        port.layers * flash_prompts)


def test_next_logits_match_the_full_forward(pairs):
    """The logits through the paged cache equal the non-cached forward over
    the prompt and the tokens so far (the card's probe, on the CPU)."""
    _, _, port, state = pairs['hd128']
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    prompt = np.random.default_rng(8).integers(0, 256, (13,))
    tokens = list(prompt) + [engine.admit(prompt, max_new=6).token]
    for _ in range(3):
        logits = engine.next_logits()[0]
        with torch.no_grad():
            full = port(torch.as_tensor([tokens]))[0, -1]
        np.testing.assert_allclose(logits.numpy(), full.numpy(), **TOL)
        tokens += engine.step().emitted[0]


@pytest.mark.parametrize('kv_heads', [8, 2])          # MHA, GQA group 4
def test_flash_attention_lse_at_head_dim_128_matches_jax(kv_heads):
    rng = np.random.default_rng(9)
    q = _normal(rng, (1, 512, 8, 128))
    k = _normal(rng, (1, 512, kv_heads, 128))
    v = _normal(rng, (1, 512, kv_heads, 128))
    want_out, want_lse = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    before = tflash.flash_attention_lse.launches
    got_out, got_lse = tflash.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    assert tflash.flash_attention_lse.launches == before   # CPU: plain
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_flash_backward_at_head_dim_128_refuses_off_the_cpu():
    """Head dim 128 is a head dim of every flash kernel now: a forward that
    autograd would differentiate at 128 off the CPU stops only at the device
    check (``meta`` tensors stand in for the card's here), while a head dim
    no kernel takes still raises before anything runs, in the forward, the
    backward and a backward kernel's own entry."""
    assert 128 in tflash.HEAD_DIMS
    q = torch.zeros(1, 64, 4, 128, device='meta', requires_grad=True)
    k = torch.zeros(1, 64, 2, 128, device='meta')
    with pytest.raises(ValueError, match='tensors on meta are not supported'):
        tflash.flash_attention_lse(q, k, k)
    odd = torch.zeros(1, 64, 4, 96, device='meta', requires_grad=True)
    with pytest.raises(ValueError, match='head_dim 96 not in'):
        tflash.flash_attention_lse(odd, odd[:, :, :2], odd[:, :, :2])
    with pytest.raises(ValueError, match='head_dim 96 not in'):
        tflash.flash_attention_bwd(odd, odd, odd, odd, odd[..., 0], odd)
    with pytest.raises(ValueError, match='head_dim 96 not in'):
        tflash.flash_bwd_fused(odd, odd, odd, odd, odd[..., 0], odd[..., 0])


# where the first gradient is below this share of the largest, it is float32
# summation noise, and Adam's mu / sqrt(nu) may turn a noise-level difference
# into a step of up to lr
NOISE = 1e-6
# the most of a leaf that may sit outside TOL after three steps, all of it on
# such noise (3 of 131,072 elements of a leaf on the flash route, 2 on the
# xla route)
NOISE_SHARE = 1e-4


def _jax_train_slice(attention: str):
    """Three steps of the reference's ``build_train_step(flax_apply)`` on a
    head-dim-128 Llama (remat, the chunked untied head, AdamW with
    clipping) on ``attention``'s route: the tokens, the initial params, the
    first step's gradients, each step's loss and the final params."""
    from tpusystem import train as jtrain

    module = jllama.llama_tiny(**{**HD128_TRAIN, 'attention': attention})
    tokens = np.random.default_rng(12).integers(0, 256, (2, 64))
    batch = jnp.asarray(tokens, jnp.int32)
    optimizer = jtrain.AdamW(lr=3e-4, grad_clip=1.0)
    state = jtrain.init_state(module, optimizer, batch, rng=0)
    params = jax.tree.map(np.asarray, state.params)
    apply = jtrain.flax_apply(module)
    criterion = jtrain.ChunkedNextTokenLoss(chunks=4, tied=False)
    grads = jax.grad(lambda p: criterion(apply(p, batch, None, True),
                                         batch))(state.params)
    step = jtrain.build_train_step(apply, criterion, optimizer)
    losses = []
    for _ in range(3):
        state, (_, loss) = step(state, batch, batch)
        losses.append(float(loss))
    return (tokens, params, params_from_jax(jax.tree.map(np.asarray, grads)),
            losses, params_from_jax(jax.tree.map(np.asarray, state.params)))


@pytest.fixture(scope='module')
def hd128_train_slice():
    return _jax_train_slice('flash')


def _port_train_slice(attention: str, want):
    """The port's three steps against the reference's ``want``: the losses
    and the first gradients within 1e-5, and every parameter within 1e-5
    except on gradient noise (``NOISE``), where it is held to the three
    steps' reach, ``3 * 2 * lr``, and to at most ``NOISE_SHARE`` of its
    leaf. Returns the count of elements outside 1e-5 per leaf."""
    from tpusystem_torch import train as ttrain

    tokens, params, want_grads, want_losses, want_params = want
    port = llama_tiny(device='cpu', **{**HD128_TRAIN, 'attention': attention})
    port.load_state_dict(params_from_jax(params), strict=True)
    assert port.head_dim == 128
    optimizer = ttrain.AdamW(lr=3e-4, grad_clip=1.0)
    state = ttrain.init_state(port, optimizer)
    apply = ttrain.module_apply(port)
    criterion = ttrain.ChunkedNextTokenLoss(chunks=4, tied=False)
    batch = torch.as_tensor(tokens)
    grads = torch.autograd.grad(criterion(apply(state.params, batch, None,
                                                True), batch),
                                list(state.params.values()))
    scale = max(g.abs().max().item() for g in want_grads.values())
    for name, grad in zip(state.params, grads):
        np.testing.assert_allclose(grad.numpy(), want_grads[name].numpy(),
                                   rtol=0, atol=1e-5 * scale, err_msg=name)
    step = ttrain.build_train_step(apply, criterion, optimizer)
    launches = (tflash.flash_attention_lse.launches,
                tflash.flash_bwd_fused.launches)
    losses = [step(state, batch, batch)[1][1].item() for _ in range(3)]
    assert (tflash.flash_attention_lse.launches,
            tflash.flash_bwd_fused.launches) == launches     # CPU: plain
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert losses[-1] < losses[0]
    assert set(state.params) == set(want_params)
    outside = {}
    for name, value in state.params.items():
        got, want = value.detach().numpy(), want_params[name].numpy()
        off = ~np.isclose(got, want, **TOL)
        noise = np.abs(want_grads[name].numpy()) < NOISE * scale
        assert not (off & ~noise).any(), (
            f'{name}: {np.count_nonzero(off & ~noise)} elements with a '
            f'gradient above noise differ by more than 1e-5')
        assert off.mean() <= NOISE_SHARE, (name, np.count_nonzero(off))
        np.testing.assert_allclose(got, want, rtol=0, atol=3 * 2 * 3e-4,
                                   err_msg=name)
        if off.any():
            outside[name] = int(np.count_nonzero(off))
    print(f'{attention}: elements outside 1e-5 after three steps, all on '
          f'gradient noise: {outside}')
    return outside


def test_head_dim_128_train_steps_match_jax(hd128_train_slice):
    """Llama training at head dim 128 through the flash route: the port's
    ``build_train_step(module_apply)`` and the reference's, from the same
    weights, three steps of ``ChunkedNextTokenLoss(chunks=4, tied=False)``
    and ``AdamW(lr=3e-4, grad_clip=1.0)``; ``remat=True`` recomputes each
    block. The [2, 64] batch is one 64-row block of the reference's Pallas
    kernels (interpret mode), the port's plain K1 and backward on the CPU.

    In float32: the first step's gradients within 1e-5 of the largest
    gradient and the three losses within 1e-5, as the GPT-2 slice's test
    holds them; every parameter after three steps within 1e-5, but for at
    most ``NOISE_SHARE`` of a leaf whose first gradient is noise (below
    ``NOISE`` of the largest), held to ``3 * 2 * lr``
    (:func:`_port_train_slice`;
    :func:`test_head_dim_128_xla_route_has_the_same_adam_floor` shows that
    floor without the flash route)."""
    _port_train_slice('flash', hd128_train_slice)


def test_head_dim_128_xla_route_has_the_same_adam_floor():
    """The floor the flash test allows is AdamW's, not the flash kernels':
    on the ``'xla'`` route, autograd through plain attention in both
    packages, the same three steps also leave a few elements outside 1e-5
    after matching losses and first gradients, each one where the first
    gradient is noise, so Adam's ``mu / sqrt(nu)`` amplified a last-bit
    difference of that noise into a step of up to ``lr``."""
    assert _port_train_slice('xla', _jax_train_slice('xla'))


def test_remat_gives_the_same_loss_and_gradients(pairs):
    """``remat=True`` recomputes each block in the backward: the loss and
    every gradient equal the model's without it, bit for bit (float32,
    xla attention)."""
    _, _, port, state = pairs['tiny']
    tokens = torch.as_tensor(np.random.default_rng(10).integers(0, 256,
                                                                (2, 16)))
    grads = []
    for remat in (False, True):
        model = port.replace(remat=remat)
        params = {name: t.clone().requires_grad_() for name, t in
                  state.items()}
        logits = torch.func.functional_call(model, params, (tokens,))
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(
            -1, 256), tokens[:, 1:].reshape(-1))
        grads.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


@pytest.mark.parametrize('overrides', [{}, {'dtype': 'float32'},
                                       CONFIGS['hd128']])
def test_registry_identity_matches_bitwise(overrides):
    assert (gethash(llama_tiny(device='cpu', **overrides))
            == jax_gethash(jllama.llama_tiny(**overrides)))


def test_8b_preset_identity_and_shapes(monkeypatch):
    """``llama3_8b``'s identity equals the reference's; built on the meta
    device (no weights drawn), its parameter count is the 8B's."""
    class NoDraws:
        def __init__(self, device):
            pass

        def manual_seed(self, seed):
            return self

    monkeypatch.setattr(torch, 'Generator', NoDraws)
    monkeypatch.setattr(Llama, 'init_weights', lambda self, generator: None)
    model = llama3_8b(device='meta')
    assert gethash(model) == jax_gethash(jllama.llama3_8b())
    assert (model.head_dim, model.kv_heads, model.remat) == (128, 8, True)
    assert sum(p.numel() for p in model.parameters()) == 8_030_261_248


def test_init_weights_draw_the_flax_distributions():
    """Per leaf, the port's init has the reference init's scale."""
    overrides = dict(dim=256, heads=2, kv_heads=1, ffn_dim=512, vocab_size=512)
    params = jllama.llama_tiny(**overrides).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params']
    want = params_from_jax(params)
    port = llama_tiny(device='cpu', **overrides)
    port.init_weights(torch.Generator('cpu').manual_seed(1))
    for name, tensor in port.state_dict().items():
        got_std, want_std = tensor.std().item(), want[name].std().item()
        assert abs(got_std - want_std) <= 0.05 * want_std + 1e-6, name
        assert abs(tensor.abs().max().item()
                   - want[name].abs().max().item()) <= 0.25 * (
                       want[name].abs().max().item()) + 1e-6, name


def test_unported_options_name_their_roadmap_item(pairs):
    _, _, port, state = pairs['tiny']
    assert llama_tiny(device='cpu', scan_layers=True).scan_layers
    # ring attention (9e), mesh= and schedule= (9c) are ported: ring
    # attention needs a mesh, and a schedule that is not an OverlapSchedule
    # is the reference's TypeError
    with pytest.raises(ValueError, match='needs a mesh'):
        llama_tiny(device='cpu', attention='ring')(
            torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(TypeError, match='OverlapSchedule'):
        llama_tiny(device='cpu', schedule=object())
    with pytest.raises(ValueError, match='GPT2 family only'):
        generate(port, state, [[1, 2]], steps=2, decode_impl='fused',
                 device='cpu')
    with pytest.raises(ValueError, match='GPT2 family only'):
        Engine(port, state, decode_impl='fused', device='cpu')
    assert isinstance(port, Llama)
