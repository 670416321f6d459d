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
largest gradient of their tensor.
"""

import pytest
import torch

from tpusystem_torch.ops.cuda import decode_matmul as dm
from tpusystem_torch.ops.cuda import flash

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


@pytest.mark.parametrize('batch,seq,heads,kv_heads,head_dim,causal', [
    (1, 512, 12, 12, 64, True),
    (1, 1024, 12, 12, 64, True),
    (2, 200, 4, 2, 32, True),
    (1, 65, 6, 3, 16, False),
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


def _bwd_inputs(device, batch, seq, heads, kv_heads, seed):
    generator = torch.Generator(device).manual_seed(seed)
    shape, kv_shape = (batch, seq, heads, 64), (batch, seq, kv_heads, 64)
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


@pytest.mark.parametrize('batch,seq,heads,kv_heads,causal', [
    (1, 1024, 12, 12, True),
    (8, 512, 12, 12, True),
    (2, 256, 12, 4, True),          # GQA group 3
    (1, 300, 4, 4, False),          # non-causal, ragged
    (2, 1000, 4, 2, True),          # ragged, GQA
    (1, 1, 2, 2, True),
])
@pytest.mark.parametrize('backward', ['fused', 'split'])
def test_flash_backward_matches_plain(device, batch, seq, heads, kv_heads,
                                      causal, backward):
    q, k, v, d_out, d_lse = _bwd_inputs(device, batch, seq, heads, kv_heads,
                                        seq + heads)
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


@pytest.mark.parametrize('backward', ['fused', 'split'])
def test_flash_backward_repeats_bitwise(device, backward):
    q, k, v, d_out, d_lse = _bwd_inputs(device, 2, 640, 8, 4, 5)
    out, lse = flash.flash_attention_plain(q, k, v)
    first = flash.flash_attention_bwd(q, k, v, out, lse, d_out, d_lse,
                                      backward=backward)
    second = flash.flash_attention_bwd(q, k, v, out, lse, d_out, d_lse,
                                       backward=backward)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
