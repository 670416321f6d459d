"""The port's serving path against the JAX package's, token for token.

The JAX ``Engine`` and ``generate`` are the oracles: the port's must emit
the same greedy tokens for the same calls, in float32 on the CPU
(``gpt2_tiny(dtype='float32')``, one set of weights carried over by
:func:`tpusystem_torch.convert.params_from_jax`). That is the reference's
own contract between its engine and ``generate`` (window-invariant
arithmetic); the port's decode kernels run their plain versions here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.serve import Engine as JaxEngine
from tpusystem.train import generate as jax_generate
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.ops.cuda import flash
from tpusystem_torch.serve import Engine, prefill_bucket
from tpusystem_torch.train import generate


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed: int = 0, **overrides):
    reference = jax_gpt2_tiny(dtype='float32', **overrides)
    params = reference.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))['params']
    port = gpt2_tiny(dtype='float32', device='cpu', **overrides)
    return reference, params, port, params_from_jax(params)


@pytest.fixture(scope='module')
def served():
    return _pair()


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


def test_engine_token_exact_with_jax_engine_under_churn(served):
    reference, params, port, state = served
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (n,)) for n in (5, 11, 8, 3)]
    budgets = [14, 6, 10, 9]
    want = _drive(JaxEngine(reference, params, rows=2, block_size=8,
                            decode_impl='fused'), prompts, budgets)
    engine = Engine(port, state, rows=2, block_size=8, decode_impl='fused',
                    device='cpu')
    got = _drive(engine, prompts, budgets)
    assert got == want
    assert sum(entry[0] == 'step' for entry in got) >= 10
    assert engine.pool.audit() == {'free': engine.pool.blocks - 1,
                                   'cached': 0, 'live': 0}


def test_flax_and_fused_engine_steps_agree(served):
    _, _, port, state = served
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, (n,)) for n in (6, 9, 4, 12)]
    budgets = [7, 5, 8, 6]
    runs = [_drive(Engine(port, state, rows=2, block_size=8,
                          decode_impl=impl, device='cpu'), prompts, budgets)
            for impl in ('flax', 'fused')]
    assert runs[0] == runs[1]


def test_stop_token_finishes_like_jax(served):
    reference, params, port, state = served
    prompt = np.random.default_rng(5).integers(0, 256, (6,))

    def run(engine, stop):
        admission = engine.admit(prompt, max_new=12, stop_token=stop)
        reports = []
        while engine.active_rows:
            report = engine.step()
            reports.append((report.emitted, report.finished))
        return _plain(admission), reports

    free = Engine(port, state, rows=1, block_size=8, device='cpu')
    first = free.admit(prompt, max_new=12).token
    stream = [first]
    while free.active_rows:
        stream += free.step().emitted[0]
    # the first token that differs from the admission's, so the stop lands
    # in a decode step
    stop = next((t for t in stream if t != first), first)
    want = run(JaxEngine(reference, params, rows=1, block_size=8), stop)
    got = run(Engine(port, state, rows=1, block_size=8, device='cpu'), stop)
    assert got == want
    reasons = [got[0][4]] + [reason for _, done in got[1]
                             for _, reason, _ in done]
    assert 'stop' in reasons


def test_next_logits_probe_agrees_and_advances_nothing(served):
    _, _, port, state = served
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    engine.admit(np.arange(5) + 3, max_new=6)
    engine.step()
    before = [engine.tokens(0), engine.pool.table.copy()]
    fused, module_path = (engine.next_logits('fused'),
                          engine.next_logits('flax'))
    assert fused.shape == (2, 256)
    np.testing.assert_allclose(fused.numpy(), module_path.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert engine.tokens(0) == before[0]
    np.testing.assert_array_equal(engine.pool.table, before[1])
    step = engine.step()
    assert step.emitted[0] == [int(fused[0].argmax())]


def test_flash_routed_prefill_token_exact(monkeypatch):
    """A 300-token prompt pads to the 512 bucket, whose prefill takes the
    flash kernel in both packages (interpret mode / plain version)."""
    reference, params, port, state = _pair(seed=1, max_seq=512)
    assert prefill_bucket(300, 16, 512) == 512
    routed = []
    original = flash.flash_attention

    def counting(*args, **kwargs):
        routed.append(args[0].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(flash, 'flash_attention', counting)
    prompt = np.random.default_rng(29).integers(0, 256, (300,))

    def run(engine):
        admission = engine.admit(prompt, max_new=6)
        tokens = None
        while engine.active_rows:
            for _row, _reason, out in engine.step().finished:
                tokens = out
        return admission.token, tokens

    want = run(JaxEngine(reference, params, rows=2, block_size=16,
                         decode_impl='fused'))
    got = run(Engine(port, state, rows=2, block_size=16, decode_impl='fused',
                     device='cpu'))
    assert got == want
    assert routed == [(1, 512, 4, 16)] * 2          # both layers' prefill


@pytest.mark.parametrize('decode_impl', ['flax', 'fused'])
def test_generate_token_exact_with_jax(served, decode_impl):
    reference, params, port, state = served
    prompt = np.random.default_rng(3).integers(0, 256, (2, 7))
    want = jax_generate(reference, params, jnp.asarray(prompt, jnp.int32),
                        steps=12, decode_impl='flax')
    got = generate(port, state, prompt, steps=12, decode_impl=decode_impl,
                   device='cpu')
    assert got.dtype == torch.int32 and got.shape == (2, 19)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_refuses_what_is_not_ported(served):
    from tpusystem_torch.serve import SamplingParams
    _, _, port, state = served
    for option in ({'share_prefix': True}, {'draft_module': port},
                   {'mesh': object()}):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            Engine(port, state, device='cpu', **option)
    engine = Engine(port, state, rows=1, block_size=8, device='cpu')
    with pytest.raises(NotImplementedError, match='threefry'):
        engine.admit([1, 2, 3], 4,
                     sampling=SamplingParams(seed=0, temperature=0.7))
    with pytest.raises(NotImplementedError, match='threefry'):
        generate(port, state, [[1, 2]], steps=2, temperature=0.5,
                 device='cpu')


def test_engine_validates_capacity_and_saturation(served):
    from tpusystem_torch.serve import Saturated
    _, _, port, state = served
    engine = Engine(port, state, rows=1, block_size=8, device='cpu')
    with pytest.raises(ValueError, match='max_seq'):
        engine.admit(np.arange(8), max_new=121)    # 8 + 121 > 128
    with pytest.raises(ValueError, match='max_new'):
        engine.admit(np.arange(8), max_new=0)
    engine.admit(np.arange(4) + 1, max_new=4)
    with pytest.raises(Saturated, match='free row'):
        engine.admit(np.arange(4) + 1, max_new=4)
    assert dataclasses.is_dataclass(engine.step())
