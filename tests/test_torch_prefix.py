"""Prefix sharing and the resume prefill of the port's ``Engine``.

Twins of ``TestRadixPrefixSharing``'s engine tests (``tests/test_serve.py``)
on the port, then the port's ``Engine(share_prefix=True)`` against the JAX
package's: token for token and with equal ``sharing`` counters under churn
(float32 on the CPU, prompts under 512 tokens, where the resume's masked
decode read equals the full causal prefill in window-invariant arithmetic).
Last, a shared prefix whose first full prefill takes the flash kernel (512
tokens or more): the resume then mixes flash-era prefix KV with the masked
read, which the reference documents as exact only up to a near-tie of the
argmax; the test holds the resumed logits to ``NEAR_TIE`` of the full
prefill's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.models import llama as jllama
from tpusystem.serve import Engine as JaxEngine
from tpusystem.serve import SamplingParams as JaxSamplingParams
from tpusystem.train import generate as jax_generate
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny, llama_tiny
from tpusystem_torch.ops.cuda import flash
from tpusystem_torch.serve import Engine, SamplingParams

NEAR_TIE = 1e-4         # float32 logits: flash against the masked read


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(family: str, **overrides):
    if family == 'gpt2':
        reference = jax_gpt2_tiny(dtype='float32', **overrides)
        port = gpt2_tiny(dtype='float32', device='cpu', **overrides)
    else:
        reference = jllama.llama_tiny(dtype='float32', **overrides)
        port = llama_tiny(dtype='float32', device='cpu', **overrides)
    params = reference.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))['params']
    return reference, params, port, params_from_jax(params)


@pytest.fixture(scope='module')
def served():
    return _pair('gpt2')


def reference_tokens(reference, params, prompt, steps):
    out = jax_generate(reference, params,
                       jnp.asarray(prompt, jnp.int32)[None], steps=steps)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def run(engine, requests) -> dict:
    """Serve ``requests`` (``name: (prompt, max_new)``) in order, admitting
    as rows free: every request's tokens."""
    queue, rows, done = list(requests), {}, {}
    while queue or engine.active_rows:
        while queue and engine.free_rows:
            name = queue.pop(0)
            rows[engine.admit(*requests[name]).row] = name
        for row, _reason, tokens in engine.step().finished:
            done[rows.pop(row)] = tokens
    return done


# twins of tests/test_serve.py's TestRadixPrefixSharing engine tests


def test_engine_sharing_is_token_exact_and_counts_hits(served):
    """Co-batched requests sharing a system prompt adopt its blocks and stay
    token-exact against the reference's ``generate``; the retired prefix is
    adopted again, warm, by a later wave."""
    reference, params, port, state = served
    rng = np.random.default_rng(43)
    engine = Engine(port, state, rows=4, block_size=4, blocks=64,
                    share_prefix=True, device='cpu')
    head = [int(t) for t in rng.integers(0, 256, (21,))]
    prompts = [head + [int(t) for t in rng.integers(0, 256, (k,))]
               for k in (3, 4, 5, 2)]
    results = run(engine, {f'r{index}': (prompt, 5)
                           for index, prompt in enumerate(prompts)})
    for index, prompt in enumerate(prompts):
        assert results[f'r{index}'] == reference_tokens(
            reference, params, prompt, 5), f'r{index} diverged'
    assert engine.sharing['prefix_hits'] == 3          # all but the first
    assert engine.sharing['resumed_prefills'] == 3
    assert engine.prefix_hit_rate() > 0.5
    # second wave: the whole prefix is warm in the radix tree
    assert engine.prefix_cached_len(head + [9]) == 20   # (21-1)//4*4
    assert engine.admit_cost(head + [9]) == engine.bucket(2)
    results = run(engine, {'warm': (head + [9, 9], 4)})
    assert results['warm'] == reference_tokens(reference, params,
                                               head + [9, 9], 4)
    assert engine.pool.audit()['live'] == 0


def test_sharing_row_tokens_independent_of_cobatched_traffic(served):
    _, _, port, state = served
    rng = np.random.default_rng(47)
    prompt = [int(t) for t in rng.integers(0, 256, (13,))]
    solo = run(Engine(port, state, rows=4, block_size=4, share_prefix=True,
                      device='cpu'), {'solo': (prompt, 6)})['solo']
    engine = Engine(port, state, rows=4, block_size=4, share_prefix=True,
                    device='cpu')
    engine.admit(prompt[:9] + [3, 1, 4, 1], max_new=6)   # partial share
    admission = engine.admit(prompt, max_new=6)
    engine.admit([int(t) for t in rng.integers(0, 256, (7,))], max_new=6)
    tokens = {}
    while engine.active_rows:
        for row, _reason, out in engine.step().finished:
            tokens[row] = out
    assert tokens[admission.row] == solo
    assert engine.sharing['prefix_hits'] == 1


# the port's engine against the reference's


def _drive(engine, sampling_cls, prompts, budgets):
    """Admit in order while the pool can seat the next prompt (every third
    request sampled), logging admissions, cached lengths, steps, the
    sharing counters and the pool's audit."""
    log, queue = [], list(range(len(prompts)))
    while queue or engine.active_rows:
        while queue and engine.can_admit(len(prompts[queue[0]]),
                                         budgets[queue[0]],
                                         prompt=prompts[queue[0]]):
            index = queue.pop(0)
            sampling = (sampling_cls(seed=index, temperature=0.8)
                        if index % 3 == 1 else None)
            cached = engine.prefix_cached_len(prompts[index])
            admission = engine.admit(prompts[index], budgets[index],
                                     sampling=sampling)
            log.append(('admit', admission.row, admission.token,
                        admission.finished, cached))
        report = engine.step()
        log.append(('step', report.emitted, report.finished))
    return log, dict(engine.sharing), engine.pool.audit()


@pytest.mark.parametrize('family', ['gpt2', 'llama'])
def test_shared_prefix_engine_token_exact_with_jax_engine(family):
    reference, params, port, state = _pair(family)
    rng = np.random.default_rng(43)
    head = [int(t) for t in rng.integers(0, 256, (21,))]
    other = [int(t) for t in rng.integers(0, 256, (12,))]
    tails = [list(rng.integers(0, 256, (k,))) for k in (3, 4, 5, 2)]
    prompts = [np.array(head + [int(t) for t in tail]) for tail in tails]
    prompts += [np.array(other + [1, 2]), np.array(head[:9] + [3, 1, 4]),
                np.array(head + [9, 9]), np.array(other + [5])]
    budgets = [5, 6, 4, 7, 5, 6, 4, 5]
    knobs = dict(rows=3, block_size=4, blocks=64, share_prefix=True)
    want = _drive(JaxEngine(reference, params, **knobs), JaxSamplingParams,
                  prompts, budgets)
    got = _drive(Engine(port, state, device='cpu', **knobs), SamplingParams,
                 prompts, budgets)
    assert got == want
    assert got[1]['resumed_prefills'] == got[1]['prefix_hits'] >= 5


def test_resume_cache_is_its_read_window(monkeypatch):
    """At ``max_seq`` 1024 a resumed prefill of a 64-token prefix and a
    short suffix builds its contiguous cache only as long as its masked
    read's window (256 positions) and adopts only those slots; the engine
    stays token-exact with the reference's, and the resumed logits equal a
    full prefill's within float32 reordering."""
    reference, params, port, state = _pair('gpt2', max_seq=1024)
    rng = np.random.default_rng(37)
    head = [int(t) for t in rng.integers(0, 256, (64,))]
    prompts = [np.array(head + [int(t) for t in rng.integers(0, 256, (k,))])
               for k in (9, 30, 5)]
    budgets = [6, 5, 7]
    knobs = dict(rows=3, block_size=16, share_prefix=True)
    want = _drive(JaxEngine(reference, params, **knobs), JaxSamplingParams,
                  prompts, budgets)
    engine = Engine(port, state, device='cpu', **knobs)
    strips = []
    resume = engine._resume

    def recording(*args):
        logits, cache = resume(*args)
        strips.append({tuple(leaf.shape) for path, leaf in cache.items()
                       if path.endswith(('/key', '/value'))})
        return logits, cache

    monkeypatch.setattr(engine, '_resume', recording)
    got = _drive(engine, SamplingParams, prompts, budgets)
    assert got == want
    assert got[1]['resumed_prefills'] == 2
    assert strips == [{(1, 256, 4, 16)}] * 2

    seated = Engine(port, state, device='cpu', **knobs)
    seated.admit(prompts[0], max_new=4)
    row = seated.admit(prompts[1], max_new=4).row
    resumed, _ = resume.__func__(seated, prompts[1], seated.pool.slots(row),
                                 64)
    full, _ = seated._prefill(prompts[1])
    assert (resumed - full).abs().max().item() <= NEAR_TIE


def test_saturated_admission_rolls_back_whole(served):
    """An admission the pool cannot back raises ``Saturated`` and leaves the
    row and every block where they were."""
    from tpusystem_torch.serve import Saturated
    _, _, port, state = served
    engine = Engine(port, state, rows=2, block_size=4, blocks=8,
                    share_prefix=True, device='cpu')
    engine.admit(list(range(1, 10)), max_new=4)          # 4 of 7 blocks
    before = (engine.free_rows, engine.pool.free_blocks,
              engine.pool.audit())
    assert not engine.can_admit(12, 4, prompt=list(range(50, 62)))
    with pytest.raises(Saturated, match='blocks needed'):
        engine.admit(list(range(50, 62)), max_new=4)
    assert (engine.free_rows, engine.pool.free_blocks,
            engine.pool.audit()) == before


def test_flash_routed_shared_prefix(monkeypatch):
    """A 600-token prompt prefills at bucket 1024 through the flash kernel;
    a second prompt sharing its first 576 tokens resumes over a 20-token
    suffix. Port and reference admit and step alike (the same flash-era
    prefix KV, the same resume), and the resumed first-token logits are
    within ``NEAR_TIE`` of a full prefill of that prompt."""
    reference, params, port, state = _pair('gpt2', max_seq=1024)
    routed = []
    original = flash.flash_attention

    def counting(*args, **kwargs):
        routed.append(args[0].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(flash, 'flash_attention', counting)
    rng = np.random.default_rng(31)
    first = rng.integers(0, 256, (600,))
    second = np.concatenate([first[:576], rng.integers(0, 256, (20,))])

    def drive(engine):
        log = [engine.admit(first, max_new=4).token,
               engine.admit(second, max_new=4).token]
        while engine.active_rows:
            log.append(engine.step().emitted)
        return log, dict(engine.sharing)

    knobs = dict(rows=2, block_size=16, share_prefix=True)
    want = drive(JaxEngine(reference, params, **knobs))
    engine = Engine(port, state, device='cpu', **knobs)
    got = drive(engine)
    assert routed == [(1, 1024, 4, 16)] * 2           # the first prompt only
    assert got == want
    assert got[1]['resumed_prefills'] == 1
    assert got[1]['shared_tokens'] == 576

    seated = Engine(port, state, device='cpu', **knobs)
    seated.admit(first, max_new=4)
    row = seated.admit(second, max_new=4).row
    resumed, _ = seated._resume(second, seated.pool.slots(row), 576)
    full, _ = seated._prefill(second)
    assert (resumed - full).abs().max().item() <= NEAR_TIE
