"""Sampled and grammar-masked rows of the port's ``Engine``.

Twins of the engine-level tests of ``tests/test_serve_sampling.py`` on the
port, then the port's ``Engine`` against the JAX package's, token for token,
with sampled, greedy and masked rows under churn (float32 on the CPU, one
set of weights carried over by ``params_from_jax``). A sampled token is a
pure function of ``(seed, position)``, the logits and the emitted prefix,
so the same seeds give the same streams on any engine and after a replay.
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
from tpusystem_torch.serve import (Engine, SamplingParams, Saturated,
                                   UnseededSampling)

VOCAB = 256
SAMPLED = dict(seed=11, temperature=0.9, top_k=16, top_p=0.95)


def even_ids(emitted):
    """A grammar: even token ids only."""
    return np.arange(VOCAB) % 2 == 0


def rotating_ban(emitted):
    """A grammar that follows the stream: every 7th id from an offset the
    tokens so far choose is banned."""
    mask = np.ones(VOCAB, bool)
    mask[sum(emitted) % 7::7] = False
    return mask


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(family: str):
    if family == 'gpt2':
        reference = jax_gpt2_tiny(dtype='float32')
        port = gpt2_tiny(dtype='float32', device='cpu')
    else:
        reference = jllama.llama_tiny(dtype='float32')
        port = llama_tiny(dtype='float32', device='cpu')
    params = reference.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))['params']
    assert reference.vocab_size == VOCAB
    return reference, params, port, params_from_jax(params)


@pytest.fixture(scope='module')
def served():
    return _pair('gpt2')


def greedy_reference(reference, params, prompt, steps):
    out = jax_generate(reference, params,
                       jnp.asarray(prompt, jnp.int32)[None], steps=steps)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def run(engine, requests) -> dict:
    """Serve ``requests`` (``name: (prompt, max_new, sampling)``) in order,
    admitting as rows free: every request's tokens."""
    queue, rows, done = list(requests), {}, {}
    while queue or engine.active_rows:
        while queue and engine.free_rows:
            name = queue.pop(0)
            prompt, max_new, sampling = requests[name]
            admission = engine.admit(prompt, max_new, sampling=sampling)
            if admission.finished:
                done[name] = [admission.token]
            else:
                rows[admission.row] = name
        for row, _reason, tokens in engine.step().finished:
            done[rows.pop(row)] = tokens
    return done


def sampled_reference(port, state, prompt, steps, sampling):
    """One request on a fresh engine, uninterrupted: what every drilled
    path must reproduce bitwise."""
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    return run(engine, {'ref': (prompt, steps, sampling)})['ref']


# twins of tests/test_serve_sampling.py


def test_sampling_params_validation():
    assert not SamplingParams().sampled
    assert SamplingParams(seed=1, temperature=0.5).sampled
    with pytest.raises(ValueError, match='temperature'):
        SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError, match='top_k'):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError, match='top_p'):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError, match='top_p'):
        SamplingParams(top_p=1.5)


def test_unseeded_sampled_refused_before_seating(served):
    reference, params, port, state = served
    engine = Engine(port, state, rows=1, block_size=8, device='cpu')
    prompt = list(np.random.default_rng(2).integers(0, VOCAB, (5,)))
    with pytest.raises(UnseededSampling, match='seed'):
        engine.admit(prompt, 4, sampling=SamplingParams(temperature=0.8))
    assert isinstance(UnseededSampling('x'), ValueError)
    assert engine.free_rows == 1 and engine.pool.free_blocks == \
        engine.pool.blocks - 1
    assert run(engine, {'ok': (prompt, 4, None)})['ok'] == greedy_reference(
        reference, params, prompt, 4)


def test_sampling_churn_never_changes_greedy_rows(served):
    """A greedy row co-batched with sampled neighbours emits exactly its
    standalone greedy stream."""
    reference, params, port, state = served
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(0, VOCAB, (n,))) for n in (5, 7, 6)]
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    results = run(engine, {
        'greedy': (prompts[0], 8, None),
        's1': (prompts[1], 8, SamplingParams(**SAMPLED)),
        's2': (prompts[2], 8, SamplingParams(seed=3, temperature=1.3,
                                             top_p=0.8))})
    assert results['greedy'] == greedy_reference(reference, params,
                                                 prompts[0], 8)


def test_same_seed_is_bitwise_reproducible_across_engines(served):
    reference, params, port, state = served
    prompt = list(np.random.default_rng(7).integers(0, VOCAB, (6,)))
    first = sampled_reference(port, state, prompt, 10,
                              SamplingParams(**SAMPLED))
    again = sampled_reference(port, state, prompt, 10,
                              SamplingParams(**SAMPLED))
    other = sampled_reference(port, state, prompt, 10,
                              SamplingParams(**dict(SAMPLED, seed=12)))
    assert first == again
    assert first != other
    assert first != greedy_reference(reference, params, prompt, 10)


def test_top_k_one_matches_greedy(served):
    reference, params, port, state = served
    prompt = list(np.random.default_rng(9).integers(0, VOCAB, (5,)))
    narrowed = sampled_reference(port, state, prompt, 6, SamplingParams(
        seed=4, temperature=2.0, top_k=1))
    assert narrowed == greedy_reference(reference, params, prompt, 6)


def test_grammar_mask_constrains_sampled_and_greedy_rows(served):
    reference, params, port, state = served
    prompt = list(np.random.default_rng(13).integers(0, VOCAB, (5,)))
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    results = run(engine, {
        'sg': (prompt, 6, SamplingParams(seed=8, temperature=0.9,
                                         mask_fn=even_ids)),
        'gg': (prompt, 6, SamplingParams(mask_fn=even_ids))})
    for name in ('sg', 'gg'):
        assert all(t % 2 == 0 for t in results[name]), name
    # the structured streams actually obeyed the mask (not vacuous)
    assert any(t % 2 for t in greedy_reference(reference, params, prompt, 6))


def test_grammar_mask_dead_end_refused_and_speculation_not_ported(served):
    _, _, port, state = served
    engine = Engine(port, state, rows=1, block_size=8, device='cpu')

    def dead_end(emitted):
        return np.zeros(VOCAB, bool)

    with pytest.raises(ValueError, match='mask'):
        engine.admit([1, 2, 3], 4, sampling=SamplingParams(mask_fn=dead_end))
    assert engine.free_rows == 1
    with pytest.raises(ValueError, match='entries'):
        engine.admit([1, 2, 3], 4, sampling=SamplingParams(
            mask_fn=lambda emitted: np.ones(VOCAB + 1, bool)))
    # a grammar on speculative rows is refused at admission, as the
    # reference refuses it (test_serve_sampling.py:207)
    spec = Engine(port, state, rows=2, block_size=8, draft_module=port,
                  device='cpu')
    with pytest.raises(ValueError, match='speculative'):
        spec.admit([1, 2, 3], 4, sampling=SamplingParams(
            mask_fn=lambda emitted: np.ones(VOCAB, bool)))
    assert spec.free_rows == 2


def test_kill_mid_sample_replay_is_bitwise(served):
    """An engine serving sampled and greedy traffic is abandoned after
    three steps; a new engine readmits each request with its prompt plus
    what it had emitted (``emitted=``), and every completion equals the
    uninterrupted run's bitwise."""
    _, _, port, state = served
    rng = np.random.default_rng(17)
    prompts = [list(rng.integers(0, VOCAB, (n,))) for n in (6, 5)]
    specs = {'samp': (prompts[0], 8, SamplingParams(**SAMPLED)),
             'greedy': (prompts[1], 6, None)}
    uninterrupted = run(Engine(port, state, rows=2, block_size=8,
                               device='cpu'), specs)

    dying = Engine(port, state, rows=2, block_size=8, device='cpu')
    rows = {dying.admit(prompt, max_new, sampling=sampling).row: name
            for name, (prompt, max_new, sampling) in specs.items()}
    for _ in range(3):
        dying.step()
    journal = {name: dying.tokens(row) for row, name in rows.items()}
    assert all(len(tokens) == 4 for tokens in journal.values())

    relaunched = Engine(port, state, rows=2, block_size=8, device='cpu')
    resumed = {}
    for name, (prompt, max_new, sampling) in specs.items():
        prefix = journal[name]
        admission = relaunched.admit(prompt + prefix, max_new - len(prefix),
                                     sampling=sampling, emitted=prefix)
        resumed[admission.row] = name
    completions = {}
    while relaunched.active_rows:
        for row, _reason, tokens in relaunched.step().finished:
            name = resumed[row]
            completions[name] = journal[name] + tokens
    assert completions == uninterrupted


def test_sampled_rows_gauge_and_the_plain_argmax_step(served, monkeypatch):
    """While no seated row samples or masks, a step takes the plain argmax
    (the sampler does not run); a sampled admission turns it on and its
    eviction turns it off again."""
    _, _, port, state = served
    from tpusystem_torch.serve import engine as engine_module
    calls = []
    original = engine_module.sample_rows

    def counting(*args):
        calls.append(args[0].shape)
        return original(*args)

    monkeypatch.setattr(engine_module, 'sample_rows', counting)
    engine = Engine(port, state, rows=2, block_size=8, device='cpu')
    engine.admit([1, 2, 3], 6)
    engine.step()
    assert calls == [] and engine.sampled_rows == 0
    sampled = engine.admit([4, 5], 3, sampling=SamplingParams(**SAMPLED))
    assert engine.sampled_rows == 1
    engine.step()
    assert calls == [(2, VOCAB)]
    engine.evict(sampled.row)
    engine.step()
    assert len(calls) == 1 and engine.sampled_rows == 0


# the port's engine against the reference's


def _drive_mixed(engine, sampling_cls, prompts, budgets, specs):
    """Admit in order as rows free (one request cancelled mid-stream),
    logging every admission and step as plain data."""
    log, queue, cancelled = [], list(range(len(prompts))), False
    while queue or engine.active_rows:
        while queue and engine.free_rows:
            index = queue.pop(0)
            spec = specs[index]
            admission = engine.admit(
                prompts[index], budgets[index],
                sampling=None if spec is None else sampling_cls(**spec))
            log.append(('admit', admission.row, admission.token,
                        admission.finished, admission.reason))
        report = engine.step()
        log.append(('step', report.emitted, report.finished))
        if not cancelled and len(log) > 6 and engine.active_rows:
            row = next(row for row in range(engine.rows)
                       if row in report.emitted
                       and row not in [f[0] for f in report.finished])
            log.append(('evicted', list(engine.evict(row).tokens)))
            cancelled = True
    return log


MIXED = [dict(SAMPLED), None, dict(mask_fn=rotating_ban),
         dict(seed=3, temperature=1.3, top_p=0.8),
         dict(seed=4, temperature=2.0, top_k=1),
         dict(seed=8, temperature=0.7, mask_fn=even_ids), None]


@pytest.mark.parametrize('family', ['gpt2', 'llama'])
def test_mixed_rows_token_exact_with_jax_engine_under_churn(family):
    reference, params, port, state = _pair(family)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, (n,)) for n in (5, 9, 7, 6, 4, 8, 3)]
    budgets = [8, 6, 9, 7, 5, 6, 7]
    impl = 'fused' if family == 'gpt2' else 'flax'
    want = _drive_mixed(JaxEngine(reference, params, rows=3, block_size=8,
                                  decode_impl=impl),
                        JaxSamplingParams, prompts, budgets, MIXED)
    engine = Engine(port, state, rows=3, block_size=8, decode_impl=impl,
                    device='cpu')
    got = _drive_mixed(engine, SamplingParams, prompts, budgets, MIXED)
    assert got == want
    assert sum(entry[0] == 'step' for entry in got) >= 10
    assert engine.pool.audit() == {'free': engine.pool.blocks - 1,
                                   'cached': 0, 'live': 0}


def test_sampled_admission_saturates_like_greedy(served):
    _, _, port, state = served
    engine = Engine(port, state, rows=1, block_size=8, device='cpu')
    engine.admit([1, 2, 3], 4, sampling=SamplingParams(**SAMPLED))
    with pytest.raises(Saturated, match='free row'):
        engine.admit([1, 2, 3], 4, sampling=SamplingParams(**SAMPLED))
