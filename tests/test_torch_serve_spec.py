"""Speculative rows of the port's ``Engine``: twins of the speculative tests
of ``tests/test_serve.py`` and ``tests/test_serve_sampling.py``.

Each request owns ``tree_fanout`` adjacent rows of the paged pool; a step
runs ``speculate + 1`` draft steps, one module-path verify of every branch's
window, and emits the longest accepted prefix plus one token. In float32 on
the CPU the streams are token for token the reference ``Engine``'s (the
same weights, carried over by ``params_from_jax``) and the port's own
``generate``. ``Scheduler`` is not ported yet (ROADMAP queue 1, item 5), so
the drills the reference runs through it are driven by ``engine.step()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.serve import Engine as JaxEngine
from tpusystem.serve import SamplingParams as JaxSamplingParams
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.serve import Engine, SamplingParams
from tpusystem_torch.train import generate

VOCAB = 256
SAMPLED = dict(seed=11, temperature=0.9, top_k=16, top_p=0.95)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def served():
    """GPT-2 tiny (float32) in both packages, and a one-layer, 32-wide draft
    of it, on the reference's init."""
    probe = jnp.zeros((1, 8), jnp.int32)
    reference = jax_gpt2_tiny(dtype='float32')
    params = reference.init(jax.random.PRNGKey(0), probe)['params']
    draft = jax_gpt2_tiny(dtype='float32', layers=1, dim=32, heads=2)
    draft_params = draft.init(jax.random.PRNGKey(9), probe)['params']
    return dict(reference=reference, params=params, draft=draft,
                draft_params=draft_params,
                port=gpt2_tiny(dtype='float32', device='cpu'),
                state=params_from_jax(params),
                port_draft=gpt2_tiny(dtype='float32', layers=1, dim=32,
                                     heads=2, device='cpu'),
                draft_state=params_from_jax(draft_params))


def greedy(served, prompt, steps):
    """The port's own ``generate``: each request's greedy stream."""
    out = generate(served['port'], served['state'], [prompt], steps=steps,
                   device='cpu')
    return [int(t) for t in out[0, len(prompt):]]


def _engines(served, draft: str, **options):
    """``(reference Engine, port Engine)`` with speculative rows drafted by
    the target itself (``'self'``) or the random draft."""
    if draft == 'self':
        jax_draft = dict(draft_module=served['reference'],
                         draft_params=served['params'])
        port_draft = dict(draft_module=served['port'],
                          draft_params=served['state'])
    else:
        jax_draft = dict(draft_module=served['draft'],
                         draft_params=served['draft_params'])
        port_draft = dict(draft_module=served['port_draft'],
                          draft_params=served['draft_state'])
    return (JaxEngine(served['reference'], served['params'], **jax_draft,
                      **options),
            Engine(served['port'], served['state'], **port_draft,
                   device='cpu', **options))


def drive(engine, requests, sampling_cls=None):
    """Serve ``requests`` (``(prompt, max_new, sampling spec, stop)``)
    admitting in order as rows free: each request's tokens and reason, the
    step count, and the pool's audit after every eviction."""
    queue, rows, done, steps, audits = list(range(len(requests))), {}, {}, 0, []
    while queue or engine.active_rows:
        while queue and engine.free_rows:
            index = queue.pop(0)
            prompt, max_new, spec, stop = requests[index]
            sampling = None if spec is None else sampling_cls(**spec)
            admission = engine.admit(prompt, max_new, stop_token=stop,
                                     sampling=sampling)
            if admission.finished:
                done[index] = (admission.reason, [admission.token])
            else:
                rows[admission.row] = index
        report = engine.step()
        steps += 1
        for row, reason, tokens in report.finished:
            done[rows.pop(row)] = (reason, tokens)
            audits.append(engine.pool.audit())
    return [done[index] for index in range(len(requests))], steps, audits


@pytest.mark.parametrize('fanout', [1, 2])
@pytest.mark.parametrize('draft', ['self', 'random'])
def test_speculative_rows_match_target_greedy(served, fanout, draft):
    """``test_serve.py:767``: speculative rows (the self-draft and a random
    draft, at fanout 1 and 2) emit exactly the reference engine's streams
    and the port's greedy ``generate``; the self-draft takes fewer steps
    than tokens; the pool's audit is clean after every eviction and every
    block is free at the end."""
    rng = np.random.default_rng(67)
    requests = [([int(t) for t in rng.integers(0, VOCAB, (k,))], 8, None,
                  None) for k in (7, 5, 9)]
    want_engine, port = _engines(served, draft, rows=4, block_size=4,
                                 speculate=3, tree_fanout=fanout)
    want, _, _ = drive(want_engine, requests)
    got, steps, audits = drive(port, requests)
    assert got == want
    for (reason, tokens), (prompt, max_new, _, _) in zip(got, requests):
        assert reason == 'length'
        assert tokens == greedy(served, prompt, max_new)
    if draft == 'self':
        assert steps < 8
        assert port.speculation['accepted'] == 3 * port.speculation['groups']
    assert len(audits) == 3
    assert port.pool.audit() == {'free': port.pool.blocks - 1, 'cached': 0,
                                 'live': 0}
    assert port.decode_impl == 'flax'


def test_speculative_validates_budget_and_stop_token(served):
    """``test_serve.py:813``: an admission whose draft chain would overrun
    the draft's ``max_seq`` is refused; a stop token inside a verify window
    truncates the stream at it."""
    _, engine = _engines(served, 'self', rows=2, block_size=8, speculate=3)
    rng = np.random.default_rng(73)
    with pytest.raises(ValueError, match='speculate'):
        # 8 + 117 + 3 + 1 > 128: the draft chain would overrun max_seq
        engine.admit(list(rng.integers(0, VOCAB, (8,))), max_new=117)
    assert engine.free_rows == 2
    prompt = [int(t) for t in rng.integers(0, VOCAB, (7,))]
    expected = greedy(served, prompt, 12)
    stop = expected[3]
    [(reason, tokens)], steps, _ = drive(engine, [(prompt, 12, None, stop)])
    assert reason == 'stop'
    assert tokens == expected[:expected.index(stop) + 1]
    assert steps < len(tokens)


def test_speculative_rows_validate_their_options(served):
    """The reference's checks at construction: ``speculate`` and
    ``tree_fanout`` at least 1, the fanout within the draft's vocabulary
    and dividing ``rows``, and no fused step."""
    port, state = served['port'], served['state']
    for options, match in (({'speculate': 0}, 'speculate'),
                           ({'tree_fanout': 0}, 'tree_fanout'),
                           ({'tree_fanout': VOCAB + 1, 'rows': VOCAB + 1},
                            'vocab'),
                           ({'tree_fanout': 3, 'rows': 4}, 'multiple'),
                           ({'decode_impl': 'fused'}, 'speculative')):
        with pytest.raises(ValueError, match=match):
            Engine(port, state, draft_module=port, device='cpu',
                   **{'rows': 4, **options})
    engine = Engine(port, state, rows=4, draft_module=port, tree_fanout=2,
                    device='cpu')
    assert engine.free_rows == 2 and engine.decode_impl == 'flax'


def test_grammar_mask_dead_end_and_spec_composition_refused(served):
    """``test_serve_sampling.py:207``: a dead-end grammar is refused on the
    plain engine; on speculative rows any ``mask_fn`` is refused before a
    row is seated."""
    port, state = served['port'], served['state']
    engine = Engine(port, state, rows=1, block_size=8, device='cpu')
    with pytest.raises(ValueError, match='mask'):
        engine.admit([1, 2, 3], 4, sampling=SamplingParams(
            mask_fn=lambda emitted: np.zeros(VOCAB, bool)))
    spec = Engine(port, state, rows=2, block_size=8, draft_module=port,
                  speculate=2, device='cpu')
    with pytest.raises(ValueError, match='speculative'):
        spec.admit([1, 2, 3], 4, sampling=SamplingParams(
            mask_fn=lambda emitted: np.ones(VOCAB, bool)))
    assert spec.free_rows == 2


def sampled_stream(served, prompt, steps):
    """One sampled request on the plain port engine, uninterrupted."""
    engine = Engine(served['port'], served['state'], rows=2, block_size=8,
                    device='cpu')
    [(_, tokens)], _, _ = drive(engine, [(prompt, steps, SAMPLED, None)],
                                SamplingParams)
    return tokens


def test_speculative_sampled_matches_plain_and_stops_in_window(served):
    """``test_serve_sampling.py:390``: each window slot samples at its own
    ``(seed, position + j)``, so the speculative stream is bitwise the
    sequential sampled one, with a stop token inside a window truncated at
    its first hit."""
    prompt = list(np.random.default_rng(37).integers(0, VOCAB, (6,)))
    ref = sampled_stream(served, prompt, 10)
    spec = Engine(served['port'], served['state'], rows=2, block_size=8,
                  draft_module=served['port'], speculate=3, device='cpu')
    stop = ref[4]
    (full, stopped), _, _ = drive(spec, [(prompt, 10, SAMPLED, None),
                                         (prompt, 10, SAMPLED, stop)],
                                  SamplingParams)
    assert full == ('length', ref)
    assert stopped == ('stop', ref[:ref.index(stop) + 1])
    assert spec.sampled_rows == 0


@pytest.mark.parametrize('fanout', [1, 2])
def test_mixed_speculative_rows_equal_the_reference_engine(served, fanout):
    """Greedy and sampled requests on the self-draft, queued past the rows
    (``fanout`` 2 seats two groups of four rows), token for token the
    reference engine's, each sampled stream also the plain port engine's."""
    rng = np.random.default_rng(5)
    specs = [SAMPLED, None, dict(seed=3, temperature=1.3, top_p=0.8), None,
             dict(seed=4, temperature=2.0, top_k=1)]
    requests = [([int(t) for t in rng.integers(0, VOCAB, (n,))], budget,
                 spec, None)
                for n, budget, spec in zip((5, 9, 7, 6, 4), (8, 6, 9, 7, 5),
                                           specs)]
    want_engine, port = _engines(served, 'self', rows=4, block_size=8,
                                 speculate=3, tree_fanout=fanout)
    want, _, _ = drive(want_engine, requests, JaxSamplingParams)
    got, _, _ = drive(port, requests, SamplingParams)
    assert got == want
    if fanout == 1:
        prompt, max_new, spec, _ = requests[0]
        assert got[0][1] == sampled_stream(served, prompt, max_new)
