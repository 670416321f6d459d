"""Speculative decoding in the port: twins of the speculative tests of
``tests/test_generate.py``.

The same weights (the reference's init, carried over by
``params_from_jax``) and prompts go through the JAX package and the port, in
float32 on the CPU, where a ``K + 1``-token verify and a one-token step
round alike, so greedy speculative output is token for token the plain
greedy decode of both packages. Sampled rows use the reference's key chain
and equal its draws for the same key; where the port's float32 ``exp``
and XLA's differ by an ulp at an accept threshold (``u * q < p``), a row
may flip: such flips are counted and bounded, not hidden (ROADMAP queue 3,
the XLA-``log`` ulp trap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.models import llama as jllama
from tpusystem.train import generate as jax_generate
from tpusystem.train import speculative_generate as jax_speculative
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny, llama_tiny
from tpusystem_torch.ops import threefry
from tpusystem_torch.train import generate, speculative_generate
from tpusystem_torch.train.generate import _rejection_sample


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _pair(jax_module, port_module, key, tokens):
    params = jax_module.init(jax.random.PRNGKey(key),
                             jnp.asarray(tokens, jnp.int32))['params']
    return params, params_from_jax(params)


@pytest.fixture(scope='module')
def gpt2_pair():
    """Target and draft of ``test_generate.py:154``: GPT-2 tiny and a
    one-layer, 32-wide draft, both float32, ``max_seq`` 128."""
    tokens = _tokens(0, (2, 8))
    target = jax_gpt2_tiny(dtype='float32', max_seq=128)
    draft = jax_gpt2_tiny(dtype='float32', layers=1, dim=32, heads=2,
                          max_seq=128)
    params, state = _pair(target, None, 0, tokens)
    draft_params, draft_state = _pair(draft, None, 9, tokens)
    port = gpt2_tiny(dtype='float32', max_seq=128, device='cpu')
    port_draft = gpt2_tiny(dtype='float32', layers=1, dim=32, heads=2,
                           max_seq=128, device='cpu')
    return dict(target=target, draft=draft, params=params,
                draft_params=draft_params, port=port, port_draft=port_draft,
                state=state, draft_state=draft_state)


def _reference(pair, tokens, steps, **options):
    return np.asarray(jax_generate(pair['target'], pair['params'],
                                   jnp.asarray(tokens, jnp.int32),
                                   steps=steps, **options))


def _speculate(pair, tokens, steps, draft='random', **options):
    module, state = ((pair['port_draft'], pair['draft_state'])
                     if draft == 'random' else (pair['port'], pair['state']))
    out = speculative_generate(pair['port'], pair['state'], tokens,
                               steps=steps, draft_module=module,
                               draft_params=state, device='cpu', **options)
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize('speculate', [1, 3, 5])
def test_speculative_decode_equals_greedy_regardless_of_draft(gpt2_pair,
                                                              speculate):
    """``test_generate.py:154``: with a random draft (near-zero acceptance)
    the output is exactly the reference's and the port's greedy decode."""
    tokens = _tokens(0, (2, 8))
    want = _reference(gpt2_pair, tokens, 24)
    np.testing.assert_array_equal(
        generate(gpt2_pair['port'], gpt2_pair['state'], tokens, steps=24,
                 device='cpu').numpy(), want)
    np.testing.assert_array_equal(
        _speculate(gpt2_pair, tokens, 24, speculate=speculate), want)


def test_speculative_self_draft_accepts_everything(gpt2_pair):
    """The perfect draft (the target drafting for itself) accepts every
    draft: 23 tokens after the first in ceil(23 / 5) rounds, still the
    greedy decode."""
    tokens = _tokens(0, (2, 8))
    out = _speculate(gpt2_pair, tokens, 24, draft='self', speculate=4)
    np.testing.assert_array_equal(out, _reference(gpt2_pair, tokens, 24))
    assert speculative_generate.rounds == 5


def test_speculative_decode_validates_capacity_and_args():
    """``test_generate.py:181``: the capacity counts the verify's overshoot
    (``prompt + steps + speculate + 1``), and ``speculate`` must be at
    least 1."""
    target = gpt2_tiny(dtype='float32', max_seq=32, device='cpu')
    tokens = np.zeros((1, 16), np.int64)
    options = dict(draft_module=target, draft_params=None, device='cpu')
    with pytest.raises(ValueError, match='capacity'):
        speculative_generate(target, None, tokens, steps=16, speculate=4,
                             **options)
    with pytest.raises(ValueError, match='speculate'):
        speculative_generate(target, None, tokens, steps=4, speculate=0,
                             **options)
    with pytest.raises(ValueError, match='steps'):
        speculative_generate(target, None, tokens, steps=0, **options)
    with pytest.raises(ValueError, match='rng'):
        speculative_generate(target, None, tokens, steps=4, speculate=2,
                             temperature=0.5, **options)


def test_tree_speculative_validates_args():
    """``test_generate.py:450``: the fanout is at least 1, greedy only, and
    at most the draft's vocabulary."""
    target = gpt2_tiny(dtype='float32', max_seq=64, device='cpu')
    tokens = np.zeros((1, 4), np.int64)
    options = dict(steps=4, draft_module=target, draft_params=None,
                   speculate=2, device='cpu')
    with pytest.raises(ValueError, match='tree_fanout'):
        speculative_generate(target, None, tokens, tree_fanout=0, **options)
    with pytest.raises(ValueError, match='greedy'):
        speculative_generate(target, None, tokens, tree_fanout=2,
                             temperature=1.0, rng=(0, 0), **options)
    with pytest.raises(ValueError, match='vocab'):
        speculative_generate(target, None, tokens, tree_fanout=1000,
                             **options)


def test_speculative_decode_llama_rotary_positions():
    """``test_generate.py:197``: the rewind restores Llama's rotary
    positions, read from each layer's per-row cursor, so a window of K + 1
    tokens rotates at each row's own positions."""
    tokens = _tokens(3, (2, 8))
    target = jllama.llama_tiny(dtype='float32', max_seq=128)
    draft = jllama.llama_tiny(dtype='float32', layers=1, ffn_dim=64,
                              max_seq=128)
    params, state = _pair(target, None, 1, tokens)
    _, draft_state = _pair(draft, None, 7, tokens)
    want = np.asarray(jax_generate(target, params,
                                   jnp.asarray(tokens, jnp.int32), steps=20))
    out = speculative_generate(
        llama_tiny(dtype='float32', max_seq=128, device='cpu'), state,
        tokens, steps=20,
        draft_module=llama_tiny(dtype='float32', layers=1, ffn_dim=64,
                                max_seq=128, device='cpu'),
        draft_params=draft_state, speculate=3, device='cpu')
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.fixture(scope='module')
def small_vocab_pair():
    """The pair of ``test_generate.py:215``: vocab 32, a 2-layer target
    and a 1-layer draft."""
    prompt = np.asarray([[3, 1, 4, 1]])
    target = jax_gpt2_tiny(dtype='float32', vocab_size=32, layers=2, dim=32,
                           heads=2, max_seq=64)
    draft = jax_gpt2_tiny(dtype='float32', vocab_size=32, layers=1, dim=16,
                          heads=2, max_seq=64)
    params, state = _pair(target, None, 0, prompt)
    draft_params, draft_state = _pair(draft, None, 5, prompt)
    return dict(target=target, draft=draft, params=params,
                draft_params=draft_params, state=state,
                draft_state=draft_state,
                port=gpt2_tiny(dtype='float32', vocab_size=32, layers=2,
                               dim=32, heads=2, max_seq=64, device='cpu'),
                port_draft=gpt2_tiny(dtype='float32', vocab_size=32,
                                     layers=1, dim=16, heads=2, max_seq=64,
                                     device='cpu'))


SAMPLED_BATCH = 4096
# rows of SAMPLED_BATCH whose sampled stream may leave the reference's where
# an accept threshold u * q < p lands within an ulp of the port's float32
# exp against XLA's (ROADMAP queue 3); the run below flips none
FLIP_BOUND = 4


def test_speculative_sampling_equals_the_reference_draws(small_vocab_pair):
    """``test_generate.py:215`` with the draws pinned: at temperature 1 the
    port's speculative stream is the reference's for the same key (the key
    chain ``split(rng, 4)`` a round, the draft's ``split(draft_rng, K +
    1)``, the accept uniforms, the ``log(residual + 1e-20)`` correction),
    row for row but for at most ``FLIP_BOUND`` rows; and its per-position
    marginals match the target's own sampling distribution within the
    reference's 0.12 total variation."""
    pair = small_vocab_pair
    prompt = np.tile([[3, 1, 4, 1]], (SAMPLED_BATCH, 1))
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax_speculative(
        pair['target'], pair['params'], jnp.asarray(prompt, jnp.int32),
        steps=3, draft_module=pair['draft'],
        draft_params=pair['draft_params'], speculate=3, temperature=1.0,
        rng=key))
    got = speculative_generate(
        pair['port'], pair['state'], prompt, steps=3,
        draft_module=pair['port_draft'], draft_params=pair['draft_state'],
        speculate=3, temperature=1.0, rng=np.asarray(key),
        device='cpu').numpy()
    flips = int((got != want).any(1).sum())
    assert flips <= FLIP_BOUND, flips
    plain = generate(pair['port'], pair['state'], prompt, steps=3,
                     temperature=1.0, rng=(0, 11), device='cpu').numpy()
    for position in range(4, 7):
        spec_hist = np.bincount(got[:, position], minlength=32) / len(got)
        ref_hist = np.bincount(plain[:, position], minlength=32) / len(got)
        assert np.abs(ref_hist - spec_hist).sum() < 0.12, position
        assert ref_hist.max() < 0.9               # the test has teeth


def _jax_rejection(vlogits, draft_logits, drafts, temperature, accept_rng,
                   fix_rng):
    """The reference's acceptance lines (``generate.py:488-514``), as they
    run inside its loop body."""
    batch, K = drafts.shape
    p_dist = jax.nn.softmax(vlogits.astype(jnp.float32) / temperature, -1)
    q_dist = jax.nn.softmax(draft_logits.astype(jnp.float32) / temperature,
                            -1)
    p_draft = jnp.take_along_axis(p_dist[:, :K], drafts[..., None], -1)[..., 0]
    q_draft = jnp.take_along_axis(q_dist, drafts[..., None], -1)[..., 0]
    uniforms = jax.random.uniform(accept_rng, (batch, K))
    accepts = (uniforms * q_draft < p_draft).astype(jnp.int32)
    accepted = jnp.sum(jnp.cumprod(accepts, axis=1), axis=1)
    p_at = jnp.take_along_axis(p_dist, accepted[:, None, None], 1)[:, 0]
    q_padded = jnp.pad(q_dist, ((0, 0), (0, 1), (0, 0)))
    q_at = jnp.take_along_axis(q_padded, accepted[:, None, None], 1)[:, 0]
    residual = jnp.maximum(p_at - q_at, 0.0)
    degenerate = jnp.sum(residual, -1, keepdims=True) < 1e-9
    residual = jnp.where(degenerate, p_at, residual)
    correction = jax.random.categorical(fix_rng, jnp.log(residual + 1e-20),
                                        axis=-1)
    return uniforms, accepted, correction


@pytest.mark.parametrize('temperature', [0.7, 1.0, 1.6])
def test_rejection_sampling_equals_the_reference_on_the_same_logits(
        temperature):
    """One round's acceptance on the same logits: the accept uniforms are
    bitwise jax's, and the accepted counts and corrections equal the
    reference's for every row but those within an ulp of a threshold
    (counted; none at these seeds). Includes rows whose drafts are the
    target's own choice (all accepted, the correction drawn from ``p``)."""
    rng = np.random.default_rng(int(temperature * 10))
    batch, K, vocab = 256, 4, 48
    vlogits = rng.normal(size=(batch, K + 1, vocab)).astype(np.float32) * 2
    draft_logits = (vlogits[:, :K] + rng.normal(
        size=(batch, K, vocab)).astype(np.float32) * 0.5)
    drafts = rng.integers(0, vocab, (batch, K))
    drafts[::4] = vlogits[::4, :K].argmax(-1)
    key = jax.random.PRNGKey(int(temperature * 100))
    _, _, accept_rng, fix_rng = jax.random.split(key, 4)
    uniforms, accepted, correction = _jax_rejection(
        jnp.asarray(vlogits), jnp.asarray(draft_logits),
        jnp.asarray(drafts), temperature, accept_rng, fix_rng)
    got_uniforms = threefry.uniform(threefry.as_key(np.asarray(accept_rng)),
                                    (batch, K))
    np.testing.assert_array_equal(got_uniforms.numpy(), np.asarray(uniforms))
    got_accepted, got_correction = _rejection_sample(
        torch.as_tensor(vlogits), torch.as_tensor(draft_logits),
        torch.as_tensor(drafts), temperature,
        threefry.as_key(np.asarray(accept_rng)),
        threefry.as_key(np.asarray(fix_rng)))
    differ = ((got_accepted.numpy() != np.asarray(accepted))
              | (got_correction.numpy() != np.asarray(correction)))
    assert int(differ.sum()) <= FLIP_BOUND, int(differ.sum())
    assert 0 < np.asarray(accepted).mean() < K


def test_speculative_sampling_is_deterministic_per_key(gpt2_pair):
    """The same key gives the same stream, another key another; every
    token lies in the vocabulary."""
    tokens = _tokens(5, (2, 8))
    first, again, other = (_speculate(gpt2_pair, tokens, 10, speculate=3,
                                      temperature=0.8, rng=key)
                           for key in ((0, 4), (0, 4), (0, 5)))
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)
    assert ((first >= 0) & (first < 256)).all()


def test_speculative_decode_on_scanned_target_names_its_item():
    """``test_generate.py:277`` runs speculation on a ``scan_layers``
    target; the port has no scanned stacks yet, and building one raises
    naming its ROADMAP item (7, scan_layers)."""
    with pytest.raises(NotImplementedError, match='queue 1: scan_layers'):
        gpt2_tiny(dtype='float32', layers=4, scan_layers=True, device='cpu')


def test_batched_speculative_matches_batch1_trajectories_row_wise(gpt2_pair):
    """``test_generate.py:399``: per-row acceptance reproduces each row's
    batch-1 trajectory, and both are the reference's greedy decode."""
    prompts = _tokens(31, (3, 8))
    batched = _speculate(gpt2_pair, prompts, 16, speculate=3)
    np.testing.assert_array_equal(batched, _reference(gpt2_pair, prompts, 16))
    for row in range(3):
        np.testing.assert_array_equal(
            batched[row:row + 1],
            _speculate(gpt2_pair, prompts[row:row + 1], 16, speculate=3))


@pytest.mark.parametrize('fanout,draft', [(2, 'random'), (3, 'random'),
                                          (2, 'self')])
def test_tree_speculative_verify_equals_greedy(gpt2_pair, fanout, draft):
    """``test_generate.py:424``: token-tree verify at fanout 2 and 3 (and
    the self-draft at 2) is exactly the reference's greedy decode."""
    tokens = _tokens(0, (2, 8))
    out = _speculate(gpt2_pair, tokens, 20, draft=draft,
                     speculate=3 if draft == 'random' else 4,
                     tree_fanout=fanout)
    np.testing.assert_array_equal(out, _reference(gpt2_pair, tokens, 20))


def test_speculative_quantized_streaming_equals_the_reference(gpt2_pair):
    """``test_generate.py:471``: ``stream_dtype='int8'`` quantizes both
    param dicts; the output is the prompt followed by the reference's int8
    greedy stream (the port's ``quantize_leaf`` is bitwise the
    reference's)."""
    tokens = _tokens(13, (2, 8))
    out = _speculate(gpt2_pair, tokens, 12, speculate=3, stream_dtype='int8')
    np.testing.assert_array_equal(out[:, :8], tokens)
    np.testing.assert_array_equal(
        out, _reference(gpt2_pair, tokens, 12, stream_dtype='int8'))
