"""The port's sampler against jax's and the JAX package's.

The threefry port draws jax's bits (``tests/test_torch_threefry.py``); here
the sampler on top of them: the uniforms of jax's gumbel bitwise, the gumbel
values to the ulps two ``log`` implementations allow, ``categorical``
equal, and ``sample_token`` and ``generate(temperature > 0)`` equal to the
reference's on the CPU.

Two traps of float parity, each accounted for rather than hidden:

* XLA's CPU ``log`` is its own polynomial, not glibc's or PyTorch's: each is
  within an ulp, so ``-log(u)`` may differ by one ulp, and the outer
  ``log`` of a value near 1 turns that into an absolute error of an ulp of 1
  on a gumbel near 0. The bound is two ulps of ``max(|g|, 1)``.
* XLA's CPU ``cumsum`` may add in another order than ``torch.cumsum``, and
  its softmax sums in another order too, so ``mass_before`` may differ in its
  last bits: a token whose ``mass_before`` lies within ``CUT_TOL`` of
  ``top_p`` may be kept by one and cut by the other (at ``top_p = 1`` the
  tail of tokens of probability ~1e-7, whose ``mass_before`` rounds to either
  side of 1). Every such case is shown to lie within that tolerance and
  counted; every other case must give the same token. A cut of a masked
  token changes nothing (its logit is ``-inf`` either way), so only cuts of
  finite logits count.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.train import generate as jax_generate
from tpusystem.train.generate import sample_token as jax_sample_token
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.ops import threefry
from tpusystem_torch.ops.cuda import threefry as tf
from tpusystem_torch.train import generate
from tpusystem_torch.train.generate import (_nucleus, sample_rows,
                                            sample_token, sampling_key)

TINY = np.finfo(np.float32).tiny
CUT_TOL = 1e-5          # |mass_before - top_p| of a cut that differs
GRID = list(itertools.product((0.0, 0.7, 1.3), (0, 1, 5), (1.0, 0.9, 0.5),
                              (False, True)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_jax_draws_low_mode_gumbel_by_default():
    """The port follows ``mode='low'``, jax's default; a change of that
    default shows here."""
    assert jax.config.jax_high_dynamic_range_gumbel is False


@pytest.mark.parametrize('shape', [(7,), (3, 50), (50257,)])
def test_gumbel_uniforms_are_bitwise_jax(shape):
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, shape, minval=TINY,
                                             maxval=1.0))
        got = threefry.uniform(threefry.as_key(key), shape, threefry.TINY,
                               1.0).numpy()
        assert got.tobytes() == want.tobytes()


def test_gumbel_values_within_two_ulps():
    for seed in range(16):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.gumbel(key, (50257,)))
        got = threefry.gumbel(threefry.as_key(key), (50257,)).numpy()
        bound = 2 * np.spacing(np.maximum(np.abs(want), np.float32(1)))
        assert (np.abs(got - want) <= bound).all(), seed


@pytest.mark.parametrize('vocab', [256, 50257])
def test_categorical_equals_jax(vocab):
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        logits = (np.random.default_rng(seed).normal(size=(2, vocab))
                  * 3).astype(np.float32)
        want = np.asarray(jax.random.categorical(key, logits))
        got = threefry.categorical(threefry.as_key(key),
                                   torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        want = int(jax.random.categorical(key, logits[0]))
        assert int(threefry.categorical(threefry.as_key(key),
                                        torch.from_numpy(logits[0]))) == want


@pytest.mark.parametrize('cols', [256, 1000])
def test_row_uniforms_plain_is_each_rows_uniform(cols):
    """Per-row keys give each row ``uniform(key_r, (cols,))``; one key
    repeated with ``stride == cols`` gives ``uniform(key, (rows, cols))``:
    both bitwise jax's."""
    keys = [sampling_key(seed, position)
            for seed, position in ((0, 0), (3, 1), (2 ** 32 - 1, 7),
                                   (11, 2 ** 31 + 5))]
    before = tf.row_uniforms_plain.runs
    got = tf.row_uniforms(threefry.key_tensor(keys), cols).numpy()
    assert tf.row_uniforms_plain.runs == before + 1
    for row, key in enumerate(keys):
        want = np.asarray(jax.random.uniform(
            jnp.asarray(key, jnp.uint32), (cols,), minval=TINY, maxval=1.0))
        assert got[row].tobytes() == want.tobytes()
    key = keys[2]
    got = tf.row_uniforms(threefry.key_tensor([key] * 3), cols, stride=cols)
    want = np.asarray(jax.random.uniform(jnp.asarray(key, jnp.uint32),
                                         (3, cols), minval=TINY, maxval=1.0))
    assert got.numpy().tobytes() == want.tobytes()


def test_sampling_key_is_fold_in_of_the_seed():
    for seed, position in ((0, 0), (7, 3), (2 ** 32 + 5, 100)):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), position)
        assert sampling_key(seed, position) == tuple(
            int(word) for word in np.asarray(want))


def _reference_cut(logits, temperature, top_k, top_p, mask):
    """The reference's order, keep and mass_before (``generate.py:179-191``,
    its lines in jnp) for the accounting of differing cuts."""
    logits = jnp.where(mask, jnp.asarray(logits), -jnp.inf)
    scaled = logits / jnp.maximum(jnp.float32(temperature), 1e-6)
    order = jnp.argsort(-scaled)
    ranked = jnp.take(scaled, order)
    rank = jnp.arange(logits.shape[-1])
    keep = jnp.where(top_k > 0, rank < top_k, True)
    probs = jax.nn.softmax(ranked)
    mass_before = jnp.cumsum(probs) - probs
    keep = keep & (mass_before < top_p)
    return np.asarray(order), np.asarray(keep), np.asarray(mass_before)


def _rows(count: int, vocab: int = 256):
    for trial in range(count):
        rng = np.random.default_rng(trial)
        logits = (rng.normal(size=vocab) * 2).astype(np.float32)
        if trial % 3 == 0:          # ties: the stable order decides
            logits = np.round(logits)
        mask = np.ones(vocab, bool)
        mask[rng.integers(0, vocab, vocab // 2)] = False
        yield trial, logits, mask


def test_sample_token_equals_the_reference_over_the_grid():
    reference = jax.jit(jax_sample_token)
    cases = boundary = moved = 0
    for (trial, logits, some), (temperature, top_k, top_p, masked) in \
            itertools.product(list(_rows(12)), GRID):
        mask = some if masked else np.ones_like(some)
        seed, position = 7 * trial + 1, trial + 3
        want = int(reference(jnp.asarray(logits), jnp.uint32(seed),
                             jnp.int32(position), jnp.float32(temperature),
                             jnp.int32(top_k), jnp.float32(top_p),
                             jnp.asarray(mask)))
        got = int(sample_token(torch.from_numpy(logits), seed, position,
                               temperature, top_k, top_p,
                               torch.from_numpy(mask)))
        cases += 1
        order, keep, _ = _reference_cut(logits, temperature, top_k, top_p,
                                        mask)
        scaled = torch.where(torch.from_numpy(mask), torch.from_numpy(logits),
                             -np.inf) / max(temperature, 1e-6)
        _, port_order, port_keep, mass_before = _nucleus(
            scaled[None], torch.tensor([top_k]), torch.tensor([top_p]))
        np.testing.assert_array_equal(port_order[0].numpy(), order)
        differs = ((port_keep[0].numpy() != keep)
                   & np.isfinite(scaled.numpy()[order]))
        if differs.any() and temperature > 0:
            near = np.abs(mass_before[0].numpy()[differs] - top_p)
            assert (near <= CUT_TOL).all(), (trial, top_p, near)
            boundary += 1
            moved += got != want
            continue
        assert got == want, (trial, temperature, top_k, top_p, masked)
    # the cases whose cut differs, every one at top_p's boundary, and of
    # them those whose token moved; the rest of the grid gave equal tokens
    assert moved <= boundary <= cases // 10, (moved, boundary, cases)


def test_temperature_zero_and_top_k_one_are_the_argmax():
    for trial, logits, mask in _rows(20):
        masked = np.where(mask, logits, -np.inf)
        want = int(np.argmax(masked))
        for temperature, top_k in ((0.0, 0), (0.0, 5), (1.7, 1), (0.3, 1)):
            got = sample_token(torch.from_numpy(logits), trial, 0,
                               temperature, top_k, 0.9,
                               torch.from_numpy(mask))
            assert int(got) == want


def test_sample_rows_equals_sample_token_row_by_row():
    """The engine's batched step samples each row as ``sample_token`` would
    alone: its neighbours' logits and parameters do not reach it."""
    rows = list(_rows(6))
    logits = torch.from_numpy(np.stack([row[1] for row in rows]))
    mask = torch.from_numpy(np.stack([row[2] for row in rows]))
    temperature = torch.tensor([0.0, 0.7, 1.3, 0.9, 0.0, 2.0])
    top_k = torch.tensor([0, 5, 0, 1, 3, 40])
    top_p = torch.tensor([1.0, 0.9, 0.5, 1.0, 0.8, 0.95])
    seeds, positions = [3, 1, 4, 1, 5, 9], [0, 2, 6, 5, 3, 5]
    keys = threefry.key_tensor([sampling_key(seed, position) for seed,
                                position in zip(seeds, positions)])
    got = sample_rows(logits, keys, temperature, top_k, top_p, mask)
    for row in range(6):
        want = sample_token(logits[row], seeds[row], positions[row],
                            float(temperature[row]), int(top_k[row]),
                            float(top_p[row]), mask[row])
        assert int(got[row]) == int(want)


@pytest.fixture(scope='module')
def served():
    reference = jax_gpt2_tiny(dtype='float32')
    params = reference.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))['params']
    port = gpt2_tiny(dtype='float32', device='cpu')
    return reference, params, port, params_from_jax(params)


@pytest.mark.parametrize('decode_impl', ['flax', 'fused'])
def test_sampled_generate_equals_the_reference(served, decode_impl):
    reference, params, port, state = served
    prompt = np.random.default_rng(3).integers(0, 256, (2, 7))
    for seed in (0, 5):
        rng = jax.random.PRNGKey(seed)
        want = jax_generate(reference, params, jnp.asarray(prompt, jnp.int32),
                            steps=12, temperature=0.8, rng=rng,
                            decode_impl='flax')
        got = generate(port, state, prompt, steps=12, temperature=0.8,
                       rng=np.asarray(rng), decode_impl=decode_impl,
                       device='cpu')
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = generate(port, state, prompt, steps=12, device='cpu')
    assert not torch.equal(got, greedy)


def test_sampled_generate_needs_a_key(served):
    _, _, port, state = served
    with pytest.raises(ValueError, match='rng'):
        generate(port, state, [[1, 2]], steps=2, temperature=0.5,
                 device='cpu')
