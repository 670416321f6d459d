"""The port's threefry keys and draws against ``jax.random``, and its module
path keys against flax's ``make_rng``, bit for bit on the CPU.

``jax.random`` here runs with ``jax_threefry_partitionable=True`` (its
default), which the port follows. Every comparison is exact: the port
computes the same 32-bit integer arithmetic, and its float32 uniforms come
from the same bits by the same exact steps (a bounded uniform rounds one
multiply-add once, as XLA's fused one does). The dropout mask's plain
version (:func:`tpusystem_torch.ops.cuda.threefry.bernoulli_mask` on a CPU
device) is held to ``jax.random.bernoulli`` the same way.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem_torch.ops import threefry
from tpusystem_torch.ops.cuda.threefry import bernoulli_mask

SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (4, 1, 33)]


def _keys(count: int = 12):
    """``count`` (jax key, port key) pairs from numpy-drawn seeds, and keys
    with both words set (split from them)."""
    seeds = np.random.default_rng(0).integers(0, 2 ** 31 - 1, count // 2)
    pairs = []
    for seed in seeds.tolist():
        key = jax.random.PRNGKey(seed)
        pairs.append((key, threefry.PRNGKey(seed)))
        sub = jax.random.split(key)[1]
        pairs.append((sub, threefry.as_key(np.asarray(sub))))
    return pairs


def _key(jax_key):
    return threefry.as_key(np.asarray(jax_key))


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize('seed', [0, 1, 42, 2 ** 31 - 1, -1, -5])
def test_prng_key_matches_jax(seed):
    assert threefry.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))


@pytest.mark.parametrize('num', [1, 2, 3, 8])
def test_split_matches_jax(num):
    for jax_key, key in _keys():
        want = [_key(sub) for sub in jax.random.split(jax_key, num)]
        assert threefry.split(key, num) == want


@pytest.mark.parametrize('data', [0, 1, 12345, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_matches_jax(data):
    for jax_key, key in _keys():
        assert threefry.fold_in(key, data) == _key(
            jax.random.fold_in(jax_key, data))


@pytest.mark.parametrize('shape', SHAPES)
def test_random_bits_uniform_and_bernoulli_match_jax(shape):
    for jax_key, key in _keys(6):
        bits = np.asarray(jax.random.bits(jax_key, shape, jnp.uint32))
        np.testing.assert_array_equal(threefry.random_bits(key, shape).numpy(),
                                      bits.astype(np.int64))
        np.testing.assert_array_equal(
            threefry.uniform(key, shape).numpy(),
            np.asarray(jax.random.uniform(jax_key, shape)))
        np.testing.assert_array_equal(
            threefry.uniform(key, shape, -2.0, 3.0).numpy(),
            np.asarray(jax.random.uniform(jax_key, shape, minval=-2.0,
                                          maxval=3.0)))
        for p in (0.1, 0.5, 0.9):
            want = np.asarray(jax.random.bernoulli(jax_key, p, shape))
            np.testing.assert_array_equal(
                threefry.bernoulli(key, p, shape).numpy(), want)
            np.testing.assert_array_equal(
                bernoulli_mask(key, p, shape, 'cpu').numpy(), want)


@pytest.mark.parametrize('low,high', [(0, 2 ** 31 - 1), (-5, 17), (0, 256),
                                      (-2 ** 31, 2 ** 31 - 1), (3, 3),
                                      (10, 2)])
def test_randint_matches_jax(low, high):
    for jax_key, key in _keys(6):
        for shape in ((1,), (3, 5)):
            want = np.asarray(jax.random.randint(jax_key, shape, low, high))
            np.testing.assert_array_equal(
                threefry.randint(key, shape, low, high).numpy(), want)


def test_flash_seed_is_the_reference_draw():
    """``flash.py:773``: ``randint(key, (1,), 0, int32 max)``, computed on
    host ints."""
    for jax_key, key in _keys(20):
        want = jax.random.randint(jax_key, (1,), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)
        assert threefry.flash_seed(key) == int(want[0])


def test_a_large_mask_hashes_the_high_index_word():
    """Element ``i`` hashes ``(i >> 32, i & 0xffffffff)``; at indices past
    ``2**32`` the high word is 1 (the plain bits of a slice equal the
    threefry of those counters)."""
    key = threefry.PRNGKey(3)
    index = torch.tensor([2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5])
    words = threefry.threefry2x32(key, index >> 32, index & threefry.MASK)
    for offset, position in enumerate(index.tolist()):
        high, low = position >> 32, position & threefry.MASK
        assert (int(words[0][offset]), int(words[1][offset])) == \
            threefry.threefry2x32(key, high, low)


class _Leaf(nn.Module):
    """Returns its first two ``make_rng('dropout')`` keys."""

    @nn.compact
    def __call__(self, x):
        return self.make_rng('dropout'), self.make_rng('dropout')


class _Block(nn.Module):
    @nn.compact
    def __call__(self, x):
        first = nn.Dropout(0.5)(x, deterministic=False)   # Dropout_0
        del first
        return _Leaf(name='attn')(x), _Leaf()(x), self.make_rng('dropout')


class _Root(nn.Module):
    layers: int = 2
    remat: bool = False

    @nn.compact
    def __call__(self, x):
        block = nn.remat(_Block) if self.remat else _Block
        return ([block(name=f'h_{i}')(x) for i in range(self.layers)],
                _Leaf(name='Dropout_0')(x), self.make_rng('dropout'))


@pytest.mark.parametrize('remat', [False, True])
@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 - 1])
def test_make_rng_matches_flax(seed, remat):
    """Keys of ``make_rng`` at module paths and call counts: a named child
    (``h_i/attn``), an auto-named one (``h_i/_Leaf_0``), the block scope
    itself after a ``Dropout`` drew from it, the root, and under
    ``nn.remat``."""
    jax_key = jax.random.PRNGKey(seed)
    blocks, top, root = _Root(remat=remat).apply(
        {}, jnp.zeros(3), rngs={'dropout': jax_key})
    key = threefry.PRNGKey(seed)
    for index, (attn, leaf, own) in enumerate(blocks):
        name = f'h_{index}'
        for count in (1, 2):
            assert _key(attn[count - 1]) == threefry.make_rng(
                key, (name, 'attn'), count)
            assert _key(leaf[count - 1]) == threefry.make_rng(
                key, (name, '_Leaf_0'), count)
        assert _key(own) == threefry.make_rng(key, (name,), 1)
    assert _key(top[0]) == threefry.make_rng(key, ('Dropout_0',), 1)
    assert _key(root) == threefry.make_rng(key, (), 1)


def test_flax_dropout_is_bernoulli_on_its_make_rng_key():
    """``nn.Dropout`` at ``h_0/Dropout_1`` keeps ``bernoulli(make_rng key,
    1 - rate)`` and divides by ``1 - rate``: the port's ``apply_dropout``
    on the same key gives the same tensor."""
    from tpusystem_torch.ops.attention import apply_dropout

    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dropout(0.3)(x, deterministic=False)
            return nn.Dropout(0.3)(x, deterministic=False)

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Two(name='h_0')(x)

    x = np.random.default_rng(4).standard_normal((6, 40)).astype(np.float32)
    jax_key = jax.random.PRNGKey(11)
    want = np.asarray(Outer().apply({}, jnp.asarray(x),
                                    rngs={'dropout': jax_key}))
    key = threefry.PRNGKey(11)
    got = torch.from_numpy(x)
    for site in ('Dropout_0', 'Dropout_1'):
        got = apply_dropout(got, 0.3, threefry.make_rng(key, ('h_0', site)))
    np.testing.assert_array_equal(got.numpy(), want)
