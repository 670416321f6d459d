"""Threefry-2x32 keys and draws, bit for bit ``jax.random``'s.

The port of the pieces of JAX's default PRNG that the reference's training
and dropout use, in plain PyTorch integer arithmetic: ``int64`` tensors (or
Python ints) masked to 32 bits after every add and shift, since
``torch.uint32`` lacks most operators. It follows JAX with
``jax_threefry_partitionable=True`` (the default since JAX 0.5): a draw of
shape ``s`` hashes the flat index ``i`` of every element, split into two
32-bit words ``(i >> 32, i & 0xffffffff)``, so element ``i``'s bits do not
depend on the shape around it.

A **key** is a pair of Python ints, ``(k0, k1)``, kept on the host: deriving
one (``split``, ``fold_in``, flax's path folding) never waits on the card.
Only the bits of a draw are device work; on a CUDA device the dropout mask
is one kernel (:func:`tpusystem_torch.ops.cuda.threefry.bernoulli_mask`).

Also here, :func:`make_rng`: flax's ``Module.make_rng`` key for a module
path, so the port's dropout masks are the reference's own.
"""

from __future__ import annotations

import hashlib
import math

import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA                 # Threefry's key-schedule constant
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

Key = tuple[int, int]


def _rotl(x, distance: int):
    return ((x << distance) | (x >> (32 - distance))) & MASK


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under ``key``: ints or ``int64`` tensors of values below ``2**32``.
    Returns the two output words the same way."""
    k0, k1 = key
    schedule = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + schedule[0]) & MASK
    x1 = (x1 + schedule[1]) & MASK
    for group in range(5):
        for distance in ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, distance) ^ x0
        x0 = (x0 + schedule[(group + 1) % 3]) & MASK
        x1 = (x1 + schedule[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def as_key(key) -> Key:
    """A key from a pair of 32-bit words (a tuple, a list or a ``uint32[2]``
    array such as ``jax.random.PRNGKey`` returns)."""
    k0, k1 = (int(word) for word in key)
    if not (0 <= k0 <= MASK and 0 <= k1 <= MASK):
        raise ValueError(f'a key is two 32-bit words, got {key!r}')
    return k0, k1


def PRNGKey(seed: int) -> Key:          # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` with 64-bit ints off (JAX's default):
    the seed wraps to 32 bits, and the key is ``(0, seed mod 2**32)``."""
    return 0, int(seed) & MASK


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)``: key ``i`` is the hash of counter
    ``(0, i)``."""
    return [threefry2x32(key, 0, index) for index in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``data`` taken modulo ``2**32``."""
    return threefry2x32(key, 0, int(data) & MASK)


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: the hash of each element's
    flat index, its two words xor-ed; ``int64`` values below ``2**32``."""
    shape = tuple(shape)
    index = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    bits0, bits1 = threefry2x32(key, index >> 32, index & MASK)
    return (bits0 ^ bits1).reshape(shape)


def uniform_from_bits(bits):
    """Float32 in ``[0, 1)`` from 32 random bits, as ``jax.random.uniform``
    makes it: the top 23 bits as the mantissa of a number in ``[1, 2)``,
    less 1 (exact)."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
            - 1.0)


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``. XLA fuses
    ``floats * (maxval - minval) + minval`` into one multiply-add, rounded
    once; the port takes it in float64 (the product is exact there) and
    rounds once to float32."""
    low = torch.tensor(minval, dtype=torch.float32, device=device)
    high = torch.tensor(maxval, dtype=torch.float32, device=device)
    floats = uniform_from_bits(random_bits(key, shape, device))
    scaled = (floats.double() * (high - low).double() + low.double()).float()
    return torch.maximum(low, scaled)


def bernoulli(key: Key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: True where
    the float32 uniform in ``[0, 1)`` is below ``float32(p)``."""
    floats = uniform_from_bits(random_bits(key, shape, device))
    return floats < torch.tensor(p, dtype=torch.float32, device=device)


def _reduce(higher, lower, minval: int, maxval: int):
    """``jax.random.randint``'s int32 arithmetic on two words of bits per
    value (ints or tensors): both reduced modulo the span with uint32
    wrap-around, JAX's small bias included."""
    out_of_range = maxval > INT32_MAX
    low = min(max(minval, INT32_MIN), INT32_MAX)
    high = min(max(maxval, INT32_MIN), INT32_MAX)
    span = 1 if high <= low else (high - low) & MASK
    if out_of_range and high > low:
        span = (span + 1) & MASK

    def rem(x, divisor):                  # XLA's unsigned x % 0 is x
        return x if divisor == 0 else x % divisor

    multiplier = rem(2 ** 16, span)
    multiplier = rem(multiplier * multiplier & MASK, span)
    offset = (rem(higher, span) * multiplier + rem(lower, span)) & MASK
    offset = rem(offset, span)
    return (low + offset + 2 ** 31) % 2 ** 32 - 2 ** 31     # int32 wrap


def randint(key: Key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for int
    bounds, as ``int64`` tensors holding the int32 values."""
    higher_key, lower_key = split(key)
    return _reduce(random_bits(higher_key, shape, device),
                   random_bits(lower_key, shape, device), minval, maxval)


def flash_seed(key: Key) -> int:
    """The flash kernels' dropout seed as the reference draws it
    (``flash.py:773``): ``randint(key, (1,), 0, int32 max)``, on Python
    ints (no tensor, no device)."""
    higher_key, lower_key = split(key)
    words = [threefry2x32(half, 0, 0) for half in (higher_key, lower_key)]
    higher, lower = (first ^ second for first, second in words)
    return _reduce(higher, lower, 0, INT32_MAX)


def _path_hash(path) -> int:
    """flax's ``_fold_in_static``: the first four bytes of the SHA-1 of the
    path's parts, strings as UTF-8 and ints as their shortest big-endian
    bytes, joined with no separator."""
    digest = hashlib.sha1()
    for part in path:
        if isinstance(part, str):
            digest.update(part.encode('utf-8'))
        elif isinstance(part, int):
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, 'big'))
        else:
            raise ValueError(f'a path part is a str or an int, got {part!r}')
    return int.from_bytes(digest.digest()[:4], 'big')


def make_rng(key: Key, path, count: int = 1) -> Key:
    """The key flax's ``self.make_rng(name)`` returns in the module at
    ``path`` (its names from the root, e.g. ``('h_3', 'Dropout_1')``) for
    its ``count``-th call in one apply, ``key`` being the one passed as
    ``rngs={name: key}``: the path and the count folded in at once."""
    return fold_in(key, _path_hash((*path, count)))
