"""Twins of ``tests/test_attention.py``'s sequence-parallel tests (``:80``,
``:91``, ``:113``, ``:124``, ``:378``, ``:413``, ``:429``, ``:478``): the
port's ring, zigzag and Ulysses attention (``tpusystem_torch/ops/ring.py``)
and GPT-2 and Llama trained with ``attention='ring'`` and ``'ulysses'``.

The port runs in one world of eight processes (``tests/torch_ranks.py``'s
``ring`` scenario, gloo on the CPU) on the reference tests' meshes, data=2
x seq=4 and seq=8, each rank on its rows and its chunk of the positions; its
chunks are held against the JAX package's single-device attention, its
outputs and gradients, on the same numpy inputs, at the reference tests'
tolerances. The flash inner kernel runs as its plain version on the CPU.
The GPT-2 and Llama losses are held against the reference's dense model's
(the Llama case has no reference twin: it adds grouped KV round the ring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusystem import train as jtrain
from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.models.llama import llama_tiny as jax_llama_tiny
from tpusystem.ops.attention import dot_product_attention, repeat_kv_heads

from tests import torch_ranks

RANKS = 8


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in shapes)


def _single(q, k, v, causal=True):
    """The reference's single-device attention and the gradients of
    ``mean(out^2)``."""
    def loss(q, k, v):
        kk, vv = repeat_kv_heads(q, k, v)
        return jnp.mean(dot_product_attention(q, kk, vv, causal=causal) ** 2)

    kk, vv = repeat_kv_heads(*(jnp.asarray(t) for t in (q, k, v)))
    out = dot_product_attention(jnp.asarray(q), kk, vv, causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(grad) for grad in grads]


def _dense_losses(module, tokens):
    optimizer = jtrain.AdamW(lr=1e-3)
    state = jtrain.init_state(module, optimizer, jnp.asarray(tokens[:1]),
                              rng=0)
    step = jtrain.build_train_step(jtrain.flax_apply(module),
                                   jtrain.NextTokenLoss(), optimizer)
    losses = []
    for _ in range(3):
        state, (_, loss) = step(state, jnp.asarray(tokens),
                                jnp.asarray(tokens))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('ring')
    qkv = _normal(7, *[(2, 128, 4, 32)] * 3)
    single = _normal(5, (2, 64, 2, 16))[0]
    gqa = _normal(17, (2, 128, 8, 16), (2, 128, 2, 16), (2, 128, 2, 16))
    tokens = np.random.default_rng(0).integers(0, 256, (4, 128)).astype(
        np.int32)
    gpt2 = jax_gpt2_tiny(attention='xla')
    llama = jax_llama_tiny(dtype='float32')
    reference = dict(
        qkv=_single(*qkv), noncausal=_single(single, single, single, False),
        gqa=_single(*gqa), gpt2=_dense_losses(gpt2, tokens),
        llama=_dense_losses(llama, tokens))
    params = {name: jax.tree.map(np.asarray, jtrain.init_state(
        module, jtrain.AdamW(lr=1e-3), jnp.asarray(tokens[:1]),
        rng=0).params) for name, module in (('gpt2', gpt2),
                                            ('llama', llama))}
    inputs = dict(scenarios=['ring'], qkv=qkv, single=single, gqa=gqa,
                  tokens=tokens, **params)
    ranks = torch_ranks.launch(root, inputs, RANKS)
    return dict(reference=reference, ranks=[rank['ring'] for rank in ranks])


def _chunk(array, rank, data=2, seq=4):
    """World rank ``rank``'s rows and positions of a ``[B, S, ...]`` array
    over data x seq (rank-major: data, then seq)."""
    rows = array.shape[0] // data
    length = array.shape[1] // seq
    d, s = divmod(rank, seq)
    return array[d * rows:(d + 1) * rows, s * length:(s + 1) * length]


def _hold(world, case, want, data=2, seq=4, atol=2e-5, grad_atol=5e-5):
    out, grads = want
    for rank, record in enumerate(world['ranks']):
        got = record[case]
        np.testing.assert_allclose(got['out'], _chunk(out, rank, data, seq),
                                   atol=atol)
        for name, grad, ref in zip('qkv', got['grads'], grads):
            assert grad.shape == _chunk(ref, rank, data, seq).shape
            np.testing.assert_allclose(grad, _chunk(ref, rank, data, seq),
                                       atol=grad_atol, err_msg=name)


@pytest.mark.parametrize('variant', ['ring', 'ulysses'])
def test_sequence_parallel_matches_single_device(world, variant):
    """Each rank's output chunk against the single-device attention."""
    out, _ = world['reference']['qkv']
    for rank, record in enumerate(world['ranks']):
        np.testing.assert_allclose(record[variant]['out'], _chunk(out, rank),
                                   atol=2e-5)


@pytest.mark.parametrize('variant', ['ring', 'ulysses'])
def test_sequence_parallel_gradients(world, variant):
    """dQ, dK and dV: a direction fault in the rotating KV's reverse shifts
    (or the all-to-all's swap) would leave dQ right and dK/dV permuted."""
    _hold(world, variant, world['reference']['qkv'])


def test_ring_noncausal(world):
    _hold(world, 'noncausal', world['reference']['noncausal'], data=1,
          seq=8)


def test_gpt2_ring_attention_long_context_trains(world):
    """GPT-2 over data=2 x seq=4 with ring (zigzag) and ulysses attention:
    three AdamW steps' losses within rtol 2e-4 of the reference's dense
    model's, and of the port's."""
    want = world['reference']['gpt2']
    for record in world['ranks']:
        for variant in ('ring', 'ulysses'):
            np.testing.assert_allclose(record[f'gpt2_{variant}'], want,
                                       rtol=2e-4)
        np.testing.assert_allclose(record['gpt2_dense'], want, rtol=2e-4)


def test_llama_ring_attention_trains(world):
    """Llama-tiny (grouped KV, rotary at the chunk's global positions) over
    data=2 x seq=4: ring and ulysses losses within rtol 2e-4 of the
    reference's dense model's."""
    want = world['reference']['llama']
    for record in world['ranks']:
        for variant in ('ring', 'ulysses'):
            np.testing.assert_allclose(record[f'llama_{variant}'], want,
                                       rtol=2e-4)


def test_zigzag_halves_ring_flops(world):
    """Per-rank attention area: the contiguous causal ring computes n whole
    chunk pairs; zigzag computes (2n + 1) stripe blocks."""
    ring, chunk = 4, 128 // 4
    stripe = chunk // 2
    for record in world['ranks']:
        zigzag = record['area_zigzag']
        assert zigzag == (2 * ring + 1) * stripe * stripe, zigzag
        assert zigzag <= 0.6 * ring * chunk * chunk


def test_ring_variant_auto_upgrades_to_zigzag(world):
    """variant='ring' with a causal, stripeable length runs the zigzag
    form (the spy saw it for both the forced and the upgraded call)."""
    for record in world['ranks']:
        assert record['upgraded'] == 2
        assert record['area_ring'] == record['area_zigzag']


@pytest.mark.parametrize('variant', ['ring', 'ulysses'])
def test_ring_gqa_keeps_kv_grouped(world, variant):
    """Grouped KV travels the ring at its own head count (2), output and
    gradients within the reference's tolerances of the broadcast
    reference; ulysses broadcasts it first."""
    _hold(world, f'gqa_{variant}', world['reference']['gqa'])
    for record in world['ranks']:
        if variant == 'ring':
            assert record['gqa_ring']['rotated'] == [2]


def test_ring_einsum_inner_fallback_matches(world):
    out, _ = world['reference']['qkv']
    for rank, record in enumerate(world['ranks']):
        np.testing.assert_allclose(record['einsum']['out'], _chunk(out, rank),
                                   atol=2e-5)
