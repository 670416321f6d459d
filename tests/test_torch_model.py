"""The port's GPT-2 against the JAX package's, with the same weights.

``gpt2_tiny(dtype='float32')`` is built in both packages; the JAX init's
params cross through :func:`tpusystem_torch.convert.params_from_jax`. In
float32 the two differ only by summation order: logits agree at
``rtol = atol = 1e-5``. Registry identities must agree bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.registry import gethash as jax_gethash
from tpusystem.train import cursors as jax_cursors
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import GPT2, gpt2_tiny
from tpusystem_torch.ops import threefry
from tpusystem_torch.registry import gethash
from tpusystem_torch.train import cursors

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair():
    reference = jax_gpt2_tiny(dtype='float32')
    tokens = np.random.default_rng(0).integers(0, 256, (2, 12))
    params = reference.init(jax.random.PRNGKey(0),
                            jnp.asarray(tokens, jnp.int32))['params']
    port = gpt2_tiny(dtype='float32', device='cpu')
    port.load_state_dict(params_from_jax(params))
    return reference, params, port


def test_params_cross_name_for_name(pair):
    _, params, port = pair
    converted = params_from_jax(params)
    assert set(converted) == set(port.state_dict())
    assert converted['h_0.attn.qkv.kernel'].shape == (64, 192)   # [in, out]
    halves = params_from_jax(jax.tree.map(
        lambda leaf: leaf.astype(jnp.bfloat16), params))
    kernel = halves['h_1.fc.kernel']
    assert kernel.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        kernel.float().numpy(),
        np.asarray(params['h_1']['fc']['kernel'].astype(jnp.bfloat16),
                   np.float32))


def test_forward_logits_match(pair):
    reference, params, port = pair
    tokens = np.random.default_rng(1).integers(0, 256, (2, 40))
    want = reference.apply({'params': params}, jnp.asarray(tokens, jnp.int32))
    got = port(torch.as_tensor(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_decode_prefill_then_steps_match(pair):
    reference, params, port = pair
    decoder = dataclasses.replace(reference, decode=True)
    port_decoder = port.replace(decode=True)
    prompt = np.random.default_rng(2).integers(0, 256, (2, 9))
    want, state = decoder.apply({'params': params},
                                jnp.asarray(prompt, jnp.int32),
                                mutable=['cache'])
    with torch.no_grad():
        got, cache = port_decoder(torch.as_tensor(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    token = np.array(jnp.argmax(want[:, -1], -1))
    for step in range(4):
        want, state = decoder.apply(
            {'params': params, 'cache': state['cache']},
            jnp.asarray(token[:, None], jnp.int32), mutable=['cache'])
        with torch.no_grad():
            got, cache = port_decoder(torch.as_tensor(token[:, None]), cache,
                                      depth=9 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        token = np.array(jnp.argmax(want[:, -1], -1))
    np.testing.assert_array_equal(cache['position'].numpy(), [13, 13])
    np.testing.assert_array_equal(cache['h_1/attn/index'].numpy(), [13, 13])


def test_cursor_edits_match_jax():
    """rewind / read_cursor / gather_rows on a decode cache agree with the
    reference's cursor authority, the port's cache keyed by paths."""
    rng = np.random.default_rng(4)
    key = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    index = np.array([5, 2, 7], np.int32)
    tree = {'position': jnp.asarray(index),
            'h_0': {'attn': {'key': jnp.asarray(key),
                             'index': jnp.asarray(index)}}}
    flat = {'position': torch.from_numpy(index.copy()),
            'h_0/attn/key': torch.from_numpy(key.copy()),
            'h_0/attn/index': torch.from_numpy(index.copy())}
    np.testing.assert_array_equal(cursors.read_cursor(flat).numpy(),
                                  np.asarray(jax_cursors.read_cursor(tree)))
    rows = np.array([2, 2, 0], np.int32)
    want = jax_cursors.gather_rows(
        jax_cursors.rewind(tree, jnp.asarray([1, 4, 6], jnp.int32)),
        jnp.asarray(rows))
    got = cursors.gather_rows(cursors.rewind(flat, [1, 4, 6]), rows)
    np.testing.assert_array_equal(got['h_0/attn/key'].numpy(),
                                  np.asarray(want['h_0']['attn']['key']))
    for path, leaf in (('position', want['position']),
                       ('h_0/attn/index', want['h_0']['attn']['index'])):
        assert got[path].dtype == torch.int32
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))
    assert cursors.is_cursor('h_3/attn/index') and cursors.is_cursor(
        'position') and not cursors.is_cursor('h_0/attn/key')


@pytest.mark.parametrize('overrides', [{}, {'dtype': 'float32'},
                                       {'max_seq': 512, 'layers': 3}])
def test_registry_identity_matches_bitwise(overrides):
    assert (gethash(gpt2_tiny(device='cpu', **overrides))
            == jax_gethash(jax_gpt2_tiny(**overrides)))


def test_unported_options_name_their_roadmap_item():
    """``remat``, training-time dropout, MoE decoding, ``scan_layers``,
    sequence-parallel attention (9e, which needs a mesh) and a scanned
    training forward with dropout (item 7; its masks against the
    reference's in ``tests/test_torch_scan.py``) are ported. A training
    forward with dropout needs the step's threefry key, and its masks
    follow it."""
    with pytest.raises(ValueError, match='needs a mesh'):
        gpt2_tiny(device='cpu', attention='ring')(
            torch.zeros((1, 4), dtype=torch.long))
    scanned = gpt2_tiny(device='cpu', scan_layers=True, dropout=0.1)
    tokens = torch.arange(8).reshape(1, 8)
    first, again, other = (scanned(tokens, train=True, rng=key)
                           for key in ((0, 1), (0, 1), (0, 2)))
    assert first.shape == (1, 8, 256)
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert gpt2_tiny(device='cpu', remat=True).remat
    assert gpt2_tiny(device='cpu', moe_experts=2, decode=True).decode
    module = GPT2(vocab_size=32, layers=1, dim=16, heads=2, max_seq=16,
                  dropout=0.1, device='cpu')
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match='rng'):
        module(tokens, train=True)
    assert module(tokens, train=True,
                  rng=threefry.PRNGKey(0)).shape == (1, 4, 32)
