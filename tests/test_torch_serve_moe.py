"""MoE serving through the port's module paged step: twins of
``tests/test_serve.py:739`` and ``tests/test_generate.py:80``, and the fused
steps' gates.

In decode mode an MoE block dispatches at full capacity (capacity = the
call's token count), so routing drops no token and a row's experts never
depend on its co-batched neighbours; the router loss is dropped. The same
weights (the reference's init, carried over by ``params_from_jax``) and
prompts go through the JAX package and the port in float32 on the CPU, for
``moe_sparse_impl`` ``'gather'`` and ``'fused'`` (the grouped kernels'
plain versions here), token for token. The fused decode chain is GPT-2's
dense FFN: both of its gates refuse MoE and ``scan_layers`` with the
reference's reasons, so ``decode_impl='auto'`` serves an MoE model through
the module path even on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem.models import gpt2_tiny as jax_gpt2_tiny
from tpusystem.serve import Engine as JaxEngine
from tpusystem.train import decode_fused as jax_fused
from tpusystem.train import generate as jax_generate
from tpusystem.train.generate import _decoder as jax_decoder
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.serve import Engine
from tpusystem_torch.train import decode_fused, generate
from tpusystem_torch.train.generate import _decoder, _resolve_impl

IMPLS = ('gather', 'fused')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moe_pair(impl: str, **overrides):
    config = dict(dtype='float32', moe_experts=2, moe_every=2,
                  moe_sparse_impl=impl, **overrides)
    reference = jax_gpt2_tiny(**config)
    probe = jnp.asarray(np.random.default_rng(61).integers(0, 256, (1, 8)),
                        jnp.int32)
    params = reference.init(jax.random.PRNGKey(0), probe)['params']
    return (reference, params, gpt2_tiny(device='cpu', **config),
            params_from_jax(params))


def _drive(engine, prompts, max_new):
    admissions = [engine.admit(prompt, max_new=max_new) for prompt in prompts]
    tokens = {}
    while engine.active_rows:
        for row, _reason, out in engine.step().finished:
            tokens[row] = out
    return [tokens[admission.row] for admission in admissions]


@pytest.mark.parametrize('impl', IMPLS)
def test_moe_engine_is_token_exact_under_cobatching(impl):
    """``test_serve.py:739``: three co-batched requests on an MoE module
    through the port's engine emit the reference engine's tokens and the
    port's and the reference's standalone ``generate``; the engine serves
    through the module paged step and its pool ends clean."""
    reference, params, port, state = _moe_pair(impl)
    rng = np.random.default_rng(61)
    rng.integers(0, 256, (1, 8))
    prompts = [[int(t) for t in rng.integers(0, 256, (k,))]
               for k in (7, 5, 9)]
    engine = Engine(port, state, rows=3, block_size=4, device='cpu')
    assert engine.decode_impl == 'flax'
    got = _drive(engine, prompts, 6)
    assert got == _drive(JaxEngine(reference, params, rows=3, block_size=4),
                         prompts, 6)
    for tokens, prompt in zip(got, prompts):
        want = np.asarray(jax_generate(reference, params,
                                       jnp.asarray([prompt], jnp.int32),
                                       steps=6))[0, len(prompt):]
        assert tokens == [int(t) for t in want]
        alone = generate(port, state, [prompt], steps=6, device='cpu')
        assert tokens == [int(t) for t in alone[0, len(prompt):]]
    assert engine.pool.audit() == {'free': engine.pool.blocks - 1,
                                   'cached': 0, 'live': 0}


def _full_forward_greedy(module, params, prompt, steps):
    # compiled once a length: op by op, the MoE forward took most of the
    # test's time
    forward = jax.jit(lambda params, sequence: module.apply(
        {'params': params}, sequence))
    sequence = jnp.asarray(prompt, jnp.int32)
    for _ in range(steps):
        logits, _ = forward(params, sequence)
        token = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        sequence = jnp.concatenate([sequence, token[:, None]], axis=1)
    return np.asarray(sequence)


@pytest.mark.parametrize('impl', IMPLS)
def test_moe_model_decodes_matching_full_forward(impl):
    """``test_generate.py:80``: in a no-drop configuration (k equal to the
    experts) the port's MoE decode, which drops the aux output, matches the
    reference's full re-forward exactly; the decode clone's forward returns
    ``(logits, cache)`` and its expert layers run at full capacity."""
    reference, params, port, state = _moe_pair(impl)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 7))
    cached = generate(port, state, prompt, steps=4, device='cpu')
    np.testing.assert_array_equal(
        cached.numpy(), _full_forward_greedy(reference, params, prompt, 4))
    port.load_state_dict(state)
    decoder = _decoder(port)
    assert decoder.h_1.moe.full_capacity and not port.h_1.moe.full_capacity
    with torch.no_grad():
        logits, cache = decoder(torch.as_tensor(prompt), None)
    assert logits.shape == (2, 7, 256) and isinstance(cache, dict)


def test_moe_decode_routes_independently_of_cobatched_rows():
    """A step's routing at full capacity: each row's logits equal its own
    batch-1 decode whatever its neighbours (within 1e-5 in float32: the
    products' sums may block by batch), where the training forward at the
    same configuration drops assignments."""
    _, _, port, state = _moe_pair('gather', moe_capacity_factor=0.5)
    port.load_state_dict(state)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, 256,
                                                                (4, 6)))
    decoder = _decoder(port)
    with torch.no_grad():
        batched, _ = decoder(prompts, None)
        for row in range(4):
            alone, _ = decoder(prompts[row:row + 1], None)
            torch.testing.assert_close(batched[row:row + 1], alone, rtol=0,
                                       atol=1e-5)
        # the training forward at the same capacity drops assignments
        trained, _ = port(prompts)
    assert (trained - batched).abs().max() > 1e-3


@pytest.mark.parametrize('field,value', [('moe_experts', 2),
                                         ('scan_layers', True)])
def test_fused_gates_refuse_moe_and_scan_layers_with_the_reference_reasons(
        field, value):
    """Both fused gates name MoE and ``scan_layers`` with the reference's
    reasons (``decode_fused.py:67-73,100-107``), on the decode clones the
    generate loop and the engine build."""
    port = gpt2_tiny(device='cpu', **({field: value} if field == 'moe_experts'
                                      else {}))
    if field == 'scan_layers':        # the port builds no scanned stack
        port = port.replace(scan_layers=True)
    looped = _decoder(port)
    paged = _decoder(port, per_row=True).replace(decode_pages=(9, 8))
    reference = jax_gpt2_tiny(**{field: value})
    jax_looped = jax_decoder(reference)
    jax_paged = dataclasses.replace(jax_decoder(reference, per_row=True),
                                    decode_pages=(9, 8))
    reason = decode_fused.fused_unsupported_reason(looped)
    assert reason is not None
    assert reason == jax_fused.fused_unsupported_reason(jax_looped)
    paged_reason = decode_fused.fused_paged_reason(paged)
    assert paged_reason is not None
    assert paged_reason == jax_fused.fused_paged_reason(jax_paged)


def test_auto_serves_a_bf16_moe_module_through_the_module_path():
    """The fault the gates close: on the card ``'auto'`` picks the fused
    step for a bf16 GPT-2 whenever its gate passes, and the fused chain
    would run the dense FFN on MoE blocks. With the gate, ``'auto'`` on a
    bf16 MoE module resolves to the module path even where the device is
    the card, and ``'fused'`` raises with the gate's reason (the engine's
    and ``generate``'s)."""
    moe = gpt2_tiny(moe_experts=2, moe_every=2, device='cpu')
    assert moe.compute_dtype == torch.bfloat16
    paged = _decoder(moe, per_row=True).replace(decode_pages=(9, 8))
    reason = decode_fused.fused_paged_reason(paged)
    assert 'MoE' in reason
    card = torch.device('cuda')
    assert _resolve_impl('auto', reason, paged, card) == 'flax'
    dense = gpt2_tiny(device='cpu')
    dense_paged = _decoder(dense, per_row=True).replace(decode_pages=(9, 8))
    assert _resolve_impl('auto', decode_fused.fused_paged_reason(dense_paged),
                         dense_paged, card) == 'fused'
    engine = Engine(moe, None, rows=2, block_size=8, device='cpu')
    assert engine.decode_impl == 'flax' and engine._fused is None
    with pytest.raises(ValueError, match='MoE blocks route through expert'):
        Engine(moe, None, rows=2, block_size=8, decode_impl='fused',
               device='cpu')
    with pytest.raises(ValueError, match='MoE blocks route through expert'):
        generate(moe, None, [[1, 2, 3]], steps=2, decode_impl='fused',
                 device='cpu')


def test_moe_streamed_bf16_keeps_the_router_float32():
    """``stream_dtype='bfloat16'`` casts the expert matrices but not the
    router (float32 gate logits, as the reference's caster keeps them), so
    a bf16-streamed MoE model decodes; its greedy tokens equal the
    reference's under the same streaming."""
    reference, params, port, state = _moe_pair('gather')
    prompt = np.random.default_rng(9).integers(0, 256, (2, 6))
    got = generate(port, state, prompt, steps=4, stream_dtype='bfloat16',
                   device='cpu')
    want = jax_generate(reference, params, jnp.asarray(prompt, jnp.int32),
                        steps=4, stream_dtype='bfloat16')
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
