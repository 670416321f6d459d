"""The port's ``scan_layers`` / ``scan_unit`` against the reference's.

Twins of ``tests/test_models.py``'s scan tests (GPT-2 and Llama, MoE spans,
``scan_unit`` groups, the ``ValueError`` s), of
``tests/test_generate.py``'s scanned ``generate`` and speculative decoding
on a scanned target (token-exact), and of ``tests/test_decode_fused.py``'s
refusal. The reference's stacked param tree (``hs`` / ``blocks`` with a
leading layer or span dimension) crosses by ``params_from_jax`` name for
name; logits are held to the reference's scanned model and to the port's
unrolled model within 1e-5 in float32 on the CPU. Training: a scanned
model's guarded AdamW steps (clipped) equal the unrolled model's bit for
bit, with and without ``remat``, and the reference's scanned steps within
1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import models as jmodels
from tpusystem import train as jtrain
from tpusystem_torch import models as tmodels
from tpusystem_torch import train as ttrain
from tpusystem_torch.convert import params_from_jax

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stack(params, prefix, layers, key, unit=1):
    """The reference's stacked tree from an unrolled one: span ``i`` holds
    layers ``unit*i .. unit*i + unit - 1`` (``d_{j}`` / ``moe_{j}`` when
    ``unit > 1``)."""
    def name(j, moe):
        return f'moe_{j}' if moe else f'd_{j}'
    if unit == 1:
        spans = [params[f'{prefix}{i}'] for i in range(layers)]
    else:
        spans = [{name(j, 'moe' in params[f'{prefix}{unit * i + j}']):
                  params[f'{prefix}{unit * i + j}'] for j in range(unit)}
                 for i in range(layers // unit)]
    rest = {k: v for k, v in params.items() if not k.startswith(prefix)}
    rest[key] = jax.tree.map(lambda *leaves: jnp.stack(leaves), *spans)
    return rest


def build(family, **kwargs):
    if family == 'gpt2':
        return (jmodels.gpt2_tiny(dtype='float32', **kwargs),
                tmodels.gpt2_tiny(dtype='float32', device='cpu', **kwargs),
                'h_', 'hs')
    return (jmodels.llama_tiny(dtype='float32', **kwargs),
            tmodels.llama_tiny(dtype='float32', device='cpu', **kwargs),
            'layer_', 'blocks')


def loaded(module, params):
    converted = params_from_jax(params)
    assert sorted(name for name, _ in module.named_parameters()) == sorted(
        converted)
    module.load_state_dict(converted, strict=True)
    return module


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize('family, unit', [('gpt2', 1), ('llama', 1),
                                          ('gpt2', 2), ('llama', 2)])
def test_scan_layers_matches_unrolled_and_the_reference(family, unit):
    """``test_gpt2_scan_layers_matches_unrolled``,
    ``test_llama_scan_layers_matches_unrolled`` and
    ``test_scan_unit_groups_match_unrolled``: the same logits from the
    reference's scanned model, the port's scanned model on the stacked
    tree, and the port's unrolled model."""
    reference, port, prefix, key = build(family, layers=4)
    scanned_ref, scanned, _, _ = build(family, layers=4, scan_layers=True,
                                       scan_unit=unit)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 32))
    params = reference.init(jax.random.PRNGKey(0),
                            jnp.asarray(tokens))['params']
    stacked = stack(params, prefix, 4, key, unit)
    fresh = scanned_ref.init(jax.random.PRNGKey(0),
                             jnp.asarray(tokens))['params']
    assert jax.tree.structure(fresh) == jax.tree.structure(stacked)
    want = scanned_ref.apply({'params': stacked}, jnp.asarray(tokens))
    got = loaded(scanned, stacked)(torch.from_numpy(tokens))
    close(got, want)
    close(loaded(port, params)(torch.from_numpy(tokens)), want)


@pytest.mark.parametrize('unit', [1, 4])
def test_gpt2_scanned_moe_spans_match_unrolled(unit):
    """``test_gpt2_scan_layers_moe_matches_unrolled`` and
    ``test_gpt2_scanned_moe_with_scan_unit_matches_unrolled``: spans of
    ``d_{j}`` and ``moe_{j}`` blocks, logits and the router loss."""
    config = dict(vocab_size=64, layers=4, dim=32, heads=4, max_seq=32,
                  dropout=0.0, dtype='float32', moe_experts=4, moe_every=2)
    tokens = np.random.default_rng(9).integers(0, 64, (2, 16))
    unrolled = jmodels.GPT2(**config)
    scanned_ref = jmodels.GPT2(**config, scan_layers=True, scan_unit=unit)
    params = unrolled.init(jax.random.PRNGKey(0),
                           jnp.asarray(tokens))['params']
    stacked = stack(params, 'h_', 4, 'hs', unit if unit > 1 else 2)
    want, want_aux = scanned_ref.apply({'params': stacked},
                                       jnp.asarray(tokens))
    port = tmodels.GPT2(**config, scan_layers=True, scan_unit=unit,
                        device='cpu')
    got, aux = loaded(port, stacked)(torch.from_numpy(tokens))
    close(got, want)
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))
    unrolled_port = loaded(tmodels.GPT2(**config, device='cpu'), params)
    got, aux = unrolled_port(torch.from_numpy(tokens))
    close(got, want)


def test_scan_refusals_are_the_references():
    """``test_gpt2_scan_layers_moe_needs_divisible_layers`` and the dense
    ``scan_unit`` check: the reference's ``ValueError`` s."""
    base = dict(vocab_size=64, dim=32, heads=4, max_seq=32, moe_experts=4,
                moe_every=2, scan_layers=True, device='cpu')
    with pytest.raises(ValueError, match='divisible by the span'):
        tmodels.GPT2(layers=3, **base)
    with pytest.raises(ValueError, match='multiple of moe_every'):
        tmodels.GPT2(layers=4, scan_unit=3, **base)
    with pytest.raises(ValueError, match='must divide layers'):
        tmodels.gpt2_tiny(layers=4, scan_layers=True, scan_unit=3,
                          device='cpu')
    with pytest.raises(ValueError, match='must divide layers'):
        tmodels.llama_tiny(layers=4, scan_layers=True, scan_unit=3,
                           device='cpu')


@pytest.mark.parametrize('family', ['gpt2', 'llama'])
def test_generate_on_scanned_model_matches_the_reference(family):
    """``test_generate_on_scanned_model_matches_unrolled``: the stacked
    caches ride each layer's slice; greedy tokens equal the reference's
    scanned ``generate`` and the unrolled one's."""
    reference, _, prefix, key = build(family, layers=4)
    scanned_ref, scanned, _, _ = build(family, layers=4, scan_layers=True)
    prompt = np.random.default_rng(11).integers(0, 256, (2, 8))
    params = reference.init(jax.random.PRNGKey(3),
                            jnp.asarray(prompt))['params']
    stacked = stack(params, prefix, 4, key)
    want = np.asarray(jtrain.generate(reference, params, jnp.asarray(prompt),
                                      steps=6))
    np.testing.assert_array_equal(np.asarray(jtrain.generate(
        scanned_ref, stacked, jnp.asarray(prompt), steps=6)), want)
    got = ttrain.generate(scanned, params_from_jax(stacked),
                          torch.from_numpy(prompt), steps=6, device='cpu')
    np.testing.assert_array_equal(got.numpy(), want)
    cache = scanned.replace(decode=True)(torch.from_numpy(prompt))[1]
    assert cache[f'{key}/attn/key'].shape[:2] == (4, 2)


def test_speculative_decode_on_scanned_target():
    """``test_speculative_decode_on_scanned_target``: per-row cursors at a
    leading layer dimension rewind together; the output is exactly the
    reference's greedy decode of the target."""
    target_ref = jmodels.gpt2_tiny(dtype='float32', max_seq=128, layers=4,
                                   scan_layers=True)
    draft_ref = jmodels.gpt2_tiny(dtype='float32', layers=1, dim=32,
                                  heads=2, max_seq=128)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 8))
    params = target_ref.init(jax.random.PRNGKey(5),
                             jnp.asarray(tokens))['params']
    draft_params = draft_ref.init(jax.random.PRNGKey(6),
                                  jnp.asarray(tokens))['params']
    want = np.asarray(jtrain.generate(target_ref, params, jnp.asarray(tokens),
                                      steps=16))
    target = tmodels.gpt2_tiny(dtype='float32', max_seq=128, layers=4,
                               scan_layers=True, device='cpu')
    draft = tmodels.gpt2_tiny(dtype='float32', layers=1, dim=32, heads=2,
                              max_seq=128, device='cpu')
    got = ttrain.speculative_generate(
        target, params_from_jax(params), torch.from_numpy(tokens), steps=16,
        draft_module=draft, draft_params=params_from_jax(draft_params),
        speculate=3, device='cpu')
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_decode_and_the_engine_refuse_scan_layers():
    """``test_decode_fused.py``'s refusal: the fused gates and the serving
    engine keep the reference's ``scan_layers`` reasons."""
    from tpusystem_torch.serve import Engine
    from tpusystem_torch.train.decode_fused import fused_unsupported_reason
    scanned = tmodels.gpt2_tiny(dtype='float32', scan_layers=True,
                                device='cpu')
    assert 'scan_layers' in fused_unsupported_reason(
        scanned.replace(decode=True))
    with pytest.raises(ValueError, match='scan_layers'):
        Engine(scanned, None, device='cpu')


def restacked(flat: dict, layers: int) -> dict:
    """The port's unrolled state dict restacked under ``hs``."""
    out = {k: v for k, v in flat.items() if not k.startswith('h_')}
    names = sorted({k.split('.', 1)[1] for k in flat if k.startswith('h_')})
    for name in names:
        out['hs.' + name] = torch.stack([flat[f'h_{i}.{name}']
                                         for i in range(layers)])
    return out


def train(module, steps, tokens):
    optimizer = ttrain.AdamW(lr=3e-4, grad_clip=1.0)
    guard = ttrain.Guard(warmup=1)
    state = guard.arm(ttrain.init_state(module, optimizer))
    step = ttrain.build_train_step(ttrain.module_apply(module),
                                   ttrain.NextTokenLoss(), optimizer,
                                   guard=guard)
    losses, rows = [], []
    for _ in range(steps):
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(float(loss))
        rows.append(state.health.last.clone())
    return losses, torch.stack(rows), module.state_dict()


def test_scanned_training_equals_unrolled_bitwise():
    """Guarded, clipped AdamW steps: the scanned model's losses, health
    rows and parameters equal the unrolled model's bit for bit (the global
    norm counts a stacked leaf as its layer slices, in layer order), with
    ``remat`` too."""
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256,
                                                                (4, 33)))
    unrolled = tmodels.gpt2_tiny(layers=3, device='cpu', attention='flash')
    weights = restacked({name: tensor.clone() for name, tensor
                         in unrolled.state_dict().items()}, 3)
    want = train(unrolled, 3, tokens)
    for remat in (False, True):
        scanned = tmodels.gpt2_tiny(layers=3, device='cpu',
                                    attention='flash', scan_layers=True,
                                    remat=remat)
        scanned.load_state_dict(weights)
        losses, rows, params = train(scanned, 3, tokens)
        assert losses == want[0]
        assert torch.equal(rows, want[1])
        for name, tensor in restacked(want[2], 3).items():
            assert torch.equal(params[name], tensor), name


def test_scanned_training_matches_the_reference():
    """Three AdamW steps of a scanned ``gpt2_tiny`` in both packages from
    the same stacked weights: losses within 1e-5, as
    ``tests/test_torch_train.py`` holds the unrolled model (parameters are
    not compared: the key biases' gradients are float32 noise, which Adam
    turns into lr-sized steps, ROADMAP queue 3's AdamW trap)."""
    reference = jmodels.gpt2_tiny(layers=2, dtype='float32',
                                  scan_layers=True)
    tokens = np.random.default_rng(4).integers(0, 256, (4, 17))
    optimizer = jtrain.AdamW(lr=1e-3)
    state = jtrain.init_state(reference, optimizer,
                              jnp.asarray(tokens[:, :-1]), rng=0)
    step = jtrain.build_train_step(jtrain.flax_apply(reference),
                                   jtrain.NextTokenLoss(), optimizer)
    port = loaded(tmodels.gpt2_tiny(layers=2, dtype='float32',
                                    scan_layers=True, device='cpu'),
                  state.params)
    port_optimizer = ttrain.AdamW(lr=1e-3)
    port_state = ttrain.init_state(port, port_optimizer, rng=0)
    port_step = ttrain.build_train_step(ttrain.module_apply(port),
                                        ttrain.NextTokenLoss(),
                                        port_optimizer)
    for _ in range(3):
        state, (_, want) = step(state, jnp.asarray(tokens),
                                jnp.asarray(tokens))
        port_state, (_, got) = port_step(port_state,
                                         torch.from_numpy(tokens),
                                         torch.from_numpy(tokens))
        assert abs(float(got) - float(want)) <= TOL


def test_scanned_dropout_training_is_refused():
    scanned = tmodels.gpt2_tiny(scan_layers=True, dropout=0.1, device='cpu')
    with pytest.raises(NotImplementedError, match='7. Train-step'):
        scanned(torch.zeros((1, 8), dtype=torch.long), train=True,
                rng=(0, 1))
