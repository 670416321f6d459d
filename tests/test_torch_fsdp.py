"""Per-unit FSDP gathering in the port's placed steps, on gloo worlds of
port processes (``tests/torch_ranks.py`` scenario ``fsdp_units``).

``FullyShardedDataParallel`` hands a unit-aware forward each leaf it must
gather as a stand-in; each unit (the embeddings, a block or a layer slice
of the scanned stack, the final norm with the tied head; a 1F1B stage's
chunk and its replicated leaves) gathers its leaves when it is entered, and
the backward gathers them again when it reaches the unit. Each case is held
twice against a whole-gather oracle written out in ``torch_ranks.py`` (the
step as it ran before: ``gather_leaf`` over every leaf, the forward,
``torch.autograd.grad``, ``sync_grads``):

* the losses and the parameters after two AdamW steps, bit for bit;
* the high-water mark of whole gathered bytes alive at once
  (``sharding.whole_bytes``): at most the largest unit's whole bytes and a
  bf16 cast of them. The oracle's mark is over that bound, because it holds
  every gathered leaf until its backward ends: the placed step before
  per-unit gathering failed this check.

The model is ``gpt2_tiny`` at 4 layers (bf16 compute, flash attention on
its plain CPU version), every leaf of 64 elements or more split; on two
ranks also ``llama_tiny`` at 4 layers, unrolled and scanned, and the MoE
GPT-2 (4 experts every second block).
"""

from __future__ import annotations

import numpy as np
import pytest

from tests import torch_ranks

SEED = 3
TOKENS = np.random.default_rng(0).integers(0, 256, (8, 32))

TWO_RANK_CASES = ('fsdp', 'fsdp_accumulate', 'fsdp_scan', 'fsdp_remat',
                  'fsdp_eval')
FOUR_RANK_CASES = TWO_RANK_CASES + ('data_fsdp', 'data_fsdp_scan', 'tp_fsdp',
                                    '1f1b')
# Llama unrolled (two microbatches) and scanned, the MoE GPT-2 (its expert
# block a unit), and 1F1B's loop of one stage (each layer a unit)
MODEL_CASES = ('llama', 'llama_scan', 'moe', '1f1b_one_stage')
CASES = ([(2, name) for name in TWO_RANK_CASES + MODEL_CASES]
         + [(4, name) for name in FOUR_RANK_CASES])


def _world(tmp_path_factory, ranks: int) -> dict:
    root = tmp_path_factory.mktemp(f'fsdp{ranks}')
    inputs = dict(scenarios=['fsdp_units'], fsdp_seed=SEED,
                  fsdp_tokens=TOKENS)
    return torch_ranks.launch(root, inputs, ranks=ranks, timeout=300)


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    return {ranks: _world(tmp_path_factory, ranks) for ranks in (2, 4)}


def _case(worlds, ranks: int, name: str) -> list:
    return [result['fsdp_units'][name] for result in worlds[ranks]]


@pytest.mark.parametrize('ranks,name', CASES)
def test_losses_and_params_are_the_whole_gather_oracles(worlds, ranks, name):
    """Two steps gathered unit by unit equal the whole-gather oracle's bit
    for bit: the global losses and every parameter, on every rank (the
    tied ``wte``'s two uses summed before one reduce-scatter; microbatches,
    layer slices, pieces kept over ``model`` and 1F1B's chunks included)."""
    for case in _case(worlds, ranks, name):
        assert case['losses']['units'] == case['losses']['oracle']
        assert all(np.isfinite(case['losses']['units']))
        got, want = case['params']['units'], case['params']['oracle']
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize('ranks,name', CASES)
def test_working_set_is_one_unit(worlds, ranks, name):
    """The high-water mark of whole gathered bytes (and, in the train and
    eval steps and 1F1B's loop of one stage, their casts) is at most the
    largest unit's whole bytes and its bf16 cast (1F1B over many stages:
    its largest unit, a stage's chunk or the replicated leaves, casts not
    counted); the oracle's, every leaf gathered at once, is over it."""
    for case in _case(worlds, ranks, name):
        assert 0 < case['peak']['units'] <= case['bound'], case
        assert case['peak']['oracle'] > case['bound'], case


@pytest.mark.parametrize('ranks', (2, 4))
def test_unit_gathering_stays_near_the_unplaced_step(worlds, ranks):
    """The first per-unit FSDP loss (the forward on the initial weights,
    gathered unit by unit) stays within the CPU parity tests' rtol of the
    unplaced step's. Later AdamW losses are not held here: Adam turns the
    float32 noise of a gradient summed over ranks into lr-sized steps. The
    gradients are the oracle's bit for bit (above), and
    ``test_torch_parallel.py`` holds that step to the unplaced one and to
    the reference's FSDP."""
    for case in _case(worlds, ranks, 'fsdp'):
        np.testing.assert_allclose(case['losses']['units'][0],
                                   case['unplaced'][0], rtol=2e-5)


def test_a_stand_in_used_outside_its_unit_raises(worlds):
    """A stand-in of a split leaf gives its metadata and, through
    ``gathered``, its whole leaf (``gather_leaf``'s); any operation on the
    stand-in itself, which would compute on its NaN, raises under
    ``unit_gathering`` and under ``guard_stand_ins`` on every rank."""
    for result in worlds[2]:
        guard = result['fsdp_units']['guard']
        assert guard['deferred'] and guard['shape'] == guard['whole_shape']
        for name in ('unit_gathering', 'guard_stand_ins'):
            assert guard[name] == dict(meta=5, raised=[True] * 4,
                                       whole_equal=True), name
