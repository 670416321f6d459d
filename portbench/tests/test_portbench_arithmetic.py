"""The yardstick's arithmetic on synthetic inputs: exact percentiles, rates
over the window, the idle share as a union of intervals, the operation and
byte counts (worked by hand), the seeded weights and traffic."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.counts import dlrm, gpt2, peaks
from portbench.generators import zipf

GPT2 = dict(n_embd=4, n_head=2, n_layer=1, vocab_size=10, n_inner=None)
DLRM = dict(dense_in_features=2, dense_arch_layer_sizes=[3, 2],
            embedding_dim=2, num_embeddings_per_feature=[5, 7],
            over_arch_layer_sizes=[4, 1])


@pytest.mark.parametrize('share', [0.0, 0.1, 0.5, 0.95, 1.0])
def test_quantile_is_exact_and_linear(share):
    values = list(np.random.default_rng(3).exponential(size=101))
    assert harness.quantile(values, share) == pytest.approx(
        np.quantile(values, share), rel=1e-12)


def test_union_counts_overlaps_once():
    intervals = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert harness.merge(intervals) == [(0, 20), (30, 40)]
    assert harness.covered(intervals, 0, 50) == 30
    assert harness.covered(intervals, 8, 32) == 14


def _trace():
    return harness.Trace(
        device=[(0, 10, 'void flash_fwd_kernel<64>'), (5, 20, 'gemm'),
                (30, 40, 'void segment_fold_kernel<false>'),
                (45, 60, 'gemm')],
        spans=[(18, 35, 'step'), (25, 28, 'data_wait')], window=(0, 50))


def test_idle_share_and_gaps_from_a_synthetic_trace():
    trace = _trace()
    assert trace.window_s == 50e-6
    assert trace.busy_s == pytest.approx(35e-6)     # 0-20, 30-40, 45-50
    run = _run(trace=trace)
    assert harness.idle_share(run) == pytest.approx(30.0)
    # gaps 20-30 (the step span is open) and 40-45 (none is)
    assert trace.idle_gaps() == [['step', pytest.approx(10e-6)],
                                 ['idle', pytest.approx(5e-6)]]
    assert trace.kernel_seconds(['flash_fwd_kernel']) == pytest.approx(1e-5)
    assert trace.kernel_seconds(['no_such_kernel']) is None
    assert [name for name, _ in trace.device_ops()] == [
        'gemm', 'void flash_fwd_kernel<64>',
        'void segment_fold_kernel<false>']
    assert harness.kernel_share(run, ['segment_fold_kernel'], 5e-6) == (
        pytest.approx(50.0))
    assert harness.idle_share(_run()) is None


def _run(trace=None, counts=None, samples=None):
    spans = harness.Spans()
    spans.intervals = {'data_wait': [(1.0, 1.5), (1.2, 2.0), (9.0, 12.0)]}
    return harness.Run(workload={}, config={}, traffic={}, window=(0.0, 10.0),
                       spans=spans, counts=counts or {},
                       samples=samples or {}, peak_memory_bytes=2 ** 31,
                       trace=trace)


def test_readers_on_a_synthetic_run():
    read = lambda name, run: harness.load_module('metrics', name).read(run)
    run = _run(counts={'tokens': 1000, 'samples': 50, 'setup_s': 3.5,
                       'flops': 0.5 * 989e12 * 10, 'bytes': 0.0,
                       'dtype': 'bfloat16'})
    assert read('train_tokens_per_s', run) == 100.0
    assert read('train_samples_per_s', run) == 5.0
    assert read('setup_s', run) == 3.5
    assert read('lm.train_mfu', run) == pytest.approx(50.0)
    assert read('dlrm.train_mfu', run) == pytest.approx(50.0)
    assert read('lm.data_wait_share', run) == pytest.approx(20.0)
    assert read('lm.peak_memory_gib', run) == 2.0


def test_gpt2_counts_by_hand():
    # blocks: qkv 4x12 + out 4x4 + fc 4x16 + proj 16x4 = 192 weights;
    # one row of 3: 6 visible pairs, head_dim 2, 2 heads, 1 layer.
    # forward: 2*192*3 + 2*4*10*2 (head on 2 positions) + 4*2*6*2 = 1408
    assert gpt2.block_weights(GPT2) == 192
    assert gpt2.causal_pairs(1, 3) == 6
    assert gpt2.train_step_flops(GPT2, 1, 3) == 3 * 1408
    # attention: 14*2 operations over 12 (pair, head)s; bytes: 12 bf16
    # tensors of 3*4*2 = 24 B (q k v out read, q k v out dout read again,
    # dq dk dv written) and two float32 log-sum-exps of 3*2*4 = 24 B
    assert gpt2.train_attention(GPT2, 1, 3) == (336.0, 12 * 24 + 2 * 24)


def test_dlrm_counts_by_hand():
    # bottom 2-3-2 (12 weights), over (2+3 pairs)-4-1 (24): 36 weights, 10
    # biases; batch 10: forward 2*10*36 + 2*10*3 pairs*2 = 840
    assert dlrm.mlp_weights(DLRM) == 36
    assert dlrm.mlp_parameters(DLRM) == 46
    assert dlrm.train_step_flops(DLRM, 10) == 3 * 840
    # inputs 10*(2*4 + 2*4 + 4) = 200; 6 touched rows of 8 B read and
    # written = 96; 46 parameters read and written = 368
    assert dlrm.train_step_bytes(DLRM, 10, 6) == 664
    # forward 6*8 + 10*2*(4 + 8) = 288, backward the same
    assert dlrm.lookup_bytes(DLRM, 10, 6) == 576


def test_dlrm_count_holds_when_the_update_is_dense():
    """A dense update moves whole tables; the count moves the touched
    rows only, so tables a hundred times larger change nothing."""
    large = dict(DLRM, num_embeddings_per_feature=[500, 700])
    for count in (dlrm.train_step_bytes, dlrm.lookup_bytes):
        assert count(DLRM, 10, 6) == count(large, 10, 6)
    assert dlrm.train_step_flops(DLRM, 10) == dlrm.train_step_flops(large,
                                                                    10)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0.0, 'bfloat16') == 1.0
    assert peaks.least_seconds(0.0, 3.35e12, 'float32') == 1.0
    assert peaks.least_seconds(67e12, 1.0, 'float32') == 1.0


def test_weights_redraw_by_chunk():
    recipe = ('t', (weights.CHUNK_ROWS + 5, 2), 'uniform', 0.5)
    first = weights.draw(11, recipe, 'cpu')
    assert torch.equal(first, weights.draw(11, recipe, 'cpu'))
    assert not torch.equal(first, weights.draw(12, recipe, 'cpu'))
    assert first.abs().max() <= 0.5
    assert weights.distance_norm(first, 11, recipe) == 0.0
    moved = first.clone()
    moved[-1, 0] += 3.0
    assert weights.distance_norm(moved, 11, recipe) == pytest.approx(3.0)
    constant = weights.draw(11, ('c', (3,), 'constant', 1.0), 'cpu')
    assert torch.equal(constant, torch.ones(3))


def test_zipf_ids_are_truncated_and_skewed():
    generator = torch.Generator().manual_seed(2 ** 31 + 7)
    ids = zipf.draw(1000, 1.3, (20000,), generator)
    assert ids.min() >= 0 and ids.max() < 1000
    counts = torch.bincount(ids, minlength=1000)
    assert counts[0] == counts.max() and counts[0] > 4 * counts[5]
