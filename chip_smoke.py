#!/usr/bin/env python3
"""Bring-up run of tpusystem_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out PATH]

Phases, in order; any failure exits non-zero:

1. build the hand-written kernels from ``tpusystem_torch/ops/cuda/csrc``
   (``nvcc`` for ``sm_90a``, one process per source, in parallel), with
   ptxas' registers and spills of every K4 and K5 instantiation
   (``decode_matmul_kernel<gelu, weight type>``,
   ``decode_ffn_kernel<weight type>``: ``decode-ptxas``)
   and of K9's staging and fold kernels (``lookup-ptxas``); a missing or
   spilling one fails;
2. hold each serving kernel against its plain PyTorch version on the card at
   the serving path's shapes (bfloat16, batch 8, prefill lengths 512 and
   1024) and time it beside the plain version, the one PyTorch library call
   that computes the same function, and its bound (every check prints
   ``bound_share``, its bound over its time, and K1's its TFLOP/s); K4
   splits K over a cluster of 8 blocks per 32-column tile, its weight slab
   by TMA, its products on ``mma.sync`` (``design`` on its ``kernels``
   entry, both of its shapes); K5, the fused FFN, is one launch of clusters
   of 8 blocks, each cluster a slab of 256 hidden columns: every block's w1
   and w2 boxes by TMA through a ring of slots (all of them requested at
   its start at this width), fc and proj on ``mma.sync``, the
   hidden slab passed between the cluster's blocks in their shared memory,
   the slabs' float32 partials summed in slab order by the last block to
   take its columns' ticket (``design``, ``bound_share`` and a bitwise
   repeat on its ``kernels`` entries);
   2b. then K1, the TMA-fed ``wgmma`` flash forward (128-row query and kv
   tiles, two warpgroups), at head dim 128, Llama-3 8B's prefill shapes
   [1, S, 32, 8, 128] for S = 512, 1024, 4096 and 8192, an MHA case
   [2, 1024, 8, 8, 128], a ragged length (S = 1000) and a non-causal case,
   each against the plain forward (out within 2e-2, lse within 1e-3),
   timed beside it, ``scaled_dot_product_attention`` (GQA) and its bound,
   with ptxas' registers and spills of every K1 instantiation
   (``k1-ptxas``; a missing or spilling head dim fails);
3. the flash forward K1 at the training shape [16, 1024, 12, 64], then the
   flash backward kernels K2b (fused), K3a and K3b (the split dq / dkv
   pair), and K2a under multi-head attention, at GPT-2's head dim 64 (the
   training shape, GQA, non-causal and ragged cases) and at head dim 128
   (Llama-3 8B's training shapes [1, S, 32, 8, 128] for S = 8192 and 2048,
   MHA [1, 4096, 8, 8, 128], a ragged S = 1000 and a non-causal S = 1024):
   each against the plain backward, repeated bitwise, K2a bit for bit K2b,
   K3b's dk and dv bit for bit K2b's (K3b is the fused kernel's body
   without dq; K3a a dq sweep shaped as K1, all of them TMA-fed ``wgmma``),
   the split pair against the fused kernel, timed beside the plain
   backward, the backward of ``scaled_dot_product_attention``
   (``enable_gqa``) and its bound (``bound_share``, ``tflops``; K2a and
   K2b with the share of their cycles spent waiting for dq tickets); with
   ptxas' registers and spills of every backward instantiation
   (``bwd-ptxas``; a missing or spilling one fails);
4. the flash forward K1 against its plain version at the long-context
   ladder's shapes [4, 4096, 12, 64], [2, 8192, 12, 64] and
   [1, 16384, 12, 64], timed beside it and ``scaled_dot_product_attention``;
   the fused backward K2a (``flash_bwd_fused_g1``, multi-head attention
   past 1024 keys) at [1, 16384, 12, 64] and [4, 4096, 12, 64]:
   bit for bit K2b and itself on a repeat, within tolerance of the plain
   backward, timed beside K2b, the plain version and the backward of
   ``scaled_dot_product_attention``; then a non-causal and a ragged case
   through the backward's routing;
5. serve GPT-2 125M (full width, random weights from ``--seed``) through the
   paged ``Engine``: eight requests of 20 to 700 prompt tokens, 32 new tokens
   each; every serving kernel's launch count must rise during this run, and
   one decode step's logits through the fused kernels must agree with the
   module path on the same state; then a traced window of decode steps says
   where a step's time goes;
6. streamed int8 and fp8 weights: K4 and K5 with int8, then float8 e4m3
   weights and float32 per-channel scales against their plain versions at
   phase 2's shapes, timed beside them, ``F.linear`` on the widened bf16
   weight and the narrow bytes' bound; then phase 5's model and requests
   through ``Engine(stream_dtype='int8')`` and ``'fp8'``: the narrow K4/K5
   launch (and the bf16 ones do not), one fused step's logits agree with
   the module path on the same quantized state, and decode tokens/s, step
   ms and the share of tokens equal to phase 5's are printed;
7. train GPT-2 125M as ``bench.py``'s recipe does (vocab 50304, flash
   attention, the chunked loss over 8 chunks, AdamW with clipping, 16 x 1024
   tokens, the same batch every step): one warm-up and six timed steps whose
   losses must be finite and fall, with the flash forward and the fused
   backward launched once per layer per step; first its loss and gradient
   are held against the same model on plain PyTorch attention; then a traced
   window of two steps;
8. the long-context ladder (``benchmarks/headline_sweep.py``'s ``long``):
   GPT-2 125M with ``max_seq = seq`` and ``remat=True`` at 16,384 tokens a
   step, (4, 4096), (2, 8192) and (1, 16384): the ``remat`` model's loss and
   gradient equal the model's without it bit for bit at (1, 16384), then one
   warm-up and three timed steps a point with falling losses, K2a launched
   12 times a step, K1 24 times (the recompute) and K2b never; step time,
   tokens/s, peak memory and MFU per point, and a traced window at
   (1, 16384);
9. dropout at ``p = 0.1``: K1, K2a, K2b, K3a and K3b's keep masks read back
   from their outputs equal the plain hash bit for bit (a small shape, MHA
   and GQA, head dims 64 and 128), and each kernel agrees with its plain
   version at the dropout step's shape [16, 1024, 12, 64], a GQA group of 3
   and K2a at 2048 keys;
   the threefry mask kernel equals its plain bits on a CPU copy at
   [16, 1024, 768], timed; then GPT-2 125M trains with bench.py's recipe
   at ``dropout=0.1``: one warm-up and three timed steps with falling losses,
   K1 and K2b launched 12 times a step, the mask kernel 25 times;
10. the grouped MoE kernels K6 (``gather_rows_matmul``) and K7
   (``matmul_scatter_rows``), one TMA-fed ``wgmma`` kernel, against their
   plain versions at the four shapes one MoE layer gives them in training
   (forward and backward, 16,384 tokens routed top-2 over 8 experts at
   capacity 5,120), with bitwise repeats, each timed beside the plain
   version, ``torch.bmm`` and its bound (``bound_share``, ``tflops``); K7's
   time split into its grouped product, its combine and its token index
   (``k7-split``); an edge sweep over widths off 16 bytes and off 64, C off
   the 128-row tile, N under 64 columns, one group and k = 4 at full width
   (``grouped-edges``); ptxas' registers and spills of every
   ``grouped_gemm_kernel`` instantiation (``grouped-ptxas``; a missing or
   spilling one fails);
11. train the 8-expert GPT-2 MoE (``benchmarks/moe_ceiling.py``'s whole-model
   settings: the 125M body, 8 experts top-2 in every second block,
   ``moe_sparse_impl='fused'``, ``WithAuxLoss`` over the chunked loss, AdamW,
   16 x 1024 tokens): its loss and gradient on 2 rows held against the same
   weights through the gather impl, then one warm-up and three timed steps
   whose losses must be finite and fall, K6 and K7 launched 12 times per
   step each; then a traced window of two steps with the device ms of the
   grouped products and the combine;
12. one layer's attention forward and backward through the split backward,
   its gradients held against the fused one's, at the training shape and
   at head dim 128 at Llama-3 8B's training row ([1, 8192, 32, 8, 128]);
13. the recommender's kernels K8 (``gather_rows``) and K9
   (``scatter_add_rows``) against their plain versions on a CPU copy, bit
   for bit, at the largest Criteo Kaggle table (10,131,227 x 128 float32)
   with 65,536 Zipf ids, through the dedup pass and without it, the
   batch-side fold (its longest segment and chain floor, that segment's
   dependent adds at 4 cycles each at ``clocks.max.sm``, beside its byte
   bound: ``fold-bound``), a bf16 table and a width off the 16-byte loads;
   then the fold sweep (``fold-sweep``): one id at all 65,536 positions,
   the vocabulary-3 table's head, all ids distinct, sentinels interleaved
   and at the end, segments at the long path's threshold and one either
   side of it, bf16 rows and widths 8, 130 and 512, each bit for bit and
   repeated, the first two timed beside ``index_add_``;
14. train the DLRM at MLPerf's widths over the 26 Criteo Kaggle tables
    (17.3 GB of float32 tables) with SGD (lr 0.3) at batch 65,536 from the
    port's ``Loader``, through the port's host layers: ``dlrm_tiny`` first
    held against the CPU; then a ``Compiler`` builds the ``Recommender``
    aggregate (its steps take the device and the seed by ``Depends``), the
    ``train`` handler of a ``Service`` runs one warm-up and five timed steps
    whose losses must fall, K8 launched 26 times and K9 52 times per step,
    and ends the phase with one ``Trained`` on a one-process ``Runtime``'s
    producer, which ``evaluation_consumer`` answers with one
    ``RecsysEvaluated`` (its metrics bit for bit a direct evaluator run),
    the ledger counting both; a ``StopIteration`` enqueued on the aggregate
    unwinds out of its epoch assignment (``dlrm-host``); a repeated step
    equal bit for bit, a holdout AUC and a traced window with K9's device
    ms per step and the 26 folds' (replayed on the step's batch);
15. serve Llama-3 8B (``llama3_8b``: 32 layers, dim 4096, 32 / 8 heads of
    128, FFN 14336, vocab 128256, ``max_seq`` 8192; random weights from
    ``--seed``) through ``Engine(rows=8, block_size=16)``, after freeing the
    earlier phases: the route resolves to the module paged step, eight
    requests of 20 to 7,000 prompt tokens (buckets 32, 512 ... 8192) take 32
    new tokens each, K1 launches 32 times for each bucket of 512 or more
    (224) and K4/K5 never; the logits through the paged cache at one
    request's prefill and first 4 decode steps agree with the model's
    non-cached forward; time to first token by bucket, decode tokens/s,
    step ms, peak memory and a traced window of 4 decode steps
    (``serve-llama``);
16. train Llama at Llama-3 8B's width with
    ``benchmarks/llama8b_rehearsal.py``'s ``chip()`` recipe (dim 4096,
    32 / 8 heads of 128, FFN 14336, ``remat=True``, flash attention, vocab
    16384, the chunked loss over 8 chunks, AdamW with clipping, one
    sequence of 8192 tokens) at 8 layers, after freeing phase 15: the
    same model at 2 layers on [1, 2048] held against plain PyTorch
    attention, then one warm-up and three timed steps with falling losses,
    K1 16 and K2b 8 launches a step (K2a, K3a, K3b none); step ms,
    tokens/s, peak memory and ``mfu``, and a traced window
    (``train-llama``, ``train-llama-profile``);
17. print the ``kernels`` line (with a ``head_dim_128`` entry for K1 and
    each backward kernel), the card's name and power limit, and last the
    ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX. Exits non-zero without a CUDA device or without the
repository beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

from tpusystem_torch import Aggregate, Compiler, Depends, Runtime
from tpusystem_torch.registry import gethash
from tpusystem_torch.train import build_train_step, module_apply

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak, same source
FP32_OPS = 67e12                # float32 outside the tensor cores, same source
L2_FLUSH_BYTES = 128 << 20      # rotating inputs exceed the 50 MB L2
ROWS, BLOCK, MAX_NEW = 8, 16, 32
PROMPT_LENGTHS = (20, 300, 700, 20, 300, 700, 100, 450)
TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM = 16, 1024, 12, 64
TRAIN_STEPS = 6                 # timed, after one warm-up step
MOE_EXPERTS, MOE_K, MOE_FACTOR, MOE_STEPS = 8, 2, 1.25, 3
DIM, HIDDEN = 768, 3072
# torchrec's DLRM example: the Criteo Kaggle table cardinalities
CRITEO_KAGGLE = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                 7046547, 18, 15, 286181, 105, 142572)
DLRM_BATCH, DLRM_DIM, DLRM_STEPS = 65536, 128, 5
DLRM_LR = 0.3                   # SGD; 1.0 rose after 3 steps on the card
# benchmarks/headline_sweep.py:149-154: 16,384 tokens a step at three lengths
LONG_LADDER = ((4, 4096), (2, 8192), (1, 16384))
LONG_KERNEL_SHAPES = ((1, 16384), (4, 4096))
LONG_STEPS = 3                  # timed, after one warm-up step
DROPOUT = 0.1                   # GPT2's default rate
DROPOUT_STEPS = 3
# the dropout kernel check: K2b/K3a/K3b at the dropout step's shape and a GQA
# group of 3, K2a past 1024 keys
DROPOUT_KERNEL_SHAPES = {'mha': (TRAIN_BATCH, TRAIN_SEQ, HEADS),
                         'gqa': (2, 1024, 4),
                         'k2a': (1, 2048, HEADS)}
# K1 at head dim 128: (label, batch, seq, q heads, kv heads, causal);
# Llama-3 8B's prefill buckets at 32 / 8 heads, then MHA, ragged, non-causal
K1_128_CASES = (('S=512', 1, 512, 32, 8, True),
                ('S=1024', 1, 1024, 32, 8, True),
                ('S=4096', 1, 4096, 32, 8, True),
                ('S=8192', 1, 8192, 32, 8, True),
                ('mha', 2, 1024, 8, 8, True),
                ('ragged', 1, 1000, 32, 8, True),
                ('noncausal', 1, 1024, 32, 8, False))
# the backward kernels, by head dim: (label, batch, seq, q heads, kv heads,
# causal, an lse cotangent); GPT-2's training shape, GQA, non-causal and
# ragged; Llama-3 8B's training shapes, K2a's MHA case, ragged, non-causal
BWD_CASES = {
    HEAD_DIM: (('train', TRAIN_BATCH, TRAIN_SEQ, HEADS, HEADS, True, False),
               ('gqa', 2, TRAIN_SEQ, HEADS, 4, True, True),
               ('non-causal', 2, TRAIN_SEQ, HEADS, HEADS, False, True),
               ('ragged', 2, 1000, HEADS, HEADS, True, True)),
    128: (('S=8192', 1, 8192, 32, 8, True, False),
          ('S=2048', 1, 2048, 32, 8, True, False),
          ('mha', 1, 4096, 8, 8, True, False),
          ('ragged', 1, 1000, 32, 8, True, False),
          ('noncausal', 1, 1024, 32, 8, False, False))}
# Llama-3 8B serving: eight requests whose buckets are 32, then 512 to 8192
LLAMA_PROMPT_LENGTHS = (20, 300, 600, 1100, 2100, 3000, 4500, 7000)
LLAMA_PROBE = 1100              # the request whose logits are probed
LLAMA_PROBE_STEPS = 4
# Llama training: benchmarks/llama8b_rehearsal.py's chip() recipe (one
# sequence of 8192 tokens, vocab 16384) with depth cut to fit one card
LLAMA_TRAIN_LAYERS, LLAMA_TRAIN_VOCAB, LLAMA_TRAIN_SEQ = 8, 16384, 8192
LLAMA_TRAIN_STEPS = 3           # timed, after one warm-up step
# K2a and K2b: one TMA-fed wgmma kernel, flash_bwd_fused_kernel<head dim,
# true>; K3b is its body without dq, <head dim, false>; K3a is
# flash_bwd_dq_kernel<head dim>. ptxas must report every instance at every
# head dim without spills (bwd-ptxas).
FUSED_KERNELS = ('flash_bwd_fused', 'flash_bwd_fused_g1')
BWD_INSTANCE = {'flash_bwd_fused_g1': 'flash_bwd_fused_kernel<{}, true>',
                'flash_bwd_fused': 'flash_bwd_fused_kernel<{}, true>',
                'flash_bwd_dq': 'flash_bwd_dq_kernel<{}>',
                'flash_bwd_dkv': 'flash_bwd_fused_kernel<{}, false>'}
BWD_INSTANCES = tuple(sorted({instance.format(head_dim)
                              for instance in BWD_INSTANCE.values()
                              for head_dim in (16, 32, 64, 128)}))
# K6 and K7: one TMA-fed wgmma kernel, grouped_gemm_kernel<gather, trans_b>
GROUPED_INSTANCES = tuple(f'grouped_gemm_kernel<{gather}, {trans_b}>'
                          for gather in ('false', 'true')
                          for trans_b in ('false', 'true'))
# phase 10's edge sweep: (tokens, experts, k, capacity, dim, hidden); widths
# off 16 bytes (the producer's own loads), C off the 128-row tile with a
# seated tail, K and N off 64, N under one 64-column box, one group, k = 4
# at full width
GROUPED_EDGES = ((40, 4, 2, 12, 20, 30),
                 (400, 4, 2, 200, 128, 256),
                 (256, 4, 2, 160, 72, 200),
                 (128, 4, 2, 80, 40, 48),
                 (300, 1, 1, 256, 256, 512),
                 (1024, 8, 4, 640, 768, 3072))
# K4: decode_matmul_kernel<GELU, weight type (0 bf16, 1 int8, 2 e4m3)>; K5:
# decode_ffn_kernel<weight type>; ptxas must report every instance of both
# without spills (decode-ptxas)
DECODE_INSTANCES = tuple(f'decode_matmul_kernel<{gelu}, {mode}>'
                         for mode in (0, 1, 2) for gelu in ('false', 'true'))
FFN_INSTANCES = tuple(f'decode_ffn_kernel<{mode}>' for mode in (0, 1, 2))
# K9: the staging pass stage_products_kernel<bf16 rows, vector loads> and
# the fold segment_fold_kernel<bf16 rows> (lookup-ptxas)
LOOKUP_INSTANCES = tuple(
    f'stage_products_kernel<{bf16}, {vec}>' for bf16 in ('false', 'true')
    for vec in ('false', 'true')) + tuple(
        f'segment_fold_kernel<{bf16}>' for bf16 in ('false', 'true'))
CHAIN_CYCLES = 4                # a dependent float32 add's latency, SM cycles
K4_DESIGN = 'cluster-split-k+tma+mma.sync'
K5_DESIGN = 'cluster-hidden-slab+tma+mma.sync'
K9_DESIGN = 'ordered-chains+bulk-ring'


def fail(message: str) -> None:
    print(f'chip_smoke: FAILED: {message}', file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        result = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True)
        return result.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as error:
        return f'nvidia-smi unavailable ({error})'


def measure(fn, calls: int = 50, warmup: int = 5):
    """Device milliseconds per call of ``fn(i)``: the summed kernel time of
    a profiled window (taken again, up to three windows, when the profiler
    returns one without device time; the event time only if all three do),
    and the CUDA-event time of an unprofiled window (which also counts the
    gaps the host leaves between launches)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / calls
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    device_ms = 0.0
    for _ in range(3):   # now and then a window comes back without device time
        with torch.profiler.profile(activities=activities) as profile:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        device_us = 0.0
        for event in profile.key_averages():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                device_us += getattr(event, 'self_device_time_total', 0.0)
        device_ms = device_us / 1e3 / calls
        if device_ms > 0:
            break
    return (device_ms if device_ms > 0 else event_ms), event_ms


def bound_ms(moved_bytes: float, flops: float):
    memory, compute = moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(memory, compute) * 1e3, ('bytes' if memory >= compute
                                        else 'operations')


def sm_clock_mhz():
    """The card's top SM clock in MHz (``nvidia-smi --query-gpu=
    clocks.max.sm``), or None where it cannot be read."""
    try:
        result = subprocess.run(
            ['nvidia-smi', '--query-gpu=clocks.max.sm',
             '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=30, check=True)
        return float(result.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def chain_floor_ms(longest: int, clock_mhz: float) -> float:
    """The least time K9's ordered sum can take: its longest segment's
    chain of dependent float32 adds, ``CHAIN_CYCLES`` cycles each at
    ``clock_mhz``, however many columns run beside it."""
    return longest * CHAIN_CYCLES / (clock_mhz * 1e3)


def rotating(make, one_set_bytes: int):
    """Enough independent input sets that cycling through them keeps every
    call's inputs out of L2, as the serving path finds them."""
    copies = max(2, math.ceil(L2_FLUSH_BYTES / one_set_bytes))
    return [make() for _ in range(copies)]


def record_check(name, shape, err, tol, timed, plain, library, bound,
                 by_events=False, flops=None, **notes):
    """Print one kernel's check and fail if its error is over ``tol``. With
    ``by_events`` the times quoted are the CUDA-event ones (for kernels of
    milliseconds, where the host's gaps between launches are negligible),
    the profiler's kernel sum kept beside them. ``bound_share`` is
    ``bound_ms / ms``; with ``flops`` (the work the bound counts) the
    achieved ``tflops`` stand beside it."""
    pick = 1 if by_events else 0
    entry = dict(shape=shape, max_abs_err=err, tol=tol, ms=timed[pick],
                 event_ms=timed[1], profiler_ms=timed[0],
                 plain_ms=plain[pick],
                 library_ms=None if library is None else library[pick],
                 bound_ms=bound[0], bound_by=bound[1],
                 bound_share=bound[0] / timed[pick], **notes)
    if flops is not None:
        entry['tflops'] = flops / timed[pick] / 1e9
    print('kernel-check ' + json.dumps({'name': name, **entry}))
    if not err <= tol:
        fail(f'{name} {shape}: max abs err {err} over {tol}')
    return name, entry


def decode_checks(torch, generator, mode: str = 'bf16'):
    """K4 at the qkv and out shapes and K5 at the FFN shape of one decode
    step (8 rows), with ``mode`` weights: bfloat16, or int8 / fp8
    ``QuantizedLeaf`` s whose narrow values and float32 scales the kernels
    read. Each against its plain version, timed beside it, ``F.linear`` on
    the weight as a bfloat16 matrix (widened: twice a narrow weight's
    bytes) and the bound of the bytes the kernel must move."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.precision import (dequantize_leaf,
                                               quantize_leaf)

    device = torch.device('cuda')
    bf16 = torch.bfloat16
    dim, hidden = DIM, HIDDEN
    suffix = '' if mode == 'bf16' else f'_{mode}'

    def normal(shape, scale=1.0):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(bf16)

    def weight(shape):
        if mode == 'bf16':
            return normal(shape, shape[0] ** -0.5)
        return quantize_leaf(torch.randn(shape, generator=generator,
                                         device=device) * shape[0] ** -0.5,
                             mode)

    def wide_t(w):
        """The weight as ``F.linear`` takes it: bf16, ``[out, in]``."""
        wide = w if mode == 'bf16' else dequantize_leaf(w, bf16)
        return wide.t().contiguous()

    def vector(cols):
        return torch.randn(cols, generator=generator, device=device) * 0.1

    weight_bytes = 2 if mode == 'bf16' else 1
    rows = []

    def record(*args, **notes):
        rows.append(record_check(*args, **notes))

    # K4 decode_matmul at the qkv and out shapes of one decode step
    for label, cols in (('qkv', 3 * dim), ('out', dim)):
        sets = rotating(lambda: dict(x=normal((ROWS, dim)),
                                     w=weight((dim, cols)), b=vector(cols)),
                        dim * cols * weight_bytes)
        for s in sets:
            s['wt'], s['b16'] = wide_t(s['w']), s['b'].to(bf16)
        first = sets[0]
        got = dm.decode_matmul(first['x'], first['w'], first['b'])
        want = dm.decode_matmul_plain(first['x'], first['w'], first['b'])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -7 * want.float().abs().max().item()
        pick = lambda i: sets[i % len(sets)]
        timed = measure(lambda i: dm.decode_matmul(pick(i)['x'], pick(i)['w'],
                                                   pick(i)['b']))
        plain = measure(lambda i: dm.decode_matmul_plain(
            pick(i)['x'], pick(i)['w'], pick(i)['b']))
        library = measure(lambda i: F.linear(pick(i)['x'], pick(i)['wt'],
                                             pick(i)['b16']))
        moved = (ROWS * dim * 2 + first['w'].nbytes + cols * 4
                 + ROWS * cols * 2)
        record(f'decode_matmul{suffix}[{label}]', [ROWS, dim, cols], err, tol,
               timed, plain, library, bound_ms(moved, 2 * ROWS * dim * cols))

    # K5 decode_ffn at the FFN shape of one decode step
    sets = rotating(lambda: dict(x=normal((ROWS, dim)),
                                 w1=weight((dim, hidden)), b1=vector(hidden),
                                 w2=weight((hidden, dim)), b2=vector(dim)),
                    2 * dim * hidden * weight_bytes)
    for s in sets:
        s['w1t'], s['w2t'] = wide_t(s['w1']), wide_t(s['w2'])
        s['b1h'], s['b2h'] = s['b1'].to(bf16), s['b2'].to(bf16)
    pick = lambda i: sets[i % len(sets)]
    args = lambda s: (s['x'], s['w1'], s['b1'], s['w2'], s['b2'])
    got = dm.decode_ffn(*args(sets[0]))
    again = dm.decode_ffn(*args(sets[0]))
    want = dm.decode_ffn_plain(*args(sets[0]))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -7 * want.float().abs().max().item()
    repeat = bool(torch.equal(got, again))
    if not repeat:
        fail(f'decode_ffn{suffix}: a repeat differs (the slabs are summed '
             'in a fixed order)')
    timed = measure(lambda i: dm.decode_ffn(*args(pick(i))))
    plain = measure(lambda i: dm.decode_ffn_plain(*args(pick(i))))
    library = measure(lambda i: F.linear(F.gelu(
        F.linear(pick(i)['x'], pick(i)['w1t'], pick(i)['b1h']),
        approximate='tanh'), pick(i)['w2t'], pick(i)['b2h']))
    moved = (ROWS * dim * 2 + sets[0]['w1'].nbytes + sets[0]['w2'].nbytes
             + hidden * 4 + dim * 4 + ROWS * dim * 2)
    record(f'decode_ffn{suffix}', [ROWS, dim, hidden, dim], err, tol, timed,
           plain, library, bound_ms(moved, 4 * ROWS * dim * hidden),
           bitwise_repeat=repeat)
    return rows


def check_kernels(torch, generator):
    """Phase 2: every serving kernel against its plain version, timed."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import flash

    device = torch.device('cuda')
    bf16 = torch.bfloat16

    def normal(shape, scale=1.0):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(bf16)

    rows = decode_checks(torch, generator)

    def record(*args, **notes):
        rows.append(record_check(*args, **notes))

    # K1 flash forward at the two prefill buckets that route to it
    heads, head_dim = 12, 64
    for seq in (512, 1024):
        shape = (1, seq, heads, head_dim)
        sets = rotating(lambda: dict(q=normal(shape), k=normal(shape),
                                     v=normal(shape)),
                        3 * seq * heads * head_dim * 2)
        for s in sets:
            for name in 'qkv':
                s[name + 't'] = s[name].transpose(1, 2).contiguous()
        first = sets[0]
        out, lse = flash.flash_attention_lse(first['q'], first['k'],
                                             first['v'])
        want_out, want_lse = flash.flash_attention_plain(
            first['q'], first['k'], first['v'])
        torch.cuda.synchronize()
        if not (torch.isfinite(out.float()).all()
                and torch.isfinite(lse).all()):
            fail(f'flash S={seq}: non-finite output')
        err = (out.float() - want_out.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if lse_err > 1e-3:
            fail(f'flash S={seq}: lse max abs err {lse_err} over 1e-3')
        pick = lambda i: sets[i % len(sets)]
        timed = measure(lambda i: flash.flash_attention_lse(
            pick(i)['q'], pick(i)['k'], pick(i)['v']))
        plain = measure(lambda i: flash.flash_attention_plain(
            pick(i)['q'], pick(i)['k'], pick(i)['v']), calls=10)
        library = measure(lambda i: F.scaled_dot_product_attention(
            pick(i)['qt'], pick(i)['kt'], pick(i)['vt'], is_causal=True))
        pairs = seq * (seq + 1) / 2                 # causal (query, key) pairs
        flops = heads * pairs * 4 * head_dim        # q.k and p.v products
        moved = 4 * seq * heads * head_dim * 2 + seq * heads * 4
        record(f'flash_attention[S={seq}]', list(shape), err, 2e-2, timed,
               plain, library, bound_ms(moved, flops), flops=flops)
    return rows


def grad_errors(got, want) -> list:
    """``[(max abs err, tol)]`` for each of ``(dq, dk, dv)``; ``tol`` is
    four bfloat16 steps (2**-6) of that tensor's largest reference
    gradient. The kernels round P and dS to bfloat16 where the plain
    version does, but sum in another order, so a rounding may land one step
    apart and carry through the sums."""
    pairs = []
    for g, w in zip(got, want):
        if not g.float().isfinite().all():
            fail('non-finite gradient from a backward kernel')
        pairs.append(((g.float() - w.float()).abs().max().item(),
                      2 ** -6 * w.float().abs().max().item()))
    return pairs


def worst(pairs):
    """The ``(err, tol)`` pair over its tol if any, else the largest err."""
    return max(pairs, key=lambda pair: (pair[0] > pair[1], pair[0]))


def attention_pairs(batch, seq, heads) -> float:
    """Causal (query, key) pairs of one attention call."""
    return batch * heads * seq * (seq + 1) / 2


def backward_bound(kernel, batch, seq, heads, kv_heads, head_dim, causal):
    """``bound_ms``'s ``(ms, by)`` of one backward kernel's call: the
    tensors it reads and writes once (q, dO, lse and delta of the query
    heads, k and v of the kv heads, and its gradients), and 5 (K2a, K2b),
    3 (K3a) or 4 (K3b) products of 2 head_dim flops a visible pair; and
    those flops."""
    q_bytes = batch * seq * heads * head_dim * 2
    kv_bytes = batch * seq * kv_heads * head_dim * 2
    stats = 2 * batch * seq * heads * 4
    pairs = (attention_pairs(batch, seq, heads) if causal
             else batch * heads * seq * seq)
    q_tensors, kv_tensors, products = {
        'flash_bwd_fused': (3, 4, 5), 'flash_bwd_fused_g1': (3, 4, 5),
        'flash_bwd_dq': (3, 2, 3), 'flash_bwd_dkv': (2, 4, 4)}[kernel]
    flops = products * 2 * head_dim * pairs
    return bound_ms(q_tensors * q_bytes + kv_tensors * kv_bytes + stats,
                    flops), flops


def check_backward(torch, generator, head_dim, cases):
    """Phase 3: the flash backward kernels K2b (fused), K3a and K3b (the
    split dq / dkv pair), and K2a under multi-head attention, at
    ``head_dim`` for each of ``cases`` (``BWD_CASES``): each against the
    plain backward (the gradient tolerance of ``grad_errors``), repeated
    bitwise, K2a bit for bit K2b, the split pair's gradients against the
    fused ones; each timed (CUDA events) beside the plain backward, the
    backward of ``scaled_dot_product_attention`` (``enable_gqa`` under
    GQA; none for a case with an lse cotangent, which it does not take) and
    its bound (``backward_bound``), every row with its ``design``, the
    fused kernel's with its ticket wait share (``fused_ticket_waits``),
    K3b's dk and dv bit for bit K2b's (``k3b_equals_k2b``). Rows are
    ``name[label]``, with ``_d{head_dim}`` after the name off GPT-2's head
    dim."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import flash

    suffix = '' if head_dim == HEAD_DIM else f'_d{head_dim}'
    rows = []
    for label, batch, seq, heads, kv_heads, causal, cotangent in cases:
        shape = [batch, seq, heads, kv_heads, head_dim]
        q, d_out = (torch.randn((batch, seq, heads, head_dim),
                                generator=generator,
                                device='cuda').to(torch.bfloat16)
                    for _ in range(2))
        k, v = (torch.randn((batch, seq, kv_heads, head_dim),
                            generator=generator,
                            device='cuda').to(torch.bfloat16)
                for _ in range(2))
        out, lse = flash.flash_attention_lse(q, k, v, causal=causal)
        d_lse = (torch.randn(lse.shape, generator=generator, device='cuda')
                 * 0.1 if cotangent else None)
        delta = flash.attention_delta(out, d_out, d_lse).contiguous()
        args = (q, k, v, d_out, lse, delta)
        want = flash.flash_attention_bwd_plain(q, k, v, out, lse, d_out,
                                               d_lse, causal=causal)
        kernels = {
            'flash_bwd_fused': lambda: flash.flash_bwd_fused(
                *args, causal=causal),
            'flash_bwd_dq': lambda: (flash.flash_bwd_dq(
                *args, causal=causal),),
            'flash_bwd_dkv': lambda: flash.flash_bwd_dkv(
                *args, causal=causal)}
        if heads == kv_heads:
            kernels = {'flash_bwd_fused_g1': lambda: flash.flash_bwd_fused_g1(
                *args, causal=causal), **kernels}
        wants = {'flash_bwd_fused': want, 'flash_bwd_fused_g1': want,
                 'flash_bwd_dq': want[:1], 'flash_bwd_dkv': want[1:]}
        calls = 3 if seq >= 8192 else 5
        plain = measure(lambda i: flash.flash_attention_bwd_plain(
            q, k, v, out, lse, d_out, d_lse, causal=causal), calls=2,
            warmup=1)
        grouped = {'enable_gqa': True} if kv_heads != heads else {}
        library = None
        if not cotangent:
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v)]
            reference = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, **grouped)
            library = measure(lambda i: torch.autograd.grad(
                reference, leaves, d_out.transpose(1, 2), retain_graph=True),
                calls=calls, warmup=2)
            del reference, leaves
        got = {}
        for name, kernel in kernels.items():
            got[name], again = kernel(), kernel()
            repeat = all_equal(torch, got[name], again)
            del again
            pairs = grad_errors(got[name], wants[name])
            err, tol = worst(pairs)
            notes = {'design': 'wgmma+tma'}
            if name == 'flash_bwd_fused' and 'flash_bwd_fused_g1' in got:
                notes['k2a_equals_k2b'] = all_equal(
                    torch, got['flash_bwd_fused_g1'], got[name])
                if not notes['k2a_equals_k2b']:
                    fail(f'K2a at {shape}: differs from K2b')
            if name == 'flash_bwd_dkv':      # the fused body without dq
                notes['k3b_equals_k2b'] = all_equal(
                    torch, got[name], got['flash_bwd_fused'][1:])
                if not notes['k3b_equals_k2b']:
                    fail(f'K3b at {shape}: dk, dv differ from K2b')
            if name in FUSED_KERNELS:
                notes['ticket_waits'] = flash.fused_ticket_waits(
                    *args, causal=causal)
            if not repeat:
                fail(f'{name} at {shape}: two calls differ')
            timed = measure(lambda i: kernel(), calls=calls, warmup=2)
            bound, flops = backward_bound(name, batch, seq, heads, kv_heads,
                                          head_dim, causal)
            rows.append(record_check(
                f'{name}{suffix}[{label}]', shape, err, tol, timed, plain,
                library, bound, flops=flops,
                by_events=True, causal=causal, lse_cotangent=cotangent,
                bitwise_repeat=repeat,
                grad_errors=[pair[0] for pair in pairs],
                library_call=None if library is None else (
                    'scaled_dot_product_attention backward'
                    + (', causal' if causal else '')
                    + (', enable_gqa' if grouped else '')), **notes))
        split = got['flash_bwd_dq'] + got['flash_bwd_dkv']
        err, tol = worst(grad_errors(split, got['flash_bwd_fused']))
        if err > tol:
            fail(f'split vs fused backward at {shape}: {err} over {tol}')
        del q, k, v, d_out, out, lse, d_lse, delta, args, want, wants, got
        del split
        torch.cuda.empty_cache()
    return rows


def check_train_forward(torch, generator):
    """Phase 3's K1 row: the flash forward at the training shape
    [16, 1024, 12, 64], as the train step runs it, against its plain
    version, timed beside it and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import flash

    shape = [TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM]
    q, k, v = (torch.randn(shape, generator=generator,
                           device='cuda').to(torch.bfloat16)
               for _ in range(3))
    out, lse = flash.flash_attention_lse(q, k, v)
    want_out, want_lse = flash.flash_attention_plain(q, k, v)
    err = (out.float() - want_out.float()).abs().max().item()
    if (lse - want_lse).abs().max().item() > 1e-3:
        fail('flash forward at the training shape: lse over 1e-3')
    elements = TRAIN_BATCH * TRAIN_SEQ * HEADS * HEAD_DIM
    stats = TRAIN_BATCH * TRAIN_SEQ * HEADS * 4           # lse
    # q.k and p.v over the causal pairs
    flops = 2 * 2 * HEAD_DIM * attention_pairs(TRAIN_BATCH, TRAIN_SEQ, HEADS)
    timed = measure(lambda i: flash.flash_attention_lse(q, k, v), calls=20)
    plain = measure(lambda i: flash.flash_attention_plain(q, k, v), calls=5)
    leaves = [t.transpose(1, 2) for t in (q, k, v)]
    with torch.no_grad():
        library = measure(lambda i: F.scaled_dot_product_attention(
            *leaves, is_causal=True), calls=20)
    return [record_check(
        'flash_attention[train]', shape, err, 2e-2, timed, plain, library,
        bound_ms(4 * 2 * elements + stats, flops), flops=flops)]


def grouped_inputs(torch, generator, tokens=TRAIN_BATCH * TRAIN_SEQ,
                   experts=MOE_EXPERTS, k=MOE_K, capacity=None, dim=DIM,
                   hidden=HIDDEN):
    """One MoE layer's operands, by default at the training shape: 16 x
    1024 tokens routed top-2 over 8 experts by the port's own routing
    (capacity 5120, so some choices drop), random bf16 activations and
    weights."""
    from tpusystem_torch.ops import moe

    device, bf16 = torch.device('cuda'), torch.bfloat16
    if capacity is None:
        capacity = moe.expert_capacity(tokens, experts, k, MOE_FACTOR)

    def normal(shape, scale=1.0):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(bf16)

    gates = torch.softmax(torch.randn((tokens, experts),
                                      generator=generator, device=device),
                          -1)
    _, slots, weights, _ = moe.route_top_k_sparse(gates, k, capacity)
    slot_asg, slot_token, _ = moe._invert_seating(
        slots, k, tokens, experts * capacity)
    return dict(tokens=tokens, capacity=capacity, slot_token=slot_token,
                clamped=slot_token.clamp(max=tokens - 1),
                valid=(slot_token < tokens).float(),
                w_slot=moe._take(weights, slot_asg),
                seated=int((slot_token < tokens).sum()),
                x=normal((tokens, dim)), d_out=normal((tokens, dim), 0.01),
                w1=normal((experts, dim, hidden), dim ** -0.5),
                w2=normal((experts, hidden, dim), hidden ** -0.5),
                b2=normal((experts, dim), 0.1),
                grown=normal((experts * capacity, hidden)),
                d_pre=normal((experts * capacity, hidden), 0.01))


def grouped_calls(gm, g):
    """The four calls one MoE layer's training step makes of K6 and K7 (the
    up-projection forward, the down-projection's input gradient, the
    down-projection forward with its bias and saved rows, the
    up-projection's input gradient): ``{name: (kernel, plain, args,
    options)}``."""
    tokens, capacity = g['tokens'], g['capacity']
    return {
        'gather_rows_matmul[fwd]': (
            gm.gather_rows_matmul, gm.gather_rows_matmul_plain,
            (g['x'], g['w1'], g['clamped'], g['valid']),
            dict(rows_per_group=capacity)),
        'gather_rows_matmul[bwd]': (
            gm.gather_rows_matmul, gm.gather_rows_matmul_plain,
            (g['d_out'], g['w2'], g['clamped'], g['w_slot']),
            dict(rows_per_group=capacity, transpose_rhs=True)),
        'matmul_scatter_rows[fwd]': (
            gm.matmul_scatter_rows, gm.matmul_scatter_rows_plain,
            (g['grown'], g['w2'], g['b2'], g['slot_token'], g['w_slot'],
             tokens), dict(rows_per_group=capacity)),
        'matmul_scatter_rows[bwd]': (
            gm.matmul_scatter_rows, gm.matmul_scatter_rows_plain,
            (g['d_pre'], g['w1'], None, g['slot_token'], g['valid'], tokens),
            dict(rows_per_group=capacity, transpose_rhs=True,
                 save_rows=False)),
    }


def grouped_errors(torch, first, again, want, tokens, slot_token):
    """``(bitwise, finite, pairs)`` of one K6 or K7 call's result against
    its plain version: each output's max abs error beside its tolerance
    (rows 2^-7, K7's combined output 2^-5 of the largest plain value) and,
    for K7, whether every token no slot seats came out exactly 0."""
    torch.cuda.synchronize()
    if isinstance(first, tuple):               # K7: (out, rows | None)
        bitwise = all(a is None or torch.equal(a, b)
                      for a, b in zip(first, again))
        (out, saved), (want_out, want_rows) = first, want
        pairs = [((out.float() - want_out.float()).abs().max().item(),
                  2 ** -5 * want_out.float().abs().max().item())]
        if saved is not None:
            pairs.append(((saved.float() - want_rows.float()).abs()
                          .max().item(),
                          2 ** -7 * want_rows.float().abs().max().item()))
        seated = torch.zeros(tokens + 1, dtype=torch.bool, device=out.device)
        seated[slot_token.long()] = True
        if not bool((out[~seated[:tokens]] == 0).all()):
            pairs.append((math.inf, 0.0))       # an unseated token not 0
        return bitwise, torch.isfinite(out.float()).all().item(), pairs
    pairs = [((first.float() - want.float()).abs().max().item(),
              2 ** -7 * want.float().abs().max().item())]
    return (torch.equal(first, again),
            torch.isfinite(first.float()).all().item(), pairs)


def check_grouped_edges(torch, generator) -> dict:
    """Phase 10's edge sweep: K6 and K7 at ``GROUPED_EDGES``' widths (C off
    the 128-row tile, K and N off 64 and off 16 bytes, N under one
    64-column box, one group, k = 4 at full width), each of the four calls
    of a training step against its plain version with a bitwise repeat."""
    from tpusystem_torch.ops.cuda import grouped_matmul as gm

    results = {}
    for tokens, experts, k, capacity, dim, hidden in GROUPED_EDGES:
        g = grouped_inputs(torch, generator, tokens, experts, k, capacity,
                           dim, hidden)
        for name, (kernel, plain, args, options) in grouped_calls(
                gm, g).items():
            label = (f'{name}[{tokens}x{experts}x{k}, C={capacity}, '
                     f'{dim}x{hidden}]')
            bitwise, finite, pairs = grouped_errors(
                torch, kernel(*args, **options), kernel(*args, **options),
                plain(*args, **options), tokens, g['slot_token'])
            err, tol = worst(pairs)
            results[label] = dict(bitwise_repeat=bitwise, finite=finite,
                                  max_abs_err=err, tol=tol)
            if not (finite and bitwise and err <= tol):
                fail(f'grouped edge {label}: {results[label]}')
    print('grouped-edges ' + json.dumps(results))
    return results


def check_grouped(torch, generator):
    """Phase 10: K6 and K7 against their plain versions at the four shapes
    of one MoE layer's training step, each with a bitwise repeat, timed
    beside the plain version, ``torch.bmm`` over the same rows gathered
    into the ``[8, 5120, k]`` buffer beforehand (the product alone: no
    gather, no combine) and the bound, with ``bound_share`` and ``tflops``.
    Flops count the seated rows only (empty slots need no product); bytes
    count each input read once and each output written once. Then K7's
    time split into its grouped product, its combine and the token index
    the wrapper builds (``k7-split``), the edge sweep
    (``grouped-edges``) and ptxas' registers and spills of every
    ``grouped_gemm_kernel`` instantiation (``grouped-ptxas``; a missing or
    spilling one fails). Returns ``(checks, split, ptxas)``."""
    from tpusystem_torch.ops import moe
    from tpusystem_torch.ops.cuda import grouped_matmul as gm
    from tpusystem_torch.ops.cuda._build import LIBRARIES

    ptxas = {name: entry for name, entry in ptxas_report(
        LIBRARIES.compiler_output.get('grouped_matmul', '')).items()
        if 'grouped_gemm_kernel' in name}
    print('grouped-ptxas ' + json.dumps(ptxas or 'not available: the '
                                        'library was built by an earlier '
                                        'process'))
    check_spills('grouped-ptxas', ptxas, GROUPED_INSTANCES)

    g = grouped_inputs(torch, generator)
    tokens, capacity, seated = g['tokens'], g['capacity'], g['seated']
    rows = MOE_EXPERTS * capacity
    ids_bytes = rows * 8                                  # int32 id, f32 scale

    def buffer(src):                      # the dispatch buffer K6 never forms
        return moe._take(src, g['slot_token']).reshape(MOE_EXPERTS, capacity,
                                                       -1)

    cases = {
        'gather_rows_matmul[fwd]': dict(
            library=(buffer(g['x']), g['w1']), shape=[tokens, DIM, HIDDEN],
            moved=tokens * DIM * 2 + g['w1'].numel() * 2 + ids_bytes
            + rows * HIDDEN * 2),
        'gather_rows_matmul[bwd]': dict(
            library=(buffer(g['d_out']), g['w2'].transpose(1, 2)),
            shape=[tokens, DIM, HIDDEN],
            moved=tokens * DIM * 2 + g['w2'].numel() * 2 + ids_bytes
            + rows * HIDDEN * 2),
        'matmul_scatter_rows[fwd]': dict(
            library=(g['grown'].reshape(MOE_EXPERTS, capacity, HIDDEN),
                     g['w2']), shape=[rows, HIDDEN, DIM],
            moved=rows * HIDDEN * 2 + g['w2'].numel() * 2 + MOE_EXPERTS * DIM
            * 2 + ids_bytes + tokens * DIM * 2 + rows * DIM * 2),
        'matmul_scatter_rows[bwd]': dict(
            library=(g['d_pre'].reshape(MOE_EXPERTS, capacity, HIDDEN),
                     g['w1'].transpose(1, 2)), shape=[rows, HIDDEN, DIM],
            moved=rows * HIDDEN * 2 + g['w1'].numel() * 2 + ids_bytes
            + tokens * DIM * 2),
    }
    flops = 2 * seated * DIM * HIDDEN
    results = []
    for name, (kernel, plain, args, options) in grouped_calls(gm, g).items():
        case = cases[name]
        run = lambda i: kernel(*args, **options)
        bitwise, finite, pairs = grouped_errors(
            torch, run(0), run(1), plain(*args, **options), tokens,
            g['slot_token'])
        err, tol = worst(pairs)
        print('grouped-check ' + json.dumps(
            {'name': name, 'bitwise_repeat': bitwise, 'finite': finite,
             'seated_rows': seated, 'buffer_rows': rows,
             'errors': [list(pair) for pair in pairs]}))
        if not finite:
            fail(f'{name}: non-finite output')
        if not bitwise:
            fail(f'{name}: two calls differ')
        lhs, rhs = case['library']
        timed = measure(run, calls=20)
        plain_timed = measure(lambda i: plain(*args, **options), calls=3)
        library = measure(lambda i: torch.bmm(lhs, rhs), calls=20)
        results.append(record_check(
            name, case['shape'], err, tol, timed, plain_timed, library,
            bound_ms(case['moved'], flops), by_events=True, flops=flops,
            design='wgmma+tma', bitwise_repeat=bitwise,
            library_call='torch.bmm over the rows gathered into the '
            '[8, 5120, k] buffer beforehand: the product alone, no gather, '
            'no bias, no combine'))

    # K7's parts at each of its two shapes: the grouped product, the
    # combine over the product's rows, the token -> row index
    split = {}
    for name, (_, _, args, options) in grouped_calls(gm, g).items():
        if not name.startswith('matmul_scatter_rows'):
            continue
        lhs, rhs, bias, row_ids, row_scale, _ = args
        product = dict(rows_per_group=capacity,
                       transpose_rhs=options.get('transpose_rhs', False))
        index = gm.combine_index(row_ids, tokens)
        product_rows = gm._matmul_rows(lhs, rhs, bias, **product)
        parts = {
            'product': measure(lambda i: gm._matmul_rows(lhs, rhs, bias,
                                                         **product),
                               calls=20),
            'combine': measure(lambda i: gm._combine_rows(
                product_rows, row_scale, index, tokens), calls=20),
            'index': measure(lambda i: gm.combine_index(row_ids, tokens),
                             calls=20)}
        whole = dict(results)[name]['ms']
        split[name] = dict(
            whole_ms=whole,
            **{f'{part}_ms': timed[1] for part, timed in parts.items()},
            **{f'{part}_device_ms': timed[0]
               for part, timed in parts.items()},
            index_share=parts['index'][1] / whole)
    print('k7-split ' + json.dumps(split))
    check_grouped_edges(torch, generator)
    return results, split, ptxas


def compare_clones(torch, module, criterion, tokens, field, values,
                   forward=(('train', True),)) -> dict:
    """The loss and full gradient of ``module`` on ``tokens`` with ``field``
    set to ``values[0]``, held against the same weights with ``values[1]``
    (clones of the module that share its parameters); ``forward`` holds the
    keyword arguments of the forward call (a Llama takes none)."""
    params = list(module.parameters())
    results = []
    for value in values:
        clone = module.replace(**{field: value})
        loss = criterion(clone(tokens, **dict(forward)), tokens)
        grads = torch.autograd.grad(loss, params)
        results.append((loss.item(),
                        torch.cat([g.float().flatten() for g in grads])))
    (loss, grad), (reference_loss, reference_grad) = results
    return {'rows': tokens.shape[0], field: list(values), 'loss': loss,
            'reference_loss': reference_loss,
            'grad_cosine': torch.nn.functional.cosine_similarity(
                grad, reference_grad, dim=0).item(),
            'grad_relative_err': ((grad - reference_grad).norm()
                                  / reference_grad.norm()).item()}


def timed_steps(torch, step, state, tokens, steps: int, counters):
    """One warm-up step, then ``steps`` timed ones, every counter of
    ``counters`` set to 0 just before them and read just after; fails unless
    the losses are finite and fall. Returns ``(state, result)``."""
    started = time.perf_counter()
    state, (_, loss) = step(state, tokens, tokens)              # warm-up
    losses = [loss.item()]
    warmup_s = time.perf_counter() - started
    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(steps):
        started = time.perf_counter()
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(loss.item())                        # waits for the step
        seconds.append(time.perf_counter() - started)
    if not all(math.isfinite(value) for value in losses):
        fail(f'non-finite training loss: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'training loss did not fall: {losses}')
    median = sorted(seconds)[len(seconds) // 2]
    return state, dict(
        launches={counter.__name__: counter.launches for counter in counters},
        losses=losses, step_ms=[1e3 * s for s in seconds],
        median_step_ms=1e3 * median, min_step_ms=1e3 * min(seconds),
        max_step_ms=1e3 * max(seconds), warmup_s=warmup_s,
        tokens_per_s=tokens.numel() / median,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        batch=list(tokens.shape), steps=steps)


def check_launches(result, per_step: dict) -> None:
    steps = result['steps']
    for name, count in per_step.items():
        if result['launches'][name] != count * steps:
            fail(f"{name} launched {result['launches'][name]} times in "
                 f'{steps} steps, not {count} per step')


def train_moe(torch, seed: int) -> dict:
    """Phase 11: the 8-expert GPT-2 MoE trains on the fused expert kernels
    (the main path of this slice). Its loss and gradient on 2 rows are held
    against the same weights through the gather impl (no K6/K7: gathers and
    cuBLAS products); both keep bfloat16 activations, so the losses agree
    within a relative 1e-3 and the gradients' cosine is at least 0.999."""
    import numpy as np

    from tpusystem_torch.models import GPT2
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda import grouped_matmul as gm
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       WithAuxLoss, build_train_step,
                                       init_state, module_apply)

    module = GPT2(vocab_size=50304, dropout=0.0, attention='flash',
                  return_features=True, moe_experts=MOE_EXPERTS,
                  moe_every=2, moe_k=MOE_K, moe_capacity_factor=MOE_FACTOR,
                  moe_sparse_impl='fused', device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    criterion = WithAuxLoss(ChunkedNextTokenLoss(chunks=8))
    optimizer = AdamW(lr=3e-4, grad_clip=1.0)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 50257, (TRAIN_BATCH, TRAIN_SEQ)), device='cuda')
    reference = compare_clones(torch, module, criterion, tokens[:2],
                               'moe_sparse_impl', ('fused', 'gather'))
    reference['loss_relative_err'] = (abs(reference['loss']
                                          - reference['reference_loss'])
                                      / abs(reference['reference_loss']))
    print('moe-reference ' + json.dumps(reference))
    if not (math.isfinite(reference['loss'])
            and reference['loss_relative_err'] <= 1e-3
            and reference['grad_cosine'] >= 0.999):
        fail(f'fused MoE train step vs the gather impl: {reference}')

    state = init_state(module, optimizer, rng=seed)
    step = build_train_step(module_apply(module), criterion, optimizer)
    state, result = timed_steps(
        torch, step, state, tokens, MOE_STEPS,
        (gm.gather_rows_matmul, gm.matmul_scatter_rows,
         flash.flash_attention_lse, flash.flash_bwd_fused))
    moe_layers = sum(module.is_moe(i) for i in range(module.layers))
    check_launches(result, {'gather_rows_matmul': 2 * moe_layers,
                            'matmul_scatter_rows': 2 * moe_layers,
                            'flash_attention_lse': module.layers,
                            'flash_bwd_fused': module.layers})
    # moe_ceiling.py's accounting: active params are all params less the
    # (experts - k) idle experts' FFNs per MoE layer; attention 12 S^2 D
    # per layer and row
    params = sum(p.numel() for p in module.parameters())
    per_expert = DIM * HIDDEN * 2 + HIDDEN + DIM
    active = params - moe_layers * (MOE_EXPERTS - MOE_K) * per_expert
    flops = (6 * active * tokens.numel() + 12 * module.layers * HEADS
             * TRAIN_SEQ * TRAIN_SEQ * HEAD_DIM * TRAIN_BATCH)
    profile = profile_steps(torch, lambda: step(state, tokens, tokens),
                            steps=2, top_n=16,
                            sums=('grouped_gemm_kernel', 'combine_rows_kernel'))
    print('moe-train-profile ' + json.dumps(profile))
    return dict(result, params=params, active_params=active,
                flops_per_step=flops, moe_layers=moe_layers,
                mfu=flops / (result['median_step_ms'] / 1e3) / BF16_FLOPS,
                reference=reference, profile=profile)


def train(torch, seed: int) -> dict:
    """Phase 7: GPT-2 125M trains with bench.py's recipe (the main path of
    the dense training slice). First its loss and gradient on 2 rows are
    held against the same weights on plain PyTorch attention (``'xla'``:
    autograd through ``dot_product_attention``, no kernel); both keep
    bfloat16 activations, so the losses agree within 1e-2 and the
    gradients' cosine is above 0.999."""
    import numpy as np

    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    module = gpt2_small(vocab_size=50304, dropout=0.0, attention='flash',
                        return_features=True, device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    criterion = ChunkedNextTokenLoss(chunks=8)
    optimizer = AdamW(lr=3e-4, grad_clip=1.0)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 50257, (TRAIN_BATCH, TRAIN_SEQ)), device='cuda')
    reference = compare_clones(torch, module, criterion, tokens[:2],
                               'attention', ('flash', 'xla'))
    print('train-reference ' + json.dumps(reference))
    if not (math.isfinite(reference['loss'])
            and abs(reference['loss'] - reference['reference_loss']) <= 1e-2
            and reference['grad_cosine'] > 0.999):
        fail(f'flash train step vs plain attention: {reference}')

    state = init_state(module, optimizer, rng=seed)
    step = build_train_step(module_apply(module), criterion, optimizer)
    state, result = timed_steps(
        torch, step, state, tokens, TRAIN_STEPS,
        (flash.flash_attention_lse, flash.flash_bwd_fused))
    check_launches(result, {'flash_attention_lse': module.layers,
                            'flash_bwd_fused': module.layers})
    params = sum(p.numel() for p in module.parameters())
    # 6 N T for the weights; causal attention 12 D per (query, key) pair
    # and head per layer (4 D forward, twice that backward)
    flops = (6 * params * tokens.numel() + 12 * HEAD_DIM * module.layers
             * attention_pairs(TRAIN_BATCH, TRAIN_SEQ, HEADS))
    profile = profile_steps(torch, lambda: step(state, tokens, tokens),
                            steps=2)
    print('train-profile ' + json.dumps(profile))
    return dict(result, params=params, flops_per_step=flops,
                mfu=flops / (result['median_step_ms'] / 1e3) / BF16_FLOPS,
                reference=reference)


def split_step(torch, generator) -> dict:
    """Phase 12: one layer's attention through ``backward='split'``, its
    gradients held against ``'fused'``: at the training shape, and at head
    dim 128 at Llama-3 8B's training row ([1, 8192, 32, 8, 128]). K3a and
    K3b launch once a case."""
    from tpusystem_torch.ops.cuda import flash

    device = torch.device('cuda')
    cases = {'train': (TRAIN_BATCH, TRAIN_SEQ, HEADS, HEADS, HEAD_DIM),
             'd128': (1, LLAMA_TRAIN_SEQ, 32, 8, 128)}
    flash.flash_bwd_dq.launches = flash.flash_bwd_dkv.launches = 0
    results = {}
    for case, (batch, seq, heads, kv_heads, head_dim) in cases.items():
        q, d_out = (torch.randn((batch, seq, heads, head_dim),
                                generator=generator, device=device).to(
                                    torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((batch, seq, kv_heads, head_dim),
                            generator=generator, device=device).to(
                                torch.bfloat16) for _ in range(2))
        grads = {}
        for backward in ('fused', 'split'):
            before = (flash.flash_bwd_dq.launches,
                      flash.flash_bwd_dkv.launches)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash.flash_attention(*leaves, backward=backward)
            grads[backward] = torch.autograd.grad(out, leaves, d_out)
        torch.cuda.synchronize()
        launched = {'flash_bwd_dq': flash.flash_bwd_dq.launches - before[0],
                    'flash_bwd_dkv': flash.flash_bwd_dkv.launches - before[1]}
        err, tol = worst(grad_errors(grads['split'], grads['fused']))
        results[case] = dict(shape=[batch, seq, heads, kv_heads, head_dim],
                             launches=launched, max_abs_err=err, tol=tol)
        if err > tol:
            fail(f'split vs fused gradients, {case}: {err} over {tol}')
        if launched != {'flash_bwd_dq': 1, 'flash_bwd_dkv': 1}:
            fail(f'the split backward launched {launched}, {case}')
    result = dict(launches={'flash_bwd_dq': flash.flash_bwd_dq.launches,
                            'flash_bwd_dkv': flash.flash_bwd_dkv.launches},
                  cases=results)
    print('split-step ' + json.dumps(result))
    return result


def backward_inputs(torch, generator, batch, seq, heads, causal,
                    dropout=0.0, seed=None):
    """bf16 q, k, v and dO ``[batch, seq, heads, 64]``, K1's out and lse of
    them, and the backward's delta."""
    from tpusystem_torch.ops.cuda import flash

    shape = (batch, seq, heads, HEAD_DIM)
    q, k, v, d_out = (torch.randn(shape, generator=generator,
                                  device='cuda').to(torch.bfloat16)
                      for _ in range(4))
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal,
                                         dropout=dropout, seed=seed)
    delta = flash.attention_delta(out, d_out).contiguous()
    return q, k, v, d_out, out, lse, delta


def all_equal(torch, got, want) -> bool:
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(got, want))


def check_long_forward(torch, label, q, k, v, out, lse, causal=True,
                       by_events=True, calls=5):
    """K1's ``out`` and ``lse`` of ``q, k, v`` against the plain forward,
    timed beside it and ``scaled_dot_product_attention`` (with
    ``enable_gqa`` where the kv heads are fewer). The bound counts q, k, v,
    out and lse once, and 4 head_dim flops per visible (query, key) pair.
    ``by_events`` quotes the CUDA-event times (for kernels of
    milliseconds)."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import flash

    want_out, want_lse = flash.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
        fail(f'{label}: non-finite output')
    err = (out.float() - want_out.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    del want_out, want_lse
    if lse_err > 1e-3:
        fail(f'{label}: lse max abs err {lse_err} over 1e-3')
    timed = measure(lambda i: flash.flash_attention_lse(q, k, v,
                                                        causal=causal),
                    calls=calls, warmup=2)
    plain = measure(lambda i: flash.flash_attention_plain(q, k, v,
                                                          causal=causal),
                    calls=2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    grouped = ({'enable_gqa': True} if k.shape[2] != q.shape[2] else {})
    library = measure(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, **grouped), calls=calls, warmup=2)
    batch, seq, heads, head_dim = q.shape
    moved = (2 * q.numel() + 2 * k.numel()) * 2 + batch * seq * heads * 4
    pairs = (attention_pairs(batch, seq, heads) if causal
             else batch * heads * seq * seq)
    return record_check(label, list(q.shape), err, 2e-2, timed, plain,
                        library, bound_ms(moved, 4 * head_dim * pairs),
                        by_events=by_events, flops=4 * head_dim * pairs,
                        lse_err=lse_err,
                        kv_heads=k.shape[2], causal=causal,
                        library_call='scaled_dot_product_attention'
                        + (', causal' if causal else '')
                        + (', enable_gqa' if grouped else ''))


def template_arguments(text: str):
    """``['128', 'true']`` from the Itanium template argument list at the
    head of ``text`` (``ILi128ELb1EE...``): int and bool literals in any
    order and number; None where ``text`` holds no such list."""
    import re

    if not text.startswith('I'):
        return None
    at, arguments = 1, []
    while True:
        literal = re.match(r'L([bijlm])(n?)(\d+)E', text[at:])
        if not literal:
            break
        kind, negative, digits = literal.groups()
        arguments.append({'0': 'false', '1': 'true'}[digits] if kind == 'b'
                         else ('-' if negative else '') + digits)
        at += literal.end()
    return arguments if arguments and text[at:at + 1] == 'E' else None


def ptxas_report(output: str) -> dict:
    """``{kernel: {registers, spill_stores, spill_loads, stack}}`` from one
    ``nvcc -Xptxas -v`` output, kernels by their demangled template name
    (``flash_fwd_kernel<128>``, ``grouped_gemm_kernel<true, false>``)
    where the mangled one carries it."""
    import re

    def demangled(name):
        # the Itanium name read from its start, one length-prefixed part
        # at a time, up to the part that takes template arguments:
        # _Z16flash_fwd_kernelILi128EE.. or
        # _ZN45_GLOBAL__N__<hash>_12_flash_bwd_cu_<hash>22flash_bwd_fused_
        # kernelILi128EEEv... The anonymous namespace's hashes change with
        # the source's path and may hold digits, so the parts are read in
        # order and never searched for.
        at = 3 if name.startswith('_ZN') else 2
        if not name.startswith('_Z'):
            return name
        while True:
            length = re.match(r'\d+', name[at:])
            if not length:
                return name
            at += len(length.group())
            part = name[at:at + int(length.group())]
            at += int(length.group())
            arguments = template_arguments(name[at:])
            if arguments:
                return f"{part}<{', '.join(arguments)}>"

    report, name = {}, None
    for line in output.splitlines():
        # a function's figures follow the line that names it for them
        found = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([^'\s]+)", line)
        if found:
            name = demangled(found.group(1))
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        found = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill '
                          r'stores, (\d+) bytes spill loads', line)
        if found:
            report[name].update(stack=int(found.group(1)),
                                spill_stores=int(found.group(2)),
                                spill_loads=int(found.group(3)))
        found = re.search(r'Used (\d+) registers', line)
        if found:
            report[name]['registers'] = int(found.group(1))
    return report


def check_spills(label: str, report: dict, instances) -> None:
    """Fail if ``report`` (built by this process) lacks one of
    ``instances`` (demangled names, ``flash_fwd_kernel<128>``) or one of
    them spills."""
    if not report:          # built by an earlier process: nothing to read
        return
    for instance in instances:
        entry = report.get(instance)
        if entry is None or entry.get('spill_stores', 1) or entry.get(
                'spill_loads', 1):
            fail(f'{label}: {instance} missing or spilling ({entry})')


def kernel_ptxas(label: str, library: str, instances) -> dict:
    """ptxas' registers and spills of ``instances`` in the build of
    ``csrc/<library>.cu``, printed as ``<label> {...}``; a missing or
    spilling instance fails the run."""
    from tpusystem_torch.ops.cuda._build import LIBRARIES

    report = ptxas_report(LIBRARIES.compiler_output.get(library, ''))
    mine = {name: report[name] for name in instances if name in report}
    print(f'{label} ' + json.dumps(mine or 'not available: the library '
                                   'was built by an earlier process'))
    check_spills(label, report, instances)
    return mine


def check_k1_head_dim_128(torch, generator):
    """Phase 2b: K1 at head dim 128, Llama-3 8B's prefill shapes (32 query
    heads over 8 kv heads) at S = 512, 1024, 4096 and 8192, an MHA case
    [2, 1024, 8, 128], a ragged length (S = 1000) and a non-causal case,
    each against the plain forward (out within 2e-2, lse within 1e-3),
    timed beside it, ``scaled_dot_product_attention`` and the bound; and
    ptxas' registers and spills of every K1 instantiation."""
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda._build import LIBRARIES

    registers = {name: entry for name, entry in ptxas_report(
        LIBRARIES.compiler_output.get('flash_fwd', '')).items()
        if 'flash_fwd_kernel' in name}
    print('k1-ptxas ' + json.dumps(registers or 'not available: the '
                                   'library was built by an earlier process'))
    check_spills('k1-ptxas', registers,
                 [f'flash_fwd_kernel<{d}>' for d in flash.HEAD_DIMS])
    rows = []
    for label, batch, seq, heads, kv_heads, causal in K1_128_CASES:
        q = torch.randn((batch, seq, heads, 128), generator=generator,
                        device='cuda').to(torch.bfloat16)
        k, v = (torch.randn((batch, seq, kv_heads, 128), generator=generator,
                            device='cuda').to(torch.bfloat16)
                for _ in range(2))
        out, lse = flash.flash_attention_lse(q, k, v, causal=causal)
        rows.append(check_long_forward(
            torch, f'flash_attention_d128[{label}]', q, k, v, out, lse,
            causal=causal, by_events=False, calls=10))
        del q, k, v, out, lse
    return rows, registers


def check_long_backward(torch, generator):
    """Phase 4: the flash kernels at the long-context ladder's shapes. K1
    against its plain forward at every point ([4, 4096], [2, 8192] and
    [1, 16384], 12 heads of 64, causal), timed beside it and
    ``scaled_dot_product_attention``. K2a, the fused backward of
    multi-head attention past 1024 keys, at [1, 16384, 12, 64] and
    [4, 4096, 12, 64]: bit for bit K2b (the same kernel through K2b's
    entry) and itself on a repeat, within the gradient tolerance of the
    plain
    backward, timed beside K2b, the plain version and the backward of
    ``scaled_dot_product_attention``; then a non-causal and a ragged case
    through ``flash_attention_bwd``'s routing."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import flash

    rows = []
    for batch, seq in LONG_LADDER:
        q, k, v, d_out, out, lse, delta = backward_inputs(
            torch, generator, batch, seq, HEADS, True)
        rows.append(check_long_forward(
            torch, f'flash_attention[{batch}x{seq}]', q, k, v, out, lse))
        if (batch, seq) not in LONG_KERNEL_SHAPES:
            continue
        args = (q, k, v, d_out, lse, delta)
        got = flash.flash_bwd_fused_g1(*args)
        again = flash.flash_bwd_fused_g1(*args)
        k2b = flash.flash_bwd_fused(*args)
        same_as_k2b, repeat = (all_equal(torch, got, k2b),
                               all_equal(torch, got, again))
        del again, k2b
        want = flash.flash_attention_bwd_plain(q, k, v, out, lse, d_out)
        err, tol = worst(grad_errors(got, want))
        del got, want
        shape = [batch, seq, HEADS, HEAD_DIM]
        print('long-backward-check ' + json.dumps(
            {'shape': shape, 'k2a_equals_k2b': same_as_k2b,
             'bitwise_repeat': repeat, 'max_abs_err': err, 'tol': tol}))
        if not (same_as_k2b and repeat):
            fail(f'K2a at {shape}: equals K2b {same_as_k2b}, repeats '
                 f'{repeat}')
        bound, flops = backward_bound('flash_bwd_fused_g1', batch, seq,
                                      HEADS, HEADS, HEAD_DIM, True)
        waits = flash.fused_ticket_waits(*args)
        timed = measure(lambda i: flash.flash_bwd_fused_g1(*args), calls=5,
                        warmup=2)
        k2b = measure(lambda i: flash.flash_bwd_fused(*args), calls=5,
                      warmup=2)
        plain = measure(lambda i: flash.flash_attention_bwd_plain(
            q, k, v, out, lse, d_out), calls=2, warmup=1)
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        reference = F.scaled_dot_product_attention(*leaves, is_causal=True)
        library = measure(lambda i: torch.autograd.grad(
            reference, leaves, d_out.transpose(1, 2), retain_graph=True),
            calls=5, warmup=2)
        del reference, leaves
        rows.append(record_check(
            f'flash_bwd_fused_g1[{batch}x{seq}]', shape, err, tol, timed,
            plain, library, bound, by_events=True, flops=flops,
            design='wgmma+tma', ticket_waits=waits,
            k2a_equals_k2b=same_as_k2b,
            bitwise_repeat=repeat, k2b_ms=k2b[1], k2b_profiler_ms=k2b[0],
            library_call='scaled_dot_product_attention backward, causal'))
    # the routing: fused MHA past 1024 keys launches K2a, at any length
    for case, (seq, causal) in {'non-causal': (2048, False),
                                'ragged': (4100, True)}.items():
        q, k, v, d_out, out, lse, _ = backward_inputs(torch, generator, 1,
                                                      seq, HEADS, causal)
        d_lse = torch.randn(lse.shape, generator=generator,
                            device='cuda') * 0.1
        before = flash.flash_bwd_fused_g1.launches
        got = flash.flash_attention_bwd(q, k, v, out, lse, d_out, d_lse,
                                        causal=causal)
        launched = flash.flash_bwd_fused_g1.launches - before
        delta = flash.attention_delta(out, d_out, d_lse).contiguous()
        k2b = flash.flash_bwd_fused(q, k, v, d_out, lse, delta,
                                    causal=causal)
        want = flash.flash_attention_bwd_plain(q, k, v, out, lse, d_out,
                                               d_lse, causal=causal)
        err, tol = worst(grad_errors(got, want))
        same = all_equal(torch, got, k2b)
        print('long-backward-check ' + json.dumps(
            {'case': case, 'shape': [1, seq, HEADS, HEAD_DIM],
             'causal': causal, 'k2a_launches': launched,
             'k2a_equals_k2b': same, 'max_abs_err': err, 'tol': tol}))
        if launched != 1 or not same or err > tol:
            fail(f'K2a {case}: launched {launched}, equals K2b {same}, '
                 f'err {err} over {tol}')
    return rows


def dropout_masks(torch, kernel, batch, seq, heads, kv_heads, seed,
                  outputs=('dq', 'dv'), head_dim=HEAD_DIM):
    """The keep masks a backward kernel applied, read from its gradients:
    with q = 0, lse = 0 and delta = 0 every visible P is 1; dO one-hot on
    the rows of q tile t of head h, v all ones and k one-hot on the rows of
    kv tile u make ``dv[j, c] = keep(64 t + c, j) / (1 - p)`` and
    ``dq[i, c] = keep(i, 64 u + c) * scale / (1 - p)``. Returns
    ``{output: int8 [batch, heads, seq, seq]}``."""
    tiles = math.ceil(seq / 64)
    group = heads // kv_heads
    shape = (batch, seq, heads, head_dim)
    masks = {name: torch.full((batch, heads, seq, seq), -1,
                              dtype=torch.int8, device='cuda')
             for name in outputs}
    zeros = torch.zeros(shape, dtype=torch.bfloat16, device='cuda')
    lse = torch.zeros(shape[:3], device='cuda')
    value = torch.ones((batch, seq, kv_heads, head_dim),
                       dtype=torch.bfloat16, device='cuda')
    for t in range(tiles):
        rows = torch.arange(64 * t, min(64 * t + 64, seq), device='cuda')
        for u in range(tiles):
            cols = torch.arange(64 * u, min(64 * u + 64, seq), device='cuda')
            key = torch.zeros_like(value)
            key[:, cols, :, cols - 64 * u] = 1
            for h in range(heads):
                d_out = torch.zeros_like(zeros)
                d_out[:, rows, h, rows - 64 * t] = 1
                grads = dict(zip(outputs, kernel(
                    zeros, key, value, d_out, lse, lse, dropout=DROPOUT,
                    seed=seed)))
                if 'dq' in grads:
                    masks['dq'][:, h, rows[:, None], cols[None, :]] = (
                        grads['dq'][:, rows, h, :len(cols)] != 0).to(
                            torch.int8)
                if 'dv' in grads:
                    masks['dv'][:, h, rows, :] = (
                        grads['dv'][:, :, h // group, :len(rows)] != 0).to(
                            torch.int8).transpose(1, 2)
    return masks


def forward_masks(torch, generator, batch, seq, heads, kv_heads, seed,
                  head_dim=HEAD_DIM):
    """K1's keep masks, read from its output: with q = 0 every visible
    probability of row i is ``1 / (i + 1)``, and v one-hot on the rows of
    kv tile t makes ``out[i, c]`` nonzero iff ``keep(i, 64 t + c)``."""
    from tpusystem_torch.ops.cuda import flash

    mask = torch.full((batch, heads, seq, seq), -1, dtype=torch.int8,
                      device='cuda')
    query = torch.zeros((batch, seq, heads, head_dim), dtype=torch.bfloat16,
                        device='cuda')
    key = torch.randn((batch, seq, kv_heads, head_dim), generator=generator,
                      device='cuda').to(torch.bfloat16)
    for t in range(math.ceil(seq / 64)):
        cols = torch.arange(64 * t, min(64 * t + 64, seq), device='cuda')
        value = torch.zeros_like(key)
        value[:, cols, :, cols - 64 * t] = 1
        out, _ = flash.flash_attention_lse(query, key, value,
                                           dropout=DROPOUT, seed=seed)
        mask[:, :, :, cols] = (out[:, :, :, :len(cols)] != 0).to(
            torch.int8).transpose(1, 2)
    return mask


def mask_mismatches(torch, generator, heads, kv_heads, seed, batch=2,
                    seq=128, head_dim=HEAD_DIM) -> dict:
    """K1, K2a (multi-head only), K2b, K3a and K3b's keep masks at
    ``p = DROPOUT`` and ``head_dim``, read back from their outputs, against
    the plain hash: ``{'kernel.output heads/kv_heads heads': visible entries
    that differ or were not read}`` (``... d128`` at head dim 128), all 0
    when every kernel applies exactly the plain hash's masks (the query
    head's row under GQA)."""
    from tpusystem_torch.ops.cuda import flash

    positions = torch.arange(seq, device='cuda')
    head_rows = torch.arange(batch * heads, device='cuda').reshape(
        batch, heads, 1, 1)
    want = flash.keep_mask(seed, head_rows, positions[:, None],
                           positions[None, :], DROPOUT)
    visible = torch.ones(seq, seq, dtype=torch.bool, device='cuda').tril()

    def count(mask):
        return int((((mask < 0) | (mask.bool() != want)) & visible).sum()
                   .item())

    case = f'{heads}/{kv_heads} heads' + (
        '' if head_dim == HEAD_DIM else f' d{head_dim}')
    mismatches = {f'K1 {case}': count(forward_masks(
        torch, generator, batch, seq, heads, kv_heads, seed, head_dim))}
    kernels = {'K2b': (flash.flash_bwd_fused, ('dq', 'dk', 'dv')),
               'K3a': (flash.flash_bwd_dq, ('dq',)),
               'K3b': (flash.flash_bwd_dkv, ('dk', 'dv'))}
    if heads == kv_heads:
        kernels['K2a'] = (flash.flash_bwd_fused_g1, ('dq', 'dk', 'dv'))
    for name, (kernel, outputs) in kernels.items():
        if name == 'K3a':
            kernel = (lambda *a, _k=kernel, **kw: (_k(*a, **kw),))
        masks = dropout_masks(torch, kernel, batch, seq, heads, kv_heads,
                              seed, outputs, head_dim)
        for output in ('dq', 'dv'):
            if output in masks:
                mismatches[f'{name}.{output} {case}'] = count(masks[output])
    return mismatches


def check_dropout_kernels(torch, generator):
    """Phase 9: the flash kernels at ``p = 0.1``. Each kernel's keep masks,
    read back from its outputs at a small shape (MHA and GQA, two batch
    rows, head dims 64 and 128), equal the plain hash bit for bit; then K1,
    K2a, K2b, K3a and K3b against their plain versions at the dropout
    step's shape (MHA, [16, 1024, 12, 64]), a GQA group of 3 and K2a past
    1024 keys, and K1 timed beside its ``p = 0`` time."""
    from tpusystem_torch.ops.cuda import flash

    seed = 987_654_321
    mismatches = {}
    for heads, kv_heads in ((2, 2), (2, 1)):
        mismatches.update(mask_mismatches(torch, generator, heads, kv_heads,
                                          seed))
    for heads, kv_heads in ((2, 2), (4, 1)):       # head dim 128
        mismatches.update(mask_mismatches(torch, generator, heads, kv_heads,
                                          seed, head_dim=128))
    print('dropout-masks ' + json.dumps(mismatches))
    if any(mismatches.values()):
        fail(f'dropout masks differ from the plain hash: {mismatches}')

    results = {}
    for name, (batch, seq, kv_heads) in DROPOUT_KERNEL_SHAPES.items():
        shape = (batch, seq, HEADS, HEAD_DIM)
        kv_shape = (batch, seq, kv_heads, HEAD_DIM)
        q, k, v, d_out = (torch.randn(s, generator=generator,
                                      device='cuda').to(torch.bfloat16)
                          for s in (shape, kv_shape, kv_shape, shape))
        out, lse = flash.flash_attention_lse(q, k, v, dropout=DROPOUT,
                                             seed=seed)
        want_out, want_lse = flash.flash_attention_plain(
            q, k, v, dropout=DROPOUT, seed=seed)
        errors = {'K1': ((out.float() - want_out.float()).abs().max().item(),
                         2e-2),
                  'K1.lse': ((lse - want_lse).abs().max().item(), 1e-3)}
        want = flash.flash_attention_bwd_plain(q, k, v, out, lse, d_out,
                                               dropout=DROPOUT, seed=seed)
        for backward in ('fused', 'split'):
            label = {'fused': flash.backward_kernels(q, k)[0].__name__,
                     'split': 'flash_bwd_dq+dkv'}[backward]
            got = flash.flash_attention_bwd(q, k, v, out, lse, d_out,
                                            backward=backward,
                                            dropout=DROPOUT, seed=seed)
            errors[label] = worst(grad_errors(got, want))
        results[name] = dict(shape=list(shape), kv_heads=kv_heads,
                             errors=errors)
        for label, (err, tol) in errors.items():
            if not err <= tol:
                fail(f'dropout {label} at {list(shape)}: {err} over {tol}')
    q, k, v, *_ = backward_inputs(torch, generator, TRAIN_BATCH, TRAIN_SEQ,
                                  HEADS, True)
    results['K1_ms'] = {
        'p=0': measure(lambda i: flash.flash_attention_lse(q, k, v),
                       calls=20)[1],
        f'p={DROPOUT}': measure(lambda i: flash.flash_attention_lse(
            q, k, v, dropout=DROPOUT, seed=seed), calls=20)[1],
        'shape': [TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM]}
    print('dropout-kernels ' + json.dumps(results))
    return dict(results, masks=mismatches)


def check_mask_kernel(torch):
    """Phase 9: the threefry dropout-mask kernel at the dropout
    step's activation shape [16, 1024, 768] equals its plain version (the
    integer ops of ``tpusystem_torch.ops.threefry``, run on a CPU copy) bit
    for bit; timed beside the plain version on the card. Its bound counts
    the mask's bytes written once and ~123 32-bit integer operations an
    element (20 rounds of add, two shifts, or and xor; five key injections
    of three adds; the counter split and the uniform's shift, or, subtract
    and compare) over the 67 T/s non-tensor float32 rate, the table's
    nearest row (the int32 units are slower, so the bound is generous)."""
    from tpusystem_torch.ops import threefry
    from tpusystem_torch.ops.cuda import threefry as tf

    shape = (TRAIN_BATCH, TRAIN_SEQ, DIM)
    keep = 1.0 - DROPOUT
    key = threefry.split(threefry.PRNGKey(20_260_101))[1]
    got = tf.bernoulli_mask(key, keep, shape, 'cuda')
    torch.cuda.synchronize()
    want = tf.bernoulli_mask_plain(key, keep, shape, 'cpu')
    mismatches = int((got.cpu() != want).sum())
    keys = threefry.split(key, 8)
    timed = measure(lambda i: tf.bernoulli_mask(keys[i % 8], keep, shape,
                                                'cuda'))
    plain = measure(lambda i: threefry.bernoulli(keys[i % 8], keep, shape,
                                                 'cuda'), calls=5, warmup=1)
    count = TRAIN_BATCH * TRAIN_SEQ * DIM
    memory, compute = count / HBM_BYTES_PER_S, count * 123 / FP32_OPS
    bound = (max(memory, compute) * 1e3,
             'bytes' if memory >= compute else 'operations')
    return record_check('bernoulli_mask', list(shape), mismatches, 0, timed,
                        plain, None, bound,
                        kept_share=got.float().mean().item())


def gpt2_125m(torch, seed: int, **overrides):
    """GPT-2 125M as the training recipes build it (vocab 50304, flash
    attention, features for the chunked loss), random weights from
    ``seed``."""
    from tpusystem_torch.models import gpt2_small

    config = dict(vocab_size=50304, dropout=0.0, attention='flash',
                  return_features=True, device='cuda')
    config.update(overrides)
    module = gpt2_small(**config)
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    return module


def remat_identity(torch, module, criterion, tokens) -> dict:
    """The loss and full gradient of the ``remat`` model on ``tokens``
    against the same weights without ``remat``: the same kernels on the
    same inputs, so they must agree bit for bit."""
    params = list(module.parameters())
    results = []
    for remat in (True, False):
        clone = module.replace(remat=remat)
        loss = criterion(clone(tokens, train=True), tokens)
        grads = torch.autograd.grad(loss, params)
        results.append((loss.detach(), grads))
        del loss
    (loss, grads), (plain_loss, plain_grads) = results
    torch.cuda.synchronize()
    differing = [name for (name, _), a, b in zip(module.named_parameters(),
                                                 grads, plain_grads)
                 if not torch.equal(a, b)]
    return {'tokens': list(tokens.shape), 'loss': loss.item(),
            'no_remat_loss': plain_loss.item(),
            'loss_bitwise': bool(torch.equal(loss, plain_loss)),
            'grads_bitwise': not differing, 'differing': differing[:5]}


def train_long(torch, seed: int) -> dict:
    """Phase 8: the long-context ladder of ``benchmarks/headline_sweep.py``
    (``long``): the GPT-2 125M body with ``max_seq = seq``, ``remat=True``,
    flash attention, the chunked loss over 8 chunks and AdamW with
    clipping, 16,384 tokens a step at (4, 4096), (2, 8192) and (1, 16384).
    First, at (1, 16384), the ``remat`` model's loss and gradient equal the
    model's without it bit for bit. Each point takes one warm-up and
    ``LONG_STEPS`` timed steps on one batch, with falling losses, K2a
    launched once per layer a step, K1 twice (the recomputed forward) and
    K2b never; then a traced window of two steps at (1, 16384)."""
    import numpy as np

    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    criterion = ChunkedNextTokenLoss(chunks=8)
    points, identity, profile = [], None, None
    for batch, seq in sorted(LONG_LADDER, key=lambda point: -point[1]):
        module = gpt2_125m(torch, seed, max_seq=seq, remat=True)
        tokens = torch.as_tensor(np.random.default_rng(seed).integers(
            0, 50257, (batch, seq)), device='cuda')
        if identity is None:
            identity = remat_identity(torch, module, criterion, tokens)
            print('long-remat-identity ' + json.dumps(identity))
            if not (identity['loss_bitwise'] and identity['grads_bitwise']):
                fail(f'remat vs no remat at {[batch, seq]}: {identity}')
        optimizer = AdamW(lr=3e-4, grad_clip=1.0)
        state = init_state(module, optimizer, rng=seed)
        step = build_train_step(module_apply(module), criterion, optimizer)
        state, result = timed_steps(
            torch, step, state, tokens, LONG_STEPS,
            (flash.flash_attention_lse, flash.flash_bwd_fused_g1,
             flash.flash_bwd_fused))
        check_launches(result, {'flash_attention_lse': 2 * module.layers,
                                'flash_bwd_fused_g1': module.layers,
                                'flash_bwd_fused': 0})
        params = sum(p.numel() for p in module.parameters())
        # headline_sweep.py:46-49 (the recompute not counted)
        flops = (6 * params * batch * seq + 12 * module.layers * HEADS
                 * seq * seq * HEAD_DIM * batch)
        point = dict(result, params=params, flops_per_step=flops,
                     mfu=flops / (result['median_step_ms'] / 1e3)
                     / BF16_FLOPS)
        print('long-train ' + json.dumps(point))
        if seq == max(s for _, s in LONG_LADDER):
            profile = profile_steps(torch, lambda: step(state, tokens,
                                                        tokens),
                                    steps=2, top_n=12)
            print('long-train-profile ' + json.dumps(profile))
        points.append(point)
        del module, state, step, optimizer
        torch.cuda.empty_cache()
    return dict(points=points, remat_identity=identity, profile=profile,
                launches={name: sum(point['launches'][name]
                                    for point in points)
                          for name in points[0]['launches']})


def train_dropout(torch, seed: int) -> dict:
    """Phase 9: GPT-2 125M trains with bench.py's recipe (16 x 1024) at
    ``dropout=0.1``: the embeddings, the attention and MLP outputs (masks
    from the threefry kernel, the reference's bits), and the attention
    probabilities inside K1 and K2b. One warm-up and ``DROPOUT_STEPS`` timed
    steps with finite, falling losses, K1 and K2b launched once per layer a
    step, the mask kernel 25 times."""
    import numpy as np

    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda import threefry as tf
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    module = gpt2_125m(torch, seed, dropout=DROPOUT)
    optimizer = AdamW(lr=3e-4, grad_clip=1.0)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 50257, (TRAIN_BATCH, TRAIN_SEQ)), device='cuda')
    state = init_state(module, optimizer, rng=seed)
    step = build_train_step(module_apply(module),
                            ChunkedNextTokenLoss(chunks=8), optimizer)
    state, result = timed_steps(
        torch, step, state, tokens, DROPOUT_STEPS,
        (flash.flash_attention_lse, flash.flash_bwd_fused,
         tf.bernoulli_mask))
    # the masks of the embeddings and of each block's two outputs; the
    # attention probabilities' are hashed inside K1 and K2b
    check_launches(result, {'flash_attention_lse': module.layers,
                            'flash_bwd_fused': module.layers,
                            'bernoulli_mask': 1 + 2 * module.layers})
    return dict(result, dropout=DROPOUT)


def zipf_ids(vocab: int, count: int, seed: int, alpha: float = 1.3):
    """``count`` int32 ids from the truncated Zipf distribution
    ``SyntheticClicks`` draws (id 0 the most frequent)."""
    import numpy as np
    pmf = 1.0 / np.arange(1, vocab + 1) ** alpha
    pmf /= pmf.sum()
    return np.random.default_rng(seed).choice(vocab, size=count,
                                              p=pmf).astype(np.int32)


FOLD_CASES = ('one-id', 'vocab3-head', 'distinct', 'sentinels', 'threshold',
              'threshold-shifted', 'bf16', 'dim8', 'dim130', 'dim512')


def fold_case(case: str, long_min: int, seed: int):
    """``(rows, ids, scale, table_rows)``, CPU tensors, for one case of K9's
    fold sweep (``FOLD_CASES``): 65,536 positions of width 128 with one id
    at every position; the Criteo vocabulary-3 table's Zipf head (~61 % of
    the batch on one id); every id once; ids of 700 with sentinels every
    fifth position and 300 at the end; segments of ``long_min`` - 1,
    ``long_min`` and ``long_min`` + 1 positions (the long path's threshold)
    from position 0 or shifted off the multiples of ``long_min``; and Zipf
    ids over 5,000 rows with sentinels, in bf16 rows and at widths 8, 130
    and 512."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n, dim, dtype, table_rows = 65536, 128, torch.float32, 65536
    if case == 'one-id':
        ids = np.zeros(n, np.int64)
    elif case == 'vocab3-head':
        ids = zipf_ids(3, n, seed).astype(np.int64)
        table_rows = 3
    elif case == 'distinct':
        ids = rng.permutation(n)
    elif case == 'sentinels':
        ids = rng.integers(0, 700, n)
        ids[::5] = table_rows
        ids[-300:] = table_rows + 7
    elif case.startswith('threshold'):
        n = 16 * long_min
        lengths = [1] * (0 if case == 'threshold' else long_min // 2 + 1)
        for length in (long_min - 1, long_min, long_min + 1):
            lengths += [length, 1, length, 3]
        lengths += [1] * (n - sum(lengths))
        ids = rng.permutation(np.repeat(np.arange(len(lengths)), lengths))
        table_rows = n
    elif case in ('bf16', 'dim8', 'dim130', 'dim512'):
        ids = zipf_ids(5000, n, seed).astype(np.int64)
        ids[::97] = 5000
        table_rows = 5000
        if case == 'bf16':
            dtype = torch.bfloat16
        else:
            dim = int(case[3:])
    else:
        raise ValueError(f'unknown fold case {case!r}')
    rows = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    return (rows.to(dtype), torch.from_numpy(ids.astype(np.int32)), scale,
            table_rows)


def lookup_bitwise(torch, label, got, again, want) -> float:
    """Fail unless the kernel's ``got`` equals the plain version's
    ``want`` (computed on a CPU copy of the inputs) bit for bit and the
    kernel's second call ``again`` repeats it. Returns the max abs error."""
    torch.cuda.synchronize()
    host = got.cpu()
    err = (host.float() - want.float()).abs().max().item()
    same, repeats = torch.equal(host, want), torch.equal(got, again)
    print('lookup-check ' + json.dumps({'case': label, 'shape': list(
        got.shape), 'dtype': str(got.dtype), 'bitwise': same,
        'bitwise_repeat': repeats, 'max_abs_err': err}))
    if not torch.isfinite(host.float()).all():
        fail(f'{label}: non-finite output')
    if not same:
        fail(f'{label}: differs from the plain version (max abs err {err})')
    if not repeats:
        fail(f'{label}: two calls differ')
    return err


def check_lookup(torch, generator, seed: int):
    """Phase 13: K8 (``gather_rows``) and K9 (``scatter_add_rows``) against
    their plain versions on a CPU copy of the inputs, bit for bit, each
    with a bitwise repeat: the largest Criteo Kaggle table (10,131,227 x
    128 float32) with 65,536 Zipf ids, through ``dedup_ids`` (unique ids,
    sentinel padding: the DLRM's path) and without it (heavy duplicates);
    the batch-side fold (K9 over ``inverse`` into [65,536, 128]); a bf16
    table; a width off the 16-byte loads. Timed by the profiler's device
    time (a K8 call is shorter than the host's launch of it, so CUDA events
    would time the host) beside the plain version on the card and the
    library calls (``index_select`` times
    the scale for K8, ``torch.zeros`` + ``index_add_`` with float atomics
    for K9), never called by the port. Bounds count bytes: K8 the distinct
    rows read, its output written, ids and scales; K9 its rows, ids and
    scales read and the float32 table written whole (the zero fill), and
    without the fill a row read and write per distinct id."""
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    from tpusystem_torch.recsys import dedup_ids

    device = torch.device('cuda')
    vocab, dim, count = max(CRITEO_KAGGLE), DLRM_DIM, DLRM_BATCH
    table = torch.randn((vocab, dim), generator=generator, device=device)
    table_cpu = table.cpu()
    raw = torch.as_tensor(zipf_ids(vocab, count, seed), device=device)
    reps, inverse = dedup_ids(raw, vocab)
    distinct = int((reps < vocab).sum())
    d_rows = torch.randn((count, dim), generator=generator, device=device)
    weights = torch.rand(count, generator=generator, device=device) + 0.5
    paths = {'dedup': (reps, (reps < vocab).float()), 'dup': (raw, weights)}
    rows, results = [], {}
    for path, (ids, scale) in paths.items():
        clamped = ids.clamp(max=vocab - 1)
        cpu = [t.cpu() for t in (clamped, scale, ids, d_rows)]
        got = el.gather_rows(table, clamped, scale)
        err = lookup_bitwise(torch, f'gather_rows[{path}]', got,
                             el.gather_rows(table, clamped, scale),
                             el.gather_rows_plain(table_cpu, *cpu[:2]))
        read = int(torch.unique(clamped).numel())
        timed = measure(lambda i: el.gather_rows(table, clamped, scale),
                        calls=20)
        plain = measure(lambda i: el.gather_rows_plain(table, clamped,
                                                       scale), calls=20)
        library = measure(lambda i: torch.index_select(
            table, 0, clamped) * scale[:, None], calls=20)
        rows.append(record_check(
            f'gather_rows[{path}]', [count, vocab, dim], err, 0.0, timed,
            plain, library, bound_ms(read * dim * 4 + count * dim * 4
                                     + count * 8, count * dim),
            distinct_rows_read=read,
            library_call='torch.index_select(table, 0, ids) * scale'))

        got = el.scatter_add_rows(d_rows, ids, scale, vocab)
        err = lookup_bitwise(torch, f'scatter_add_rows[{path}]', got,
                             el.scatter_add_rows(d_rows, ids, scale, vocab),
                             el.scatter_add_rows_plain(cpu[3], cpu[2],
                                                       cpu[1], vocab))
        del got
        valid = int((ids < vocab).sum())
        segments = int(torch.unique(ids[ids < vocab]).numel())
        sorted_ids, order = el.sort_ids(ids)
        zeroed = torch.zeros((vocab, dim), device=device)
        kernel = measure(lambda i: el.scatter_add_into(
            zeroed, d_rows, scale, sorted_ids, order), calls=20)
        timed = measure(lambda i: el.scatter_add_rows(d_rows, ids, scale,
                                                      vocab), calls=10)
        plain = measure(lambda i: el.scatter_add_rows_plain(
            d_rows, ids, scale, vocab), calls=10)
        weighted = d_rows * scale[:, None]
        library = measure(lambda i: torch.zeros((vocab, dim), device=device)
                          .index_add_(0, clamped, weighted), calls=10)
        atomics = measure(lambda i: zeroed.index_add_(0, clamped, weighted),
                          calls=20)
        inputs = valid * dim * 4 + count * 8
        without_fill = bound_ms(inputs + 2 * segments * dim * 4,
                                2 * valid * dim)
        rows.append(record_check(
            f'scatter_add_rows[{path}]', [count, vocab, dim], err, 0.0,
            timed, plain, library,
            bound_ms(inputs + vocab * dim * 4, 2 * valid * dim),
            distinct_ids=segments, valid_ids=valid,
            kernel_only_ms=kernel[0], kernel_only_bound_ms=without_fill[0],
            index_add_only_ms=atomics[0],
            library_call='torch.zeros + index_add_ (float atomics)'))
        del zeroed
        results[path] = dict(distinct=segments, valid=valid)

    # the batch-side fold of the dedup path: inverse (heavy duplicates)
    # into [n, dim], the sum of each distinct id's cotangents
    ones = torch.ones(count, device=device)
    got = el.scatter_add_rows(d_rows, inverse, ones, count)
    err = lookup_bitwise(torch, 'scatter_add_rows[fold]', got,
                         el.scatter_add_rows(d_rows, inverse, ones, count),
                         el.scatter_add_rows_plain(d_rows.cpu(),
                                                   inverse.cpu(),
                                                   ones.cpu(), count))
    longest = int(torch.bincount(inverse.long()).max())
    clock = sm_clock_mhz()
    floor = None if clock is None else chain_floor_ms(longest, clock)
    timed = measure(lambda i: el.scatter_add_rows(d_rows, inverse, ones,
                                                  count), calls=20)
    plain = measure(lambda i: el.scatter_add_rows_plain(d_rows, inverse,
                                                        ones, count),
                    calls=20)
    library = measure(lambda i: torch.zeros((count, dim), device=device)
                      .index_add_(0, inverse, d_rows), calls=20)
    rows.append(record_check(
        'scatter_add_rows[fold]', [count, count, dim], err, 0.0, timed,
        plain, library, bound_ms(count * dim * 4 * 2 + count * 8,
                                 2 * count * dim),
        distinct_ids=distinct, longest_segment=longest, sm_clock_mhz=clock,
        chain_floor_ms=floor, chain_floor_share=(
            None if floor is None else floor / timed[0]),
        design=K9_DESIGN,
        library_call='torch.zeros + index_add_ (float atomics)'))
    print('fold-bound ' + json.dumps({
        'bytes_ms': rows[-1][1]['bound_ms'], 'chain_floor_ms': floor,
        'longest_segment': longest, 'sm_clock_mhz': clock,
        'honest_bound_ms': max(rows[-1][1]['bound_ms'], floor or 0.0)}))
    del table, table_cpu

    # a bf16 table, and a width off the 16-byte loads (130 float32)
    for label, (rows_n, width, dtype) in {
            'bf16': (1 << 20, dim, torch.bfloat16),
            'dim130': (1 << 17, 130, torch.float32)}.items():
        small = torch.randn((rows_n, width), generator=generator,
                            device=device).to(dtype)
        ids = torch.as_tensor(zipf_ids(rows_n, count, seed + 1),
                              device=device)
        ids[::97] = rows_n                                  # sentinels
        scale = (ids < rows_n).float() * weights
        clamped = ids.clamp(max=rows_n - 1)
        grads = torch.randn((count, width), generator=generator,
                            device=device).to(dtype)
        cpu = [t.cpu() for t in (small, clamped, scale, grads, ids)]
        lookup_bitwise(torch, f'gather_rows[{label}]',
                       el.gather_rows(small, clamped, scale),
                       el.gather_rows(small, clamped, scale),
                       el.gather_rows_plain(*cpu[:3]))
        lookup_bitwise(torch, f'scatter_add_rows[{label}]',
                       el.scatter_add_rows(grads, ids, scale, rows_n),
                       el.scatter_add_rows(grads, ids, scale, rows_n),
                       el.scatter_add_rows_plain(cpu[3], cpu[4], cpu[2],
                                                 rows_n))
    results.update(longest_fold_segment=longest, sm_clock_mhz=clock,
                   chain_floor_ms=floor,
                   fold_sweep=check_fold_sweep(torch, clock))
    return rows, results


def check_fold_sweep(torch, clock_mhz) -> dict:
    """Phase 13's fold sweep: K9 on every case of ``FOLD_CASES`` bit for
    bit the plain version on the CPU and on a repeat (both of its paths,
    the long-path threshold and one either side of it); the one-id and
    vocabulary-3 cases timed beside ``zeros`` + ``index_add_`` with their
    chain floors."""
    from tpusystem_torch.ops.cuda import embedding_lookup as el

    results = {}
    for case in FOLD_CASES:
        rows, ids, scale, table_rows = fold_case(case, el.LONG_SEGMENT,
                                                 len(case))
        want = el.scatter_add_rows_plain(rows, ids, scale, table_rows)
        on_card = [t.cuda() for t in (rows, ids, scale)]
        got = el.scatter_add_rows(*on_card, table_rows)
        err = lookup_bitwise(torch, f'fold[{case}]', got,
                             el.scatter_add_rows(*on_card, table_rows), want)
        valid = ids[(ids >= 0) & (ids < table_rows)]
        longest = int(torch.bincount(valid.long()).max()) if len(valid) else 0
        entry = dict(shape=list(rows.shape), dtype=str(rows.dtype),
                     table_rows=table_rows, longest_segment=longest,
                     max_abs_err=err)
        if case in ('one-id', 'vocab3-head'):
            weighted = on_card[0].float() * on_card[2][:, None]
            index = on_card[1].long()
            timed = measure(lambda i: el.scatter_add_rows(*on_card,
                                                          table_rows),
                            calls=10)
            library = measure(lambda i: torch.zeros(
                (table_rows, rows.shape[1]), device='cuda').index_add_(
                    0, index, weighted), calls=10)
            floor = (None if clock_mhz is None
                     else chain_floor_ms(longest, clock_mhz))
            entry.update(ms=timed[0], library_ms=library[0],
                         chain_floor_ms=floor)
        results[case] = entry
        del got, on_card
    print('fold-sweep ' + json.dumps(results))
    return results


def dlrm_card_vs_cpu(torch) -> dict:
    """``dlrm_tiny`` on the card against the same weights on the CPU (the
    plain versions): one SGD step on a 64-row click batch with multi-hot
    ids, the loss within 1e-5 and every parameter after the step within
    1e-5 (float32 sums in another order)."""
    from tpusystem_torch.data import SyntheticClicks
    from tpusystem_torch.models import dlrm_tiny
    from tpusystem_torch.train import (SGD, BCEWithLogitsLoss,
                                       build_train_step, init_state,
                                       module_apply)

    features, labels = SyntheticClicks(samples=64, seed=1)[slice(0, 64)]
    weights = dlrm_tiny(device='cpu').state_dict()
    results = {}
    for device in ('cuda', 'cpu'):
        module = dlrm_tiny(device=device)
        module.load_state_dict(weights)
        optimizer = SGD(lr=0.5)
        state = init_state(module, optimizer)
        step = build_train_step(module_apply(module), BCEWithLogitsLoss(),
                                optimizer)
        batch = {key: torch.as_tensor(value, device=device)
                 for key, value in features.items()}
        state, (_, loss) = step(state, batch, torch.as_tensor(
            labels, device=device))
        results[device] = (loss.item(), {name: p.detach().cpu() for name, p
                                         in state.params.items()})
    (loss, params), (cpu_loss, cpu_params) = results['cuda'], results['cpu']
    err = max((params[name] - cpu_params[name]).abs().max().item()
              for name in params)
    result = dict(loss=loss, cpu_loss=cpu_loss, param_max_abs_err=err)
    print('dlrm-reference ' + json.dumps(result))
    if not (abs(loss - cpu_loss) <= 1e-5 and err <= 1e-5):
        fail(f'dlrm_tiny on the card vs the CPU: {result}')
    return result


def repeat_step(torch, step, state, features, labels) -> dict:
    """Run ``step`` twice from the same state on the same batch; the
    parameters after each must be equal bit for bit. The state before and
    the parameters after the first run wait in host memory (the tables fill
    a fifth of the card)."""
    params = state.params
    before = {name: p.detach().cpu() for name, p in params.items()}
    count = state.opt_state['count'].clone()
    step(state, features, labels)
    first = {name: p.detach().cpu() for name, p in params.items()}
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(before[name])
    state.opt_state['count'].copy_(count)
    del before
    step(state, features, labels)
    differ = [name for name, p in params.items()
              if not torch.equal(p.detach().cpu(), first[name])]
    result = dict(bitwise=not differ, differing_params=differ)
    print('dlrm-repeat ' + json.dumps(result))
    if differ:
        fail(f'a repeated DLRM step from the same state differs in {differ}')
    return result


class Recommender(Aggregate):
    """The DLRM as an aggregate, as ``examples/tinysys``'s ``Classifier``
    is the MLP's: the network (a child module), its criterion, optimizer
    and train state, identified by the network's registry hash. ``fit`` is
    one train step (the state advances in place); every epoch assignment
    commits the domain events."""

    def __init__(self, network, criterion, optimizer, state):
        super().__init__()
        self.network = network
        self.criterion, self.optimizer, self.state = (criterion, optimizer,
                                                      state)
        self.epoch = 0                  # first assignment: no onepoch()
        self._step = build_train_step(module_apply(network), criterion,
                                      optimizer)

    @property
    def id(self) -> str:
        return gethash(self.network)

    def fit(self, features, labels):
        """One step; returns the loss on the device."""
        self.state, (_, loss) = self._step(self.state, features, labels)
        return loss

    def onepoch(self) -> None:
        self.events.commit()


def compose_recommender(torch, factory, arguments: dict, holdout, *,
                        device: str, seed: int, lr: float, batch: int,
                        counters=()):
    """Phase 14's composition root, the port's host layers end to end.

    A ``Compiler`` builds the :class:`Recommender`: ``factory(**arguments)``
    on the device, weights redrawn from a generator seeded ``seed`` there,
    then SGD at ``lr``, ``BCEWithLogitsLoss`` and the train state; its steps
    take the device and the seed by ``Depends``. A one-process ``Runtime``
    with its ledger carries the phase's events to a collector and to
    ``evaluation_consumer`` (the holdout in batches of ``batch``), which
    answers each ``Trained`` of this model with ``RecsysEvaluated``. The
    ``train`` handler of a ``Service`` runs one warm-up step, sets every
    counter of ``counters`` to 0, times each later step on the host clock,
    reads the counters, dispatches one ``Trained`` and ends the epoch.
    Returns ``(model, service, runtime, events)``."""
    from tpusystem_torch.data import Loader
    from tpusystem_torch.observe.events import RecsysEvaluated, Trained
    from tpusystem_torch.recsys import RecsysEvaluator, evaluation_consumer
    from tpusystem_torch.services import Consumer, Service
    from tpusystem_torch.train import SGD, BCEWithLogitsLoss, init_state

    def build_device():
        raise NotImplementedError('the composition root gives the device')

    def build_seed():
        raise NotImplementedError('the composition root gives the seed')

    compiler = Compiler()

    @compiler.step
    def build(factory, arguments, device=Depends(build_device)):
        return factory(**arguments, device=device)

    @compiler.step
    def initialize(network, device=Depends(build_device),
                   seed=Depends(build_seed)):
        network.init_weights(torch.Generator(device).manual_seed(seed))
        return network

    @compiler.step
    def assemble(network, seed=Depends(build_seed)):
        optimizer = SGD(lr=lr)
        return Recommender(network, BCEWithLogitsLoss(), optimizer,
                           init_state(network, optimizer, rng=seed))

    compiler.dependency_overrides[build_device] = lambda: device
    compiler.dependency_overrides[build_seed] = lambda: seed
    model = compiler.compile(factory, arguments)

    runtime = Runtime(ledger=True)
    events = []
    collector = Consumer('collector')
    for kind in (Trained, RecsysEvaluated):
        collector.register(kind, events.append)
    evaluator = RecsysEvaluator(model.network,
                                Loader(holdout, batch, device=device))
    runtime.producer.register(collector, evaluation_consumer(
        evaluator, producer=runtime.producer, subject=model.id))
    service = Service()

    @service.handler
    def train(model, batches):
        features, labels = next(batches)
        started = time.perf_counter()
        losses = [model.fit(features, labels).item()]         # warm-up
        warmup_s = time.perf_counter() - started
        for counter in counters:
            counter.launches = 0
        seconds = []
        for features, labels in batches:
            started = time.perf_counter()
            losses.append(model.fit(features, labels).item())  # waits
            seconds.append(time.perf_counter() - started)
        launches = {counter.__name__: counter.launches
                    for counter in counters}
        runtime.producer.dispatch(Trained(model, {'loss': losses[-1]}))
        model.epoch += 1
        runtime.sync()
        return dict(losses=losses, seconds=seconds, warmup_s=warmup_s,
                    launches=launches, batch=(features, labels),
                    stop=runtime.should_stop(False))

    return model, service, runtime, events


def check_host(model, runtime, events, phase, holdout, batch: int) -> dict:
    """The host layers' checks after the ``train`` handler: one ``Trained``
    and one ``RecsysEvaluated`` of this model, in that order; the
    consumer's metrics floats and bit for bit a direct evaluator run on the
    same state; the ledger counting both; no stop; then a
    ``StopIteration`` enqueued on the aggregate unwinds out of the epoch
    assignment, and the collective verdict is to stop."""
    from tpusystem_torch.data import Loader
    from tpusystem_torch.recsys import RecsysEvaluator

    names = [type(event).__name__ for event in events]
    if names != ['Trained', 'RecsysEvaluated'] or any(
            event.model is not model for event in events):
        fail(f'the train phase dispatched {names}, not one Trained and '
             'one RecsysEvaluated of its model')
    metrics = events[1].metrics
    device = next(model.network.parameters()).device
    direct = RecsysEvaluator(model.network, Loader(
        holdout, batch, device=device)).run(model.state)
    if (sorted(metrics) != ['auc', 'loss']
            or any(type(value) is not float for value in metrics.values())
            or metrics != direct):
        fail(f'evaluation_consumer gave {metrics}, a direct run {direct}')
    if runtime.ledger.count != len(events):
        fail(f'the ledger counted {runtime.ledger.count} events, the '
             f'collector {len(events)}')
    if phase['stop'] or model.epoch != 1:
        fail(f"after the phase: stop {phase['stop']}, epoch {model.epoch}")
    model.events.enqueue(StopIteration)
    unwound = False
    try:
        model.epoch += 1
    except StopIteration:
        unwound = True
    if not unwound or model.epoch != 2:
        fail('a StopIteration enqueued on the aggregate did not unwind out '
             'of its epoch assignment')
    stop = runtime.should_stop(unwound)
    if stop is not True:
        fail(f'the runtime did not agree to stop: {stop}')
    return dict(events={name: names.count(name) for name in names},
                ledger_count=runtime.ledger.count,
                ledger_digest=runtime.ledger.digest, metrics=metrics,
                direct_metrics_equal=metrics == direct,
                early_stop_unwound=unwound, should_stop=stop,
                epoch=model.epoch, id=model.id)


def train_dlrm(torch, seed: int) -> dict:
    """Phase 14: the DLRM at MLPerf's widths (NVIDIA DeepLearningExamples'
    PyTorch recipe: 13 dense features, 26 tables of dim 128, bottom MLP
    512-256-128, top MLP 1024-1024-512-256-1, dot interaction) over the
    Criteo Kaggle cardinalities (33,762,577 rows, 17.3 GB of float32
    tables), batch 65,536 one-hot, trained with SGD through the port's host
    layers (:func:`compose_recommender`): the main path of this slice.
    Batches come from the port's ``Loader`` over ``SyntheticClicks``
    (truncated Zipf, alpha 1.3). One warm-up and DLRM_STEPS timed steps
    whose losses must fall, K8 launched once per table per step and K9
    twice (the table gradient and the batch-side fold); the phase's events
    (:func:`check_host`); a repeated step from the same state equal bit for
    bit; a holdout AUC; a traced window of two steps. The peak memory is
    the train handler's (its warm-up, its steps and the holdout
    evaluation that its ``Trained`` starts)."""
    import gc

    from tpusystem_torch.data import Loader, SyntheticClicks
    from tpusystem_torch.models import DLRM
    from tpusystem_torch.ops.cuda import embedding_lookup as el

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reference = dlrm_card_vs_cpu(torch)
    started = time.perf_counter()
    clicks = dict(vocabs=CRITEO_KAGGLE, hot=1, dense=13, seed=0)
    holdout = SyntheticClicks(samples=DLRM_BATCH * 2, train=False, **clicks)
    counters = (el.gather_rows, el.scatter_add_rows)
    model, service, runtime, events = compose_recommender(
        torch, DLRM, dict(vocabs=CRITEO_KAGGLE, dim=DLRM_DIM,
                          dense_features=13, bottom=(512, 256),
                          top=(1024, 1024, 512, 256)), holdout,
        device='cuda', seed=seed, lr=DLRM_LR, batch=DLRM_BATCH,
        counters=counters)
    data = SyntheticClicks(samples=DLRM_BATCH * (1 + DLRM_STEPS), **clicks)
    setup_s = time.perf_counter() - started
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase = service.handle('train', model, iter(
        Loader(data, DLRM_BATCH, shuffle=True, seed=seed)))
    peak = torch.cuda.max_memory_allocated()
    losses, seconds, launches = (phase['losses'], phase['seconds'],
                                 phase['launches'])
    steps, tables = len(seconds), len(CRITEO_KAGGLE)
    if not all(math.isfinite(value) for value in losses):
        fail(f'non-finite DLRM loss: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'DLRM loss did not fall: {losses}')
    if steps != DLRM_STEPS or launches != {
            'gather_rows': tables * steps,
            'scatter_add_rows': 2 * tables * steps}:
        fail(f'{steps} DLRM steps launched {launches}')
    median = sorted(seconds)[len(seconds) // 2]
    host = check_host(model, runtime, events, phase, holdout, DLRM_BATCH)
    host.update(median_step_ms=1e3 * median, min_step_ms=1e3 * min(seconds),
                max_step_ms=1e3 * max(seconds),
                samples_per_s=DLRM_BATCH / median)
    print('dlrm-host ' + json.dumps(host))
    metrics = host['metrics']
    print('dlrm-eval ' + json.dumps(metrics))
    if not (math.isfinite(metrics['loss']) and 0.0 <= metrics['auc'] <= 1.0):
        fail(f'DLRM holdout metrics: {metrics}')
    features, labels = phase['batch']
    repeat = repeat_step(torch, lambda state, *batch: model.fit(*batch),
                         model.state, features, labels)
    profile = profile_steps(torch, lambda: model.fit(features, labels),
                            steps=2, top_n=16,
                            sums=('segment_fold_kernel',
                                  'stage_products_kernel'))
    profile['folds'] = dlrm_folds(torch, features, seed)
    print('dlrm-train-profile ' + json.dumps(profile))
    runtime.close()
    # the least a dense-gradient SGD step moves through the tables: the
    # gradient's zero fill, then the parameters and gradients read and the
    # parameters written; the port's SGD also writes and reads -lr * g
    table_bytes = sum(CRITEO_KAGGLE) * DLRM_DIM * 4
    return dict(
        launches=launches, launches_per_step={
            name: count / steps for name, count in launches.items()},
        losses=losses, step_ms=[1e3 * s for s in seconds],
        median_step_ms=1e3 * median, min_step_ms=1e3 * min(seconds),
        max_step_ms=1e3 * max(seconds), warmup_s=phase['warmup_s'],
        setup_s=setup_s, samples_per_s=DLRM_BATCH / median,
        peak_memory_bytes=peak, batch=DLRM_BATCH, steps=steps, lr=DLRM_LR,
        params=sum(p.numel() for p in model.network.parameters()),
        table_bytes=table_bytes, step_table_bytes_least=4 * table_bytes,
        hbm_bound_ms=4 * table_bytes / HBM_BYTES_PER_S * 1e3,
        step_table_bytes_port=6 * table_bytes, holdout=metrics,
        host=host, repeat=repeat, reference=reference, profile=profile)


def dlrm_folds(torch, features, seed: int) -> dict:
    """The device ms of one DLRM step's 26 batch-side folds (K9 over each
    table's dedup ``inverse`` into [n, 128], as ``recsys.lookup``'s
    backward runs them), replayed on the step's batch: one timed call runs
    all 26. The step's K9 time by kernel name (``kernel_ms_per_step``)
    also holds the 26 table-gradient scatters."""
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    from tpusystem_torch.recsys import dedup_ids

    inverses = []
    for table, vocab in enumerate(CRITEO_KAGGLE):
        flat = features['ids'][:, table].reshape(-1).to(torch.int32)
        sent = torch.where((flat >= 0) & (flat < vocab), flat,
                           torch.full_like(flat, vocab))
        inverses.append(dedup_ids(sent, vocab)[1])
    count = inverses[0].shape[0]
    generator = torch.Generator('cuda').manual_seed(seed)
    d_rows = torch.randn((count, DLRM_DIM), generator=generator,
                         device='cuda')
    ones = torch.ones(count, device='cuda')
    timed = measure(lambda i: [el.scatter_add_rows(d_rows, inverse, ones,
                                                   count)
                               for inverse in inverses], calls=5)
    return dict(fold_ms_per_step=timed[0], fold_event_ms_per_step=timed[1],
                folds=len(inverses), longest_segment=max(
                    int(torch.bincount(inverse.long()).max())
                    for inverse in inverses))


def profile_steps(torch, step, steps: int = 4, top_n: int = 8,
                  sums=()) -> dict:
    """Where a step's time goes: a traced window of ``steps`` calls of
    ``step()`` (tracing slows the host, so the step time of the untraced run
    is the one to quote). Device busy share = summed kernel time over the
    window's wall time; the rest is the card waiting on the host. For each
    name in ``sums``, the device ms a step of every kernel whose name holds
    it."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as profile:
        started = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
    kernels, launches = {}, 0
    for event in profile.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernels[event.key] = getattr(event, 'self_device_time_total', 0.0)
            launches += event.count
    # the host operators that launched the device time, by input shape
    # (ctypes-launched kernels have no host operator and do not appear)
    operators = {}
    for event in profile.key_averages(group_by_input_shape=True):
        if event.device_type == torch.autograd.DeviceType.CPU:
            device_us = getattr(event, 'self_device_time_total', 0.0)
            if device_us > 0:
                operators[f'{event.key} {event.input_shapes}'[:90]] = device_us
    busy_us = sum(kernels.values())

    def top(table):
        ranked = sorted(table.items(), key=lambda item: -item[1])[:top_n]
        return {name[:90]: us / steps for name, us in ranked}

    return dict(steps=steps, traced_step_ms=1e3 * wall / steps,
                device_ms_per_step=busy_us / 1e3 / steps,
                device_busy_share=busy_us / 1e6 / wall,
                device_ops_per_step=launches / steps,
                top_kernels_us_per_step=top(kernels),
                top_operators_us_per_step=top(operators),
                kernel_ms_per_step={name: sum(
                    us for key, us in kernels.items() if name in key)
                    / 1e3 / steps for name in sums})


def serving_prompts(seed: int, vocab: int) -> list:
    """The eight requests of the serving phases, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)) for n in PROMPT_LENGTHS]


def drive_engine(torch, engine, prompts, profile_at: int | None = None
                 ) -> dict:
    """Admit every prompt (``MAX_NEW`` tokens each), then step until every
    request has finished by length with in-vocabulary tokens: the tokens
    of each request in prompt order, each admission's seconds (prefill and
    seating, synchronised: the time to first token), the untraced steps'
    seconds, and the run's step and token counts. ``profile_at`` traces
    four steps (not counted) after that many."""
    vocab = engine._decoder.vocab_size
    torch.cuda.synchronize()
    started = time.perf_counter()
    seated, admissions = [], []
    for prompt in prompts:
        admitted = time.perf_counter()
        admission = engine.admit(prompt, MAX_NEW)
        torch.cuda.synchronize()
        admissions.append(time.perf_counter() - admitted)
        if admission.finished:
            fail(f'request in row {admission.row} finished at admission')
        seated.append(admission.row)
    admit_seconds = time.perf_counter() - started
    finished, step_seconds, emitted, profile = {}, [], 0, None
    while engine.active_rows:
        if len(step_seconds) == profile_at:
            profile = profile_steps(torch, engine.step)
        report = engine.step()
        step_seconds.append(engine.last_step_seconds)
        emitted += sum(len(tokens) for tokens in report.emitted.values())
        for row, reason, tokens in report.finished:
            finished[row] = (reason, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    if len(finished) != len(prompts):
        fail(f'{len(finished)} of {len(prompts)} requests finished')
    for row, (reason, tokens) in finished.items():
        if reason != 'length' or len(tokens) != MAX_NEW or not all(
                0 <= t < vocab for t in tokens):
            fail(f'row {row}: {reason}, {len(tokens)} tokens')
    steps = len(step_seconds)
    return dict(tokens=[finished[row][1] for row in seated], steps=steps,
                decode_tokens=emitted,
                decode_tokens_per_s=emitted / sum(step_seconds),
                step_ms=1e3 * sum(step_seconds) / steps,
                step_ms_quantiles=[1e3 * q for q in quantiles(step_seconds)],
                admission_s=admissions,
                prefill_s=engine.timings['prefill'], admit_s=admit_seconds,
                wall_s=wall, **({} if profile is None else
                                {'profile': profile}))


def quantiles(values) -> list:
    """``[min, median, p90, max]`` of ``values``."""
    ranked = sorted(values)
    pick = lambda share: ranked[min(len(ranked) - 1,
                                    int(share * (len(ranked) - 1) + 0.5))]
    return [ranked[0], pick(0.5), pick(0.9), ranked[-1]]


def logit_probe(torch, engine, prompts) -> dict:
    """Seat ``prompts`` and hold one decode step's logits through the fused
    kernels against the module path on the same state. The two paths round
    at different points (the module rounds each dense product before its
    bias, the kernels once after it): a few bfloat16 steps per layer,
    summed over 12 layers, of logits of order 1, so the tolerance is 2**-4
    of the largest logit."""
    for prompt in prompts:
        engine.admit(prompt, MAX_NEW)
    fused = engine.next_logits('fused')
    module_path = engine.next_logits('flax')
    torch.cuda.synchronize()
    if not (torch.isfinite(fused).all() and fused.shape == (
            ROWS, engine._decoder.vocab_size)):
        fail('fused step logits are not finite [rows, vocab]')
    err = (fused - module_path).abs().max().item()
    tol = 2 ** -4 * module_path.abs().max().item()
    if err > tol:
        fail(f'fused vs module logits: max abs err {err} over {tol}')
    return dict(logit_max_abs_err=err, logit_tol=tol,
                argmax_agreement=(fused.argmax(-1) == module_path.argmax(-1)
                                  ).float().mean().item())


def serve(torch, seed: int):
    """Phase 5: GPT-2 125M through the paged Engine (the main path)."""
    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.serve import Engine

    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK)
    if engine.decode_impl != 'fused':
        fail(f"the engine chose decode_impl={engine.decode_impl!r} on the "
             "card, not 'fused'")
    prompts = serving_prompts(seed, module.vocab_size)
    counters = (dm.decode_matmul, dm.decode_ffn, flash.flash_attention_lse)
    dm.reset_launches()
    flash.flash_attention_lse.launches = 0
    run = drive_engine(torch, engine, prompts)
    launches = {counter.__name__: counter.launches for counter in counters}
    for name, count in launches.items():
        if count == 0:
            fail(f'{name} was not launched on the main path')
    probe = logit_probe(torch, engine, prompts)
    print('step-profile ' + json.dumps(profile_steps(torch, engine.step)))
    return dict(run, **probe, launches=launches,
                prompt_lengths=list(PROMPT_LENGTHS), max_new=MAX_NEW)


def serve_quantized(torch, seed: int, bf16_tokens: list) -> dict:
    """Phase 6, part 2: GPT-2 125M (phase 5's weights and requests) through
    the paged Engine at ``stream_dtype='int8'``, then ``'fp8'`` (the main
    path of this slice): the int8 / fp8 K4 and K5 must launch and the bf16
    ones must not; one fused step's logits agree with the module path on
    the same quantized state within phase 5's tolerance. Prints decode
    tokens/s, step ms and the share of tokens equal to the bf16 run's."""
    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.serve import Engine

    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    prompts = serving_prompts(seed, module.vocab_size)
    results = {}
    for mode in ('int8', 'fp8'):
        engine = Engine(module, None, rows=ROWS, block_size=BLOCK,
                        stream_dtype=mode)
        if engine.decode_impl != 'fused':
            fail(f'the {mode} engine chose decode_impl='
                 f"{engine.decode_impl!r} on the card, not 'fused'")
        dm.reset_launches()
        run = drive_engine(torch, engine, prompts)
        launches = {f'{kernel.__name__}_{mode}': kernel.mode_launches[mode]
                    for kernel in (dm.decode_matmul, dm.decode_ffn)}
        if not all(launches.values()) or any(
                kernel.mode_launches['bf16']
                for kernel in (dm.decode_matmul, dm.decode_ffn)):
            fail(f'{mode} serving launched {launches} narrow and '
                 f'{dm.decode_matmul.mode_launches} K4 kernels')
        pairs = [(a, b) for got, want in zip(run['tokens'], bf16_tokens)
                 for a, b in zip(got, want)]
        probe = logit_probe(torch, engine, prompts)
        profile = profile_steps(torch, engine.step)
        results[mode] = dict(
            run, **probe, launches=launches, profile=profile,
            equal_to_bf16=sum(a == b for a, b in pairs) / len(pairs),
            first_token_equal_to_bf16=sum(
                got[0] == want[0] for got, want in zip(run['tokens'],
                                                       bf16_tokens)) / len(
                                                           prompts))
        del results[mode]['tokens']
        print(f'serve-{mode} ' + json.dumps(results[mode]))
        del engine
    return results


def llama_probe(torch, engine, module, prompt) -> dict:
    """The logits through the paged cache of one request, at its prefill's
    last position and at its first ``LLAMA_PROBE_STEPS`` decode steps
    (``Engine.next_logits``), held against the model's own non-cached
    forward (``decode=False``, xla attention, no kernel) over the prompt and
    the tokens so far. Both run the same bf16 weights; they round at other
    points (K1 and the paged read against one einsum attention, the prefill
    padded to its bucket), and a bfloat16 step here and there, carried
    through 32 residual blocks, reaches logits of order 1: the tolerance is
    2**-4 of the largest logit, GPT-2's probe's."""
    full = module.replace(decode=False, attention='xla')
    tokens = [int(t) for t in prompt]
    with torch.no_grad():
        got = [engine._prefill(prompt)[0]]
    admission = engine.admit(prompt, MAX_NEW)
    tokens.append(admission.token)
    pairs = []
    for step in range(LLAMA_PROBE_STEPS + 1):
        if step:
            got = [engine.next_logits()[admission.row]]
            tokens += engine.step().emitted[admission.row]
        with torch.no_grad():
            want = full(torch.as_tensor([tokens[:len(tokens) - 1]],
                                        device=module.device))[0, -1]
        torch.cuda.synchronize()
        if not (torch.isfinite(got[0]).all()
                and got[0].shape == want.shape):
            fail('Llama probe: logits not finite [vocab]')
        err = (got[0] - want).abs().max().item()
        tol = 2 ** -4 * want.abs().max().item()
        pairs.append((err, tol, bool(got[0].argmax() == want.argmax())))
    for err, tol, _ in pairs:
        if err > tol:
            fail(f'Llama probe: logits through the cache vs the full forward '
                 f'max abs err {err} over {tol}')
    engine.evict(admission.row)
    return dict(probe_prompt=len(prompt),
                probe_max_abs_err=[err for err, _, _ in pairs],
                probe_tol=[tol for _, tol, _ in pairs],
                probe_argmax_equal=[same for _, _, same in pairs])


def serve_llama(torch, seed: int) -> dict:
    """Phase 15: Llama-3 8B (``llama3_8b``, full width, 32 layers, random
    weights from ``seed``) through ``Engine(rows=8, block_size=16)``: the
    route resolves to the module paged step, eight requests of 20 to 7,000
    prompt tokens (buckets 32, 512 ... 8192) take 32 new tokens each, K1
    launches once a layer for each prefill of 512 tokens or more and K4/K5
    never; then the logits probe and a traced window of 4 decode steps.
    ``serving_peak_bytes`` is the peak of the serving run;
    ``peak_bytes`` adds the probe's (``next_logits`` clones the pool, and
    the full forward casts the float32 masters per use)."""
    import gc

    import numpy as np

    from tpusystem_torch.models import llama3_8b
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.serve import Engine

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    module = llama3_8b(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    if engine.decode_impl != 'flax':
        fail(f'the Llama engine chose decode_impl={engine.decode_impl!r}, '
             "not 'flax' (the module paged step)")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, module.vocab_size, (n,))
               for n in LLAMA_PROMPT_LENGTHS]
    buckets = [engine.bucket(len(prompt)) for prompt in prompts]
    dm.reset_launches()
    flash.flash_attention_lse.launches = 0
    run = drive_engine(torch, engine, prompts, profile_at=8)
    serving_peak = torch.cuda.max_memory_allocated()
    launches = {'flash_attention_lse': flash.flash_attention_lse.launches,
                'decode_matmul': dm.decode_matmul.launches,
                'decode_ffn': dm.decode_ffn.launches}
    flashed = module.layers * sum(bucket >= 512 for bucket in buckets)
    if launches != {'flash_attention_lse': flashed, 'decode_matmul': 0,
                    'decode_ffn': 0}:
        fail(f'Llama serving launched {launches}; expected K1 {flashed} '
             'times and K4/K5 never')
    probe = llama_probe(torch, engine, module,
                        prompts[LLAMA_PROMPT_LENGTHS.index(LLAMA_PROBE)])
    del run['tokens']
    return dict(run, **probe, launches=launches, buckets=buckets,
                prompt_lengths=list(LLAMA_PROMPT_LENGTHS), max_new=MAX_NEW,
                ttft_s_by_bucket=dict(zip(map(str, buckets),
                                          run['admission_s'])),
                params=sum(p.numel() for p in module.parameters()),
                setup_s=setup_s, held_before_bytes=held,
                serving_peak_bytes=serving_peak,
                peak_bytes=torch.cuda.max_memory_allocated())


def train_llama(torch, seed: int) -> dict:
    """Phase 16: Llama trains at Llama-3 8B's full width as the reference's
    ``benchmarks/llama8b_rehearsal.py`` (``chip()``) builds it: dim 4096,
    32 / 8 heads of 128, SwiGLU 14336, ``max_seq`` 8192, ``remat=True``,
    flash attention, the vocab cut to 16384, ``ChunkedNextTokenLoss(chunks=8,
    tied=False)`` and ``AdamW(lr=3e-4, grad_clip=1.0)`` on one sequence of
    8192 tokens, with depth cut to ``LLAMA_TRAIN_LAYERS`` (random weights
    from ``seed``), after the earlier phases are freed. First the same
    model at 2 layers on [1, 2048] is held against plain PyTorch attention
    (``'xla'``: autograd through ``dot_product_attention``, no kernel):
    losses within 1e-2, gradients' cosine above 0.999. Then one warm-up and
    ``LLAMA_TRAIN_STEPS`` timed steps with finite, falling losses, K1
    launched twice a layer (the recompute), K2b once a layer and K2a, K3a
    and K3b never; then a traced window of two steps. ``mfu`` counts
    6 N T plus 12 head_dim flops per causal (query, key) pair and head per
    layer, over 989 TFLOP/s."""
    import gc

    import numpy as np

    from tpusystem_torch.models import llama3_8b
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    config = dict(vocab_size=LLAMA_TRAIN_VOCAB, attention='flash',
                  return_features=True, device='cuda')
    criterion = ChunkedNextTokenLoss(chunks=8, tied=False)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, LLAMA_TRAIN_VOCAB, (1, LLAMA_TRAIN_SEQ)), device='cuda')

    small = llama3_8b(layers=2, **config)
    small.init_weights(torch.Generator('cuda').manual_seed(seed))
    reference = compare_clones(torch, small, criterion, tokens[:, :2048],
                               'attention', ('flash', 'xla'), forward=())
    print('train-llama-reference ' + json.dumps(reference))
    if not (math.isfinite(reference['loss'])
            and abs(reference['loss'] - reference['reference_loss']) <= 1e-2
            and reference['grad_cosine'] > 0.999):
        fail(f'Llama flash train step vs plain attention: {reference}')
    del small
    gc.collect()
    torch.cuda.empty_cache()

    started = time.perf_counter()
    module = llama3_8b(layers=LLAMA_TRAIN_LAYERS, **config)
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    optimizer = AdamW(lr=3e-4, grad_clip=1.0)
    state = init_state(module, optimizer, rng=seed)
    step = build_train_step(module_apply(module), criterion, optimizer)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused,
                flash.flash_bwd_fused_g1, flash.flash_bwd_dq,
                flash.flash_bwd_dkv)
    state, result = timed_steps(torch, step, state, tokens,
                                LLAMA_TRAIN_STEPS, counters)
    check_launches(result, {'flash_attention_lse': 2 * module.layers,
                            'flash_bwd_fused': module.layers,
                            'flash_bwd_fused_g1': 0, 'flash_bwd_dq': 0,
                            'flash_bwd_dkv': 0})
    params = sum(p.numel() for p in module.parameters())
    flops = (6 * params * tokens.numel() + 12 * module.head_dim
             * module.layers * attention_pairs(1, LLAMA_TRAIN_SEQ,
                                               module.heads))
    profile = profile_steps(torch, lambda: step(state, tokens, tokens),
                            steps=2, top_n=16)
    print('train-llama-profile ' + json.dumps(profile))
    return dict(result, params=params, layers=module.layers,
                vocab=module.vocab_size, flops_per_step=flops,
                mfu=flops / (result['median_step_ms'] / 1e3) / BF16_FLOPS,
                setup_s=setup_s, held_before_bytes=held,
                phase_peak_bytes=torch.cuda.max_memory_allocated(),
                reference=reference, profile=profile)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', type=pathlib.Path, default=None,
                        help='also write the full result as JSON here')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device')
    from tpusystem_torch.ops.cuda._build import LIBRARIES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    started = time.perf_counter()
    try:
        LIBRARIES.build()
    except RuntimeError as error:
        fail(str(error))
    build_seconds = time.perf_counter() - started
    print(f'built {sorted(LIBRARIES.build())} in {build_seconds:.1f} s')

    decode_ptxas = kernel_ptxas('decode-ptxas', 'decode_matmul',
                                DECODE_INSTANCES + FFN_INSTANCES)
    lookup_ptxas = kernel_ptxas('lookup-ptxas', 'embedding_lookup',
                                LOOKUP_INSTANCES)
    generator = torch.Generator('cuda').manual_seed(args.seed)
    checks = check_kernels(torch, generator)
    k1_128_rows, k1_ptxas = check_k1_head_dim_128(torch, generator)
    bwd_ptxas = ptxas_report(LIBRARIES.compiler_output.get('flash_bwd', ''))
    print('bwd-ptxas ' + json.dumps(bwd_ptxas or 'not available: the library '
                                    'was built by an earlier process'))
    check_spills('bwd-ptxas', bwd_ptxas, BWD_INSTANCES)
    checks += (k1_128_rows + check_train_forward(torch, generator)
               + check_backward(torch, generator, HEAD_DIM,
                                BWD_CASES[HEAD_DIM]))
    bwd_128_rows = check_backward(torch, generator, 128, BWD_CASES[128])
    checks += bwd_128_rows
    checks += check_long_backward(torch, generator)
    served = serve(torch, args.seed)
    bf16_tokens = served.pop('tokens')
    print('serve ' + json.dumps(served))
    checks += (decode_checks(torch, generator, 'int8')
               + decode_checks(torch, generator, 'fp8'))
    quantized = serve_quantized(torch, args.seed, bf16_tokens)
    trained = train(torch, args.seed)
    print('train ' + json.dumps(trained))
    long = train_long(torch, args.seed)
    dropout_checks = check_dropout_kernels(torch, generator)
    checks.append(check_mask_kernel(torch))
    dropout_trained = train_dropout(torch, args.seed)
    print('dropout-train ' + json.dumps(dropout_trained))
    grouped_rows, k7_split, grouped_ptxas = check_grouped(torch, generator)
    checks += grouped_rows
    moe_trained = train_moe(torch, args.seed)
    print('moe-train ' + json.dumps(moe_trained))
    split = split_step(torch, generator)
    lookup_rows, lookup = check_lookup(torch, generator, args.seed)
    checks += lookup_rows
    dlrm = train_dlrm(torch, args.seed)
    print('dlrm-train ' + json.dumps(dlrm))
    llama = serve_llama(torch, args.seed)
    print('serve-llama ' + json.dumps(llama))
    llama_trained = train_llama(torch, args.seed)
    print('train-llama ' + json.dumps(llama_trained))

    csrc = 'tpusystem_torch/ops/cuda/csrc/'
    pallas = 'tpusystem/ops/pallas/'
    # name: (source, replaces, headline check, launches on the main paths)
    table = {
        'decode_matmul': ('decode_matmul.cu', pallas + 'decode_matmul.py:99',
                          'decode_matmul[qkv]',
                          served['launches']['decode_matmul']),
        'decode_ffn': ('decode_matmul.cu', pallas + 'decode_matmul.py:181',
                       'decode_ffn', served['launches']['decode_ffn']),
        **{f'{kernel}_{mode}': (
            'decode_matmul.cu', pallas + f'decode_matmul.py:{line}',
            f'{kernel}_{mode}{label}',
            quantized[mode]['launches'][f'{kernel}_{mode}'])
           for mode in ('int8', 'fp8')
           for kernel, line, label in (('decode_matmul', 99, '[qkv]'),
                                       ('decode_ffn', 181, ''))},
        'flash_attention_lse': (
            'flash_fwd.cu', pallas + 'flash.py:106', 'flash_attention[S=1024]',
            served['launches']['flash_attention_lse']
            + trained['launches']['flash_attention_lse']
            + long['launches']['flash_attention_lse']
            + dropout_trained['launches']['flash_attention_lse']
            + moe_trained['launches']['flash_attention_lse']
            + llama['launches']['flash_attention_lse']
            + llama_trained['launches']['flash_attention_lse']),
        'flash_bwd_fused_g1': ('flash_bwd.cu', pallas + 'flash.py:344',
                               'flash_bwd_fused_g1[1x16384]',
                               long['launches']['flash_bwd_fused_g1']),
        'flash_bwd_fused': ('flash_bwd.cu', pallas + 'flash.py:281',
                            'flash_bwd_fused[train]',
                            trained['launches']['flash_bwd_fused']
                            + dropout_trained['launches']['flash_bwd_fused']
                            + moe_trained['launches']['flash_bwd_fused']
                            + llama_trained['launches']['flash_bwd_fused']),
        'flash_bwd_dq': ('flash_bwd.cu', pallas + 'flash.py:162',
                         'flash_bwd_dq[train]',
                         split['launches']['flash_bwd_dq']),
        'flash_bwd_dkv': ('flash_bwd.cu', pallas + 'flash.py:201',
                          'flash_bwd_dkv[train]',
                          split['launches']['flash_bwd_dkv']),
        'gather_rows_matmul': ('grouped_matmul.cu',
                               pallas + 'grouped_matmul.py:99',
                               'gather_rows_matmul[fwd]',
                               moe_trained['launches']['gather_rows_matmul']),
        'matmul_scatter_rows': (
            'grouped_matmul.cu', pallas + 'grouped_matmul.py:225',
            'matmul_scatter_rows[fwd]',
            moe_trained['launches']['matmul_scatter_rows']),
        'gather_rows': ('embedding_lookup.cu',
                        pallas + 'embedding_lookup.py:106',
                        'gather_rows[dedup]', dlrm['launches']['gather_rows']),
        'scatter_add_rows': ('embedding_lookup.cu',
                             pallas + 'embedding_lookup.py:191',
                             'scatter_add_rows[dedup]',
                             dlrm['launches']['scatter_add_rows']),
        # no pallas_call: the reference's masks are XLA's jax.random.bernoulli
        'bernoulli_mask': ('threefry.cu', 'tpusystem/ops/attention.py:374',
                           'bernoulli_mask',
                           dropout_trained['launches']['bernoulli_mask']),
    }
    measured = dict(checks)
    kernels = []
    for name, (source, replaces, label, launches) in table.items():
        entry = measured[label]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': csrc + source,
            'replaces': replaces, 'launches': launches,
            'max_abs_err': entry['max_abs_err'], 'ms': entry['ms'],
            'plain_ms': entry['plain_ms'], 'bound_ms': entry['bound_ms'],
            'bound_by': entry['bound_by'], 'library_ms': entry['library_ms'],
            'shape': entry['shape']})
    # K1's design, its instantiations' registers and its head-dim-128
    # shapes (Llama-3 8B's prefill)
    k1 = kernels[[k['name'] for k in kernels].index('flash_attention_lse')]
    k1['design'] = 'wgmma+tma'
    k1['ptxas'] = k1_ptxas or 'not available: built by an earlier process'
    k1['head_dim_128'] = dict(
            launches=llama['launches']['flash_attention_lse'],
            ptxas=k1_ptxas.get('flash_fwd_kernel<128>'),
            shapes=[{key: entry[key] for key in (
                'shape', 'kv_heads', 'causal', 'max_abs_err', 'ms',
                'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
                'bound_share', 'tflops')}
                for _, entry in k1_128_rows])
    # the backward kernels (K2a and K2b one TMA-fed wgmma kernel, K3b its
    # body without dq, K3a a dq sweep): registers, bound share and, for
    # K2a and K2b, the share of their cycles spent waiting for dq tickets
    for name in BWD_INSTANCE:
        entry = kernels[[k['name'] for k in kernels].index(name)]
        headline = measured[table[name][2]]
        entry.update(design='wgmma+tma', bound_share=headline['bound_share'],
                     tflops=headline['tflops'],
                     ptxas={f'<{d}>': bwd_ptxas.get(
                         BWD_INSTANCE[name].format(d)) for d in (16, 32, 64,
                                                                 128)})
        if name in FUSED_KERNELS:
            entry['ticket_waits'] = headline['ticket_waits']
    # K6 and K7: one TMA-fed wgmma kernel, its registers, both shapes of
    # each (forward, backward) and K7's time split into its parts
    for name in ('gather_rows_matmul', 'matmul_scatter_rows'):
        entry = kernels[[k['name'] for k in kernels].index(name)]
        entry.update(design='wgmma+tma', ptxas={
            instance: grouped_ptxas.get(instance)
            for instance in GROUPED_INSTANCES} if grouped_ptxas
            else 'not available: built by an earlier process', shapes={
                label: {key: measured[label][key] for key in (
                    'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
                    'bound_ms', 'bound_by', 'bound_share', 'tflops')}
                for label in (f'{name}[fwd]', f'{name}[bwd]')})
    kernels[[k['name'] for k in kernels].index('matmul_scatter_rows')][
        'split'] = k7_split
    # K4 at every weight type: its design, registers and both shapes
    for name in ('decode_matmul', 'decode_matmul_int8', 'decode_matmul_fp8'):
        mode = {'': 0, '_int8': 1, '_fp8': 2}[name[len('decode_matmul'):]]
        kernels[[k['name'] for k in kernels].index(name)].update(
            design=K4_DESIGN,
            ptxas={instance: decode_ptxas.get(instance)
                   for instance in DECODE_INSTANCES
                   if instance.endswith(f', {mode}>')} if decode_ptxas
            else 'not available: built by an earlier process',
            shapes={label: {key: measured[label][key] for key in (
                'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
                'bound_ms', 'bound_by', 'bound_share')}
                for label in (f'{name}[qkv]', f'{name}[out]')})
    # K5 at every weight type: its design, registers, bound share, repeat
    for name in ('decode_ffn', 'decode_ffn_int8', 'decode_ffn_fp8'):
        mode = {'': 0, '_int8': 1, '_fp8': 2}[name[len('decode_ffn'):]]
        kernels[[k['name'] for k in kernels].index(name)].update(
            design=K5_DESIGN,
            ptxas={FFN_INSTANCES[mode]: decode_ptxas.get(FFN_INSTANCES[mode])}
            if decode_ptxas else 'not available: built by an earlier process',
            bound_share=measured[name]['bound_share'],
            bitwise_repeat=measured[name]['bitwise_repeat'])
    # K9: its design, registers and the fold beside its chain floor
    fold = measured['scatter_add_rows[fold]']
    kernels[[k['name'] for k in kernels].index('scatter_add_rows')].update(
        design=K9_DESIGN, ptxas=lookup_ptxas or 'not available: built by '
        'an earlier process', kernel_only_ms=measured[
            'scatter_add_rows[dedup]']['kernel_only_ms'],
        fold={key: fold[key] for key in (
            'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
            'bound_ms', 'bound_by', 'bound_share', 'longest_segment',
            'sm_clock_mhz', 'chain_floor_ms', 'chain_floor_share')},
        folds_ms_per_dlrm_step=dlrm['profile']['folds']['fold_ms_per_step'])
    kernels[[k['name'] for k in kernels].index('flash_bwd_fused')][
        'ticket_waits_llama'] = measured[
            'flash_bwd_fused_d128[S=8192]']['ticket_waits']
    # the backward kernels at head dim 128: launches on the main paths
    # (Llama training for K2a and K2b, phase 12's head-dim-128 case for
    # K3a/K3b), registers and phase 3's shapes at 128
    d128 = split['cases']['d128']['launches']
    for name, launches in (
            ('flash_bwd_fused_g1',
             llama_trained['launches']['flash_bwd_fused_g1']),
            ('flash_bwd_fused', llama_trained['launches']['flash_bwd_fused']),
            ('flash_bwd_dq', d128['flash_bwd_dq']),
            ('flash_bwd_dkv', d128['flash_bwd_dkv'])):
        instance = BWD_INSTANCE[name].format(128)
        kernels[[k['name'] for k in kernels].index(name)]['head_dim_128'] = (
            dict(launches=launches,
                 ptxas={instance: bwd_ptxas.get(instance)},
                 shapes=[{key: entry.get(key) for key in (
                     'shape', 'causal', 'max_abs_err', 'ms', 'plain_ms',
                     'library_ms', 'bound_ms', 'bound_by', 'bound_share',
                     'tflops', 'ticket_waits', 'k2a_equals_k2b',
                     'k3b_equals_k2b')}
                     for label, entry in bwd_128_rows
                     if label.startswith(name + '_d128[')]))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {'card': card, 'build_s': build_seconds, 'checks': checks,
             'serve': served, 'serve_quantized': quantized,
             'train': trained, 'long': long,
             'dropout_kernels': dropout_checks,
             'dropout_train': dropout_trained, 'moe_train': moe_trained,
             'split': split, 'lookup': lookup, 'dlrm': dlrm,
             'serve_llama': llama, 'train_llama': llama_trained,
             'k1_ptxas': k1_ptxas, 'bwd_ptxas': bwd_ptxas,
             'grouped_ptxas': grouped_ptxas, 'k7_split': k7_split,
             'decode_ptxas': decode_ptxas, 'lookup_ptxas': lookup_ptxas,
             'kernels': kernels,
             'compiler_output': LIBRARIES.compiler_output}, indent=1))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
