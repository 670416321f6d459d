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
   each; every serving kernel's launch count must rise during this run (the
   requests are greedy: every step takes the plain argmax and the sampler's
   kernel never launches), and one decode step's logits through the fused
   kernels must agree with the module path on the same state; then a traced
   window of decode steps says where a step's time goes;
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
   bound: ``fold-bound``), a bf16 table and a width off the 16-byte loads
   (K8 timed back to back in a CUDA graph by CUDA events, each call
   writing its own output, so its 33.5 MB are written to HBM at HBM's rate
   and not absorbed by the 50 MB L2 between launches);
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
    15b. the same weights streamed narrow (``serve-llama-narrow``):
    ``Engine(rows=8, block_size=16, stream_dtype='int8')``, then ``'fp8'``,
    on four of phase 15's requests (buckets 32, 512, 4096, 8192), 16 new
    tokens each: the module paged step on the dequantized view, K1 32
    times for each bucket of 512 or more and K4/K5 never; the share of
    tokens equal to phase 15's bf16 streams, decode tokens/s, step ms and
    peak memory;
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
17. sampled serving (``serve-sampled``): the sampler's per-row uniform
    kernel (``threefry.cu``, ``row_uniforms``) bit for bit its plain version
    at 64 ``(seed, position)`` keys over GPT-2's vocabulary and timed at the
    engine's [8, 50257]; then phase 5's model and prompts through
    ``Engine(rows=8)`` all greedy, and with two greedy rows, two at
    temperature 0.8, one at ``top_k`` 40, one at ``top_p`` 0.9, one at
    ``top_k`` 1 on a greedy row's prompt and one greedy under a grammar:
    K1, K4, K5 and the uniform kernel launch and the plain sampler never
    runs, the greedy and ``top_k`` 1 rows equal the all-greedy run's, the
    rows seated in reverse order emit the same streams, the masked row's
    tokens pass its mask, and ``sample_token`` at 4,096 positions on fixed
    logits (``top_k`` 8) within a chi-square bound of the renormalised
    softmax; decode tokens/s and step ms of both runs, and four steps of
    each traced;
18. prefix sharing (``serve-prefix``): the same weights through
    ``Engine(share_prefix=True)``, eight prompts behind a 256-token prefix
    and two behind a 640-token one: every hit resumes, K1 only for the two
    full prefills, each resumed first-token logit row within phase 5's
    tolerance of a full prefill, a clean pool audit after every eviction;
    the shares of equal first tokens and 32-token streams against the same
    prompts without sharing, the time to first token resumed against
    full, and one resumed and one full prefill traced;
19. the verybasic example (``verybasic``): ``examples/verybasic_torch/
    train.py``'s ``main()`` on the card, its epoch loss falling every
    epoch, the mask kernel once a step; one MLP step (Adam) on the card
    against the CPU; and ``events.py``, ``prodcon.py``, ``pubsub.py`` printing what
    the reference's scripts print;
20. speculative decoding (``spec-generate``):
    ``benchmarks/speculative_decode.py``'s float32 pair (a GPT-2 of 8
    layers, dim 512, and a draft of 1 layer, dim 128, vocab 256) trained
    300 AdamW steps each through the port's ``build_train_step``, then
    ``generate`` against ``speculative_generate`` at batch 1 and 8, 128
    steps, K = 3, 5, 7 and a token tree at K = 5: tokens/s, tokens a round,
    the share of rows equal to plain greedy; and a temperature-0.8 pass,
    in the vocabulary and repeated bitwise with the same key;
21. speculative rows (``serve-spec``): phase 5's weights and prompts through
    the engine with a self-draft at ``tree_fanout`` 1 and 2, a random draft
    at the benchmark's draft shape with GPT-2's vocabulary, and the
    self-draft with sampled rows: the self-draft emits more than a token a
    step and its first tokens equal phase 5's, K1 once a layer for every
    target and draft prefill of 512 tokens or more and K4/K5 never, a clean
    pool audit after every eviction, the uniform kernel on the sampled
    rows, their greedy row equal to its self-draft stream, a ``mask_fn``
    refused; decode tokens/s, step ms, tokens a request and step, accepted
    drafts a round, and four traced steps with the draft's and the verify's
    device ms apart (the port's ``speculative.draft`` and
    ``speculative.verify`` ranges);
22. MoE serving (``serve-moe``): K6 and K7 at the MoE model's serving
    shapes (a decode step's 8 tokens at capacity 8, a 1,024-token prefill
    at capacity 1,024) against their plain versions, repeated bitwise,
    timed beside the plain version, ``torch.bmm`` and their bound; then the
    8-expert GPT-2 MoE (``moe_ceiling.py``'s whole-model settings, random
    weights) serving phase 5's prompts through ``Engine(rows=8)``: the
    module paged step, K6 and K7 once per MoE block a prefill and a decode
    step (6 each a step), K4/K5 never, the logits through the paged cache
    against the non-cached forward within phase 15's tolerance, decode
    tokens/s, step ms and a traced window with the grouped kernels' device
    ms;
23. the serving control plane (``serve-disagg``): phase 5's model and
    requests, every engine ``Engine(rows=8, block_size=16)`` on the fused
    step. (a) A ``Router`` over a prefill ``ServingReplica``
    (``Scheduler(prefill_only=True)``: ``export_prefill``, K1 for each
    bucket of 512 or more) and a decode one (``admit_prefilled``, then K4
    and K5), the KV strips over one ``Loopback`` through ``KVStripStore``,
    against a colocated ``Scheduler`` on a third engine: K1 never moves
    across an ``admit_prefilled``, the first tokens all equal, every
    request completes; the share of equal streams (and the first
    difference), decode tokens/s and time to first token of both runs,
    the bytes of a hand-off and the host ms of each of its steps
    (export, pack, offer, fetch, unpack, admit). (b) ``InferenceService``
    on the card with ``on_token`` callbacks: the colocated streams, and
    its events counted. (c) The decode replica journals into a
    ``MemStore`` and ``DieAtStep`` kills it mid-stream: the router
    recovers the journal, the dead replica is retired, a relaunched one
    (a fresh engine) is adopted and the rows replay onto it; the old
    engine is collected, the memory after the relaunch is within one KV
    pool of that before, every journaled prefix kept; the share of
    streams equal to the colocated run's is printed.
    (d) ``certify_fleet`` at seed 1 on three port engines (a journaled
    router with a lease; router, standby and replica kills): its report
    is ok;
24. the resilient trainer (``train-resilient``): GPT-2 125M at phase 7's
    recipe (16 x 1024 tokens, flash, AdamW clipped at 1.0), random weights
    from ``--seed``. (a) Two steps of ``scan_layers=True`` against two of
    the unrolled model from the same weights: losses and parameters bit
    for bit, the peak memory of each. (b) ``build_multi_step`` at N = 4
    over 8 batches against 8 single steps: losses and the final state bit
    for bit, the ms a step of each. (c) The guard drill: ``Guard(warmup=4,
    zmax=6)``, ``CorruptGrads`` NaN at step 6 and a 200x spike at step 9;
    step 6's health row has ok = 0 and leaves the parameters and every
    AdamW slot bit for bit, ``bad_steps`` counts the suppressed steps, the
    step counter advances while Adam's count does not, ``Sentinel.review``
    over each 4 steps' rows emits ``AnomalyDetected``; the spike's z-score
    is printed; the guarded step's ms and host syncs (``torch.cuda.
    set_sync_debug_mode('warn')``) beside the unguarded one's, no more
    syncs. (d) An async ``Checkpointer`` every 4 steps (the host ms
    ``save`` blocks, each commit's ms, the bytes a step); a forced
    ``Sentinel`` rollback restores step 4 in place and steps 5-8 repeat
    the first run's losses bit for bit. (e) This script's
    ``resilient_worker`` under the ``Supervisor`` and its memstore server:
    SIGKILLed after step 5's hot push (8 steps: a hot push a step costs
    ~12 s at this width), relaunched, restored through ``hot_resume``
    (source ``'hot'``), it finishes steps 6-8; its 8 losses and its final
    state equal an uninterrupted in-process run's bit for bit; detect ->
    first step, the hot-state bytes, the hot restore's seconds against a
    fresh ``Checkpointer``'s disk restore and the exit codes are printed.
    The supervisor traces (``tracer=``) and gives the worker a flight
    recorder (``flight_path=``), which phase 25 (d) reads.
    K1 and K2b launch in every in-process step;
25. observability and the LM example system (``observe-lm``): (a)
    ``examples/lm_torch/main.py``'s ``main(epochs=2, full=True)`` then
    ``main(epochs=3, full=True)`` (GPT-2 125M, flash attention, 16 x 1024
    tokens, 64 train and 8 evaluation batches an epoch, synthetic tokens)
    into a temporary root: the second run prints ``from epoch 2``, the
    document store holds one model at epoch 3 with loss and perplexity rows
    in both phases, ``weights/`` one identity, every loss is finite, the
    last evaluation loss is below the first, K1 launches at least 12 times
    a step and K2b 12 times a train step; tokens/s from the ``StepTimed``
    events. (b) ``observe.trace`` around two of the recipe's train steps,
    each under ``observe.step_span`` (after one more step inside the trace):
    the ``torch.profiler`` trace names K1's ``flash_fwd_kernel`` and K2b's
    ``flash_bwd_fused_kernel`` inside the ``ProfilerStep#`` ranges (fails if
    the profiler saw no CUDA kernel or missed either; the counts, 12 a step
    each when every launch is recorded, are printed). (c) Phase 5's weights and requests through
    ``InferenceService`` (a bf16 ``Engine(rows=8)`` under a ``Scheduler``)
    untraced, then with ``tracer=Tracer()``, a ``FlightRecorder`` watching
    it and a ``serve_metrics_consumer`` on the producer: streams equal, one
    connected trace per request, the Chrome export parses, K1 for each
    prefill of 512 tokens or more and K4/K5 in decode; TTFT p50/p99 and
    decode tokens/s of both runs. (d) Phase 24 (e)'s killed worker's
    ``WorkerExited.postmortem`` holds its write-ahead ring of steps 1-5 and
    the supervisor's tracer one ``recovery rank0`` span over its stages;
26. ResNet (``resnet``): (a) ``resnet_tiny`` in float32 with the
    ImageNet-style stem and pool at 32x32 (its asymmetric 'SAME' pads):
    the port against a plain forward written from its parameters (also
    with bf16 convolutions, the residual stream float32), and weights
    crossed from the CPU into the card: logits and one AdamW
    ``build_train_step`` step's loss and gradients against the CPU's with
    cuDNN's TF32 off, within 1e-4. (b) ResNet-50
    (``benchmarks/ladder_mfu.py:150-153``: 224x224, bf16, NHWC, batch 64)
    on one synthetic batch from ``--seed``: 3 warm-up and 10 timed AdamW
    steps (``cudnn.benchmark`` on for the phase), every loss finite and
    the last below the first, 25.0-26.5 M parameters; step ms, images/s,
    peak memory, ``mfu`` (convolutions and head, training as three
    forwards, over 989 TFLOP/s) and a profiled window of two steps. No
    hand-written kernel launches in the phase;
27. collectives and data parallelism (``data-parallel``) over a world of
    one rank: ``multihost.initialize`` joins NCCL on the card through a
    local store; (a) every collective of ``parallel/collectives.py`` on
    CUDA tensors over ``MeshSpec(data=-1)`` and ``MeshSpec(fsdp=-1)``
    against its definition at world size one, bit for bit (the gradients of
    the gather and the reduce-scatter too), and ``replica_checksums`` of
    GPT-2 125M's parameters equal to the same sums on the host, one
    ``FlipParamBit`` changing exactly that leaf's entry; (b) three AdamW
    steps of phase 7's recipe at [16, 1024] from the same weights,
    unplaced, under ``DataParallel()`` and ``FullyShardedDataParallel()``:
    losses and final parameters bit for bit the unplaced ones, K1 and K2b
    12 launches a step each, each policy's step ms and peak memory; (c)
    two processes sharing the card over gloo on CUDA tensors (NCCL refuses
    two ranks on one device) run (b)'s DP steps on 8 rows each: equal
    global losses, within 2e-5 of (b)'s unplaced ones;
28. print the ``kernels`` line (with a ``head_dim_128`` entry for K1 and
    each backward kernel, a ``serving`` entry for K6 and K7), the card's
    name and power limit, and last the ``{"ok": true, "device": ...}``
    line. Each of phases 15b and 17-27 prints its seconds.

Imports nothing of JAX. Exits non-zero without a CUDA device or without the
repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import re
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
# phase 15b: four of phase 15's requests (buckets 32, 512, 4096, 8192)
LLAMA_NARROW, LLAMA_NARROW_NEW = (20, 300, 3000, 7000), 16
# phase 20: benchmarks/speculative_decode.py's pair, float32
SPEC_VOCAB, SPEC_STEPS, SPEC_TRAIN_STEPS = 256, 128, 300
SPEC_TARGET = dict(vocab_size=SPEC_VOCAB, layers=8, dim=512, heads=8,
                   max_seq=512, dropout=0.0, dtype='float32')
SPEC_DRAFT = dict(vocab_size=SPEC_VOCAB, layers=1, dim=128, heads=2,
                  max_seq=512, dropout=0.0, dtype='float32')
SPEC_WIDTHS, SPEC_TREE_K = (3, 5, 7), 5
# phase 21: speculative rows on GPT-2 125M; the random draft at the
# benchmark's draft shape with GPT-2's vocabulary; (prompt, sampling) rows
SPEC_K = 3
SPEC_SERVE_DRAFT = dict(vocab_size=50257, layers=1, dim=128, heads=2,
                        max_seq=1024, dropout=0.0)
SPEC_SAMPLED = ((0, dict(seed=1, temperature=0.8)),
                (1, dict(seed=2, temperature=0.8)),
                (3, dict(seed=3, temperature=0.8, top_k=40)),
                (2, None))
# phase 22: K6/K7 at the MoE model's serving shapes (label, tokens): a
# decode step of 8 rows, a 1,024-token prefill; full capacity
GROUPED_SERVING = (('decode', ROWS), ('prefill', 1024))
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
GRAPH_CALLS = 20                # calls captured in one graph_measure graph
MARKED = 'speculative.'         # the port's record_function ranges
GPT2_VOCAB = 50257
# phase 17's rows: greedy, sampled, top-k 1 on the first row's prompt, and
# greedy under the grammar even_ids
SAMPLED_ROWS = (None, None, dict(seed=1, temperature=0.8),
                dict(seed=2, temperature=0.8),
                dict(seed=3, temperature=1.0, top_k=40),
                dict(seed=4, temperature=1.0, top_p=0.9),
                dict(seed=5, temperature=0.8, top_k=1), 'masked')
UNIFORM_PAIRS = 64              # (seed, position) keys of the uniform check
CHI_POSITIONS, CHI_TOP_K = 4096, 8
CHI_BOUND = 24.322              # chi-square, 7 degrees of freedom, 0.999
PREFIX_SHARED, PREFIX_SUFFIXES = 256, (16, 40, 64, 90, 120, 150, 180, 200)
LONG_PREFIX, LONG_SUFFIXES = 640, (30, 70)
MLP_TOL = 1e-5
DISAGG_PARTS = ('export_prefill', 'pack', 'offer', 'fetch', 'unpack',
                'admit_prefilled')
DISAGG_KILL_TICK = 12           # the decode replica's tick that dies (23 c)
CERTIFY_SEED = 1                # the reference's real-engine seed (23 d)
CERTIFY_MAX_NEW = 8
VERYBASIC_OUTPUT = {
    'events': 'handled: reduce lr, continue\n'
              'training stopped: val loss diverged\n',
    'prodcon': 'train: accuracy=0.91\neval: accuracy=0.88\n'
               "stored rows: [('train', 0.91), ('eval', 0.88)]\n",
    'pubsub': 'charting 0.37\ncharting 0.91\ncharting 99.0\n'
              'stopped: loss diverged\n'}
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


def graph_measure(torch, fn, replays: int = 5):
    """Device milliseconds per call of ``fn()`` with no host gaps between
    calls: ``GRAPH_CALLS`` calls captured in one CUDA graph (each its own
    output in the graph's memory pool), replayed ``replays`` times and
    timed by CUDA events. For a kernel shorter than its launch whose output
    fits in L2, which a profiled window lets L2 drain between launches.
    Returned as ``(None, event ms)``, in the places of ``measure``'s
    ``(profiler ms, event ms)``: no profiler runs, so ``record_check`` takes
    it ``by_events``. The event time includes the graph's gaps between its
    nodes, so it is not the profiler's kernel sum of the other rows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = [fn() for _ in range(GRAPH_CALLS)]
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outputs, graph
    return None, start.elapsed_time(end) / (GRAPH_CALLS * replays)


def cycling(call):
    """``fn()`` for ``graph_measure`` that calls ``call(i)`` with ``i``
    counting up, so calls captured back to back take successive input
    sets."""
    count = [0]

    def fn():
        count[0] += 1
        return call(count[0])
    return fn


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
    table; a width off the 16-byte loads. K9 is timed by the profiler's
    device time (a call shorter than the host's launch of it would time the
    host by CUDA events alone) beside the plain version on the card and the
    library calls (``index_select`` times the scale for K8, ``torch.zeros``
    + ``index_add_`` with float atomics for K9), never called by the port.
    K8's 33.5 MB output fits in the card's 50 MB L2, which drains it to
    HBM in the host's gaps between launches, so a profiled K8 times under
    its byte bound: K8, its plain version and the library call are timed by
    ``graph_measure`` instead, back to back in one CUDA graph, each call
    writing its own output, by CUDA events (the graph's gaps between nodes
    included; no profiler time). Bounds count bytes:
    K8 the distinct rows read, its output written, ids and scales; K9 its
    rows, ids and scales read and the float32 table written whole (the zero
    fill), and without the fill a row read and write per distinct id."""
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
        timed = graph_measure(torch, lambda: el.gather_rows(table, clamped,
                                                            scale))
        plain = graph_measure(torch, lambda: el.gather_rows_plain(
            table, clamped, scale))
        library = graph_measure(torch, lambda: torch.index_select(
            table, 0, clamped) * scale[:, None])
        rows.append(record_check(
            f'gather_rows[{path}]', [count, vocab, dim], err, 0.0, timed,
            plain, library, bound_ms(read * dim * 4 + count * dim * 4
                                     + count * 8, count * dim),
            by_events=True, timing='graph_measure: CUDA events over a graph',
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
    window's wall time; the rest is the card waiting on the host. The host
    operators are ranked twice: by the device time they launched and by
    their own host time. For each name in ``sums``, the device ms a step of
    every kernel whose name holds it; ``range_device_ms``, the device ms a
    step of the kernels that ran inside each ``record_function`` range the
    port marks (the speculative step's ``speculative.draft`` and
    ``speculative.verify``), read from the ranges' spans on the device's
    timeline (which are not kernels, and are left out of every sum)."""
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
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and not event.key.startswith(MARKED)):
            kernels[event.key] = getattr(event, 'self_device_time_total', 0.0)
            launches += event.count
    # the host operators that launched the device time, by input shape
    # (ctypes-launched kernels have no host operator and do not appear)
    device = [event for event in profile.events()
              if event.device_type == torch.autograd.DeviceType.CUDA]
    ranges = {}
    for span in device:
        if span.name.startswith(MARKED):
            inside = sum(event.time_range.elapsed_us() for event in device
                         if not event.name.startswith(MARKED)
                         and span.time_range.start <= event.time_range.start
                         < span.time_range.end)
            ranges[span.name] = ranges.get(span.name, 0.0) + inside / 1e3 \
                / steps
    operators, host = {}, {}
    for event in profile.key_averages(group_by_input_shape=True):
        if event.device_type == torch.autograd.DeviceType.CPU:
            name = f'{event.key} {event.input_shapes}'[:90]
            device_us = getattr(event, 'self_device_time_total', 0.0)
            if device_us > 0:
                operators[name] = device_us
            host[name] = event.self_cpu_time_total
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
                top_host_operators_us_per_step=top(host),
                kernel_ms_per_step={name: sum(
                    us for key, us in kernels.items() if name in key)
                    / 1e3 / steps for name in sums},
                range_device_ms=ranges)


def serving_prompts(seed: int, vocab: int) -> list:
    """The eight requests of the serving phases, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)) for n in PROMPT_LENGTHS]


def drive_engine(torch, engine, prompts, profile_at: int | None = None,
                 samplings=None, max_new: int = MAX_NEW,
                 audit: bool = False, sums=()) -> dict:
    """Admit the prompts in order (``max_new`` tokens each, at its entry of
    ``samplings`` when given) while the engine has a free row (all of them
    at once where they fit), then step, seating the next ones as rows free,
    until every request has finished by length with in-vocabulary tokens:
    the tokens of each request in prompt order, each admission's seconds
    (prefill and seating, synchronised: the time to first token), the
    untraced steps' seconds, and the run's step and token counts.
    ``profile_at`` traces four steps (not timed, their tokens kept) after
    that many (``sums`` as ``profile_steps`` takes them); ``audit`` checks
    the pool's audit after every eviction."""
    vocab = engine._decoder.vocab_size
    samplings = samplings or [None] * len(prompts)
    queue, owner = list(range(len(prompts))), {}
    admissions, finished = [None] * len(prompts), {}
    step_seconds, counts, audits = [], dict(emitted=0, steps=0), []

    def admit_ready():
        while queue and engine.free_rows:
            index = queue.pop(0)
            admitted = time.perf_counter()
            admission = engine.admit(prompts[index], max_new,
                                     sampling=samplings[index])
            torch.cuda.synchronize()
            admissions[index] = time.perf_counter() - admitted
            if admission.finished:
                fail(f'request in row {admission.row} finished at admission')
            owner[admission.row] = index

    def advance():
        report = engine.step()
        counts['steps'] += bool(report.emitted)
        counts['emitted'] += sum(len(tokens)
                                 for tokens in report.emitted.values())
        for row, reason, tokens in report.finished:
            finished[owner.pop(row)] = (reason, tokens)
            if audit:
                try:
                    audits.append(engine.pool.audit())
                except AssertionError as error:
                    fail(f'pool audit after evicting row {row}: {error!r}')
        return report

    torch.cuda.synchronize()
    started = time.perf_counter()
    admit_ready()
    admit_seconds = time.perf_counter() - started
    profile, traced, timed_emitted = None, 0, 0
    while engine.active_rows or queue:
        if len(step_seconds) == profile_at and profile is None:
            profile = profile_steps(torch, advance, sums=sums)
            traced = profile['steps']
            admit_ready()
            continue
        report = advance()
        step_seconds.append(engine.last_step_seconds)
        timed_emitted += sum(len(tokens) for tokens in report.emitted.values())
        admit_ready()
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    if len(finished) != len(prompts):
        fail(f'{len(finished)} of {len(prompts)} requests finished')
    for index, (reason, tokens) in finished.items():
        if reason != 'length' or len(tokens) != max_new or not all(
                0 <= t < vocab for t in tokens):
            fail(f'request {index}: {reason}, {len(tokens)} tokens')
    steps = len(step_seconds)
    return dict(tokens=[finished[index][1] for index in range(len(prompts))],
                steps=steps, engine_steps=counts['steps'],
                traced_steps=traced, decode_tokens=counts['emitted'],
                decode_tokens_per_s=timed_emitted / sum(step_seconds),
                step_ms=1e3 * sum(step_seconds) / steps,
                step_ms_quantiles=[1e3 * q for q in quantiles(step_seconds)],
                admission_s=admissions,
                prefill_s=engine.timings['prefill'], admit_s=admit_seconds,
                wall_s=wall, **({} if profile is None else
                                {'profile': profile}),
                **({'audits': len(audits), 'last_audit': audits[-1]}
                   if audits else {}))


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
    """Phase 5: GPT-2 125M through the paged Engine (the main path); its
    requests are greedy, so every step takes the plain argmax and the
    sampler's kernel never launches."""
    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda import threefry as tf
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
    tf.row_uniforms.launches = tf.row_uniforms_plain.runs = 0
    run = drive_engine(torch, engine, prompts)
    launches = {counter.__name__: counter.launches for counter in counters}
    for name, count in launches.items():
        if count == 0:
            fail(f'{name} was not launched on the main path')
    # greedy requests only: every step took the plain argmax
    if tf.row_uniforms.launches or tf.row_uniforms_plain.runs:
        fail('greedy serving ran the sampler')
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


def llama_probe(torch, engine, module, prompt, full=None) -> dict:
    """The logits through the paged cache of one request, at its prefill's
    last position and at its first ``LLAMA_PROBE_STEPS`` decode steps
    (``Engine.next_logits``), held against the model's own non-cached
    forward (``decode=False``, xla attention, no kernel; ``full`` when
    given, an MoE model's ``(logits, aux)`` taken at its logits) over the
    prompt and the tokens so far. Both run the same bf16 weights; they
    round at other points (K1 and the paged read against one einsum
    attention, the prefill padded to its bucket), and a bfloat16 step here
    and there, carried through 32 residual blocks, reaches logits of order
    1: the tolerance is 2**-4 of the largest logit, GPT-2's probe's."""
    if full is None:
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
                                        device=module.device))
            want = (want[0] if isinstance(want, tuple) else want)[0, -1]
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
    the full forward casts the float32 masters per use). Returns ``(module,
    prompts, tokens, result)``: phase 15b serves the same weights narrow."""
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
    tokens = run.pop('tokens')
    return module, prompts, tokens, dict(
        run, **probe, launches=launches, buckets=buckets,
        prompt_lengths=list(LLAMA_PROMPT_LENGTHS), max_new=MAX_NEW,
        ttft_s_by_bucket=dict(zip(map(str, buckets), run['admission_s'])),
        params=sum(p.numel() for p in module.parameters()),
        setup_s=setup_s, held_before_bytes=held,
        serving_peak_bytes=serving_peak,
        peak_bytes=torch.cuda.max_memory_allocated())


def serve_llama_narrow(torch, module, prompts, bf16_tokens) -> dict:
    """Phase 15b: phase 15's Llama-3 8B weights quantized through
    ``Engine(rows=8, block_size=16, stream_dtype='int8')``, then ``'fp8'``:
    four of phase 15's requests (``LLAMA_NARROW``: buckets 32, 512, 4096 and
    8192) take ``LLAMA_NARROW_NEW`` new tokens each; the route resolves to
    the module paged step, K1 launches once a layer for each bucket of 512
    or more and K4/K5 never. Prints the share of tokens equal to phase 15's
    bf16 streams, decode tokens/s, step ms and the peak memory of each run
    (the float32 masters stay on the card beside the narrow copy, and the
    module path dequantizes the narrow copy to bf16 for each forward)."""
    import gc

    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.serve import Engine

    chosen = [LLAMA_PROMPT_LENGTHS.index(n) for n in LLAMA_NARROW]
    requests = [prompts[index] for index in chosen]
    results = {}
    for mode in ('int8', 'fp8'):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        started = time.perf_counter()
        engine = Engine(module, None, rows=ROWS, block_size=BLOCK,
                        stream_dtype=mode)
        if engine.decode_impl != 'flax':
            fail(f'the {mode} Llama engine chose decode_impl='
                 f"{engine.decode_impl!r}, not 'flax'")
        buckets = [engine.bucket(len(prompt)) for prompt in requests]
        dm.reset_launches()
        flash.flash_attention_lse.launches = 0
        run = drive_engine(torch, engine, requests, max_new=LLAMA_NARROW_NEW)
        launches = {'flash_attention_lse': flash.flash_attention_lse.launches,
                    'decode_matmul': dm.decode_matmul.launches,
                    'decode_ffn': dm.decode_ffn.launches}
        flashed = module.layers * sum(bucket >= 512 for bucket in buckets)
        if launches != {'flash_attention_lse': flashed, 'decode_matmul': 0,
                        'decode_ffn': 0}:
            fail(f'{mode} Llama serving launched {launches}; expected K1 '
                 f'{flashed} times and K4/K5 never')
        pairs = [(a, b) for index, got in zip(chosen, run.pop('tokens'))
                 for a, b in zip(got, bf16_tokens[index])]
        results[mode] = dict(
            run, launches=launches, buckets=buckets,
            equal_to_bf16=sum(a == b for a, b in pairs) / len(pairs),
            streamed_bytes=sum(getattr(leaf, 'nbytes', 0)
                               for leaf in engine._params.values()),
            peak_bytes=torch.cuda.max_memory_allocated(),
            seconds=time.perf_counter() - started)
        del engine
    return dict(results, prompt_lengths=list(LLAMA_NARROW),
                max_new=LLAMA_NARROW_NEW, card=card_line())


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


def even_ids(emitted):
    """Phase 17's grammar: even token ids only (module level, as
    ``SamplingParams.mask_fn`` asks)."""
    import numpy as np
    return np.arange(GPT2_VOCAB) % 2 == 0


def sampled_requests(seed: int, vocab: int):
    """Phase 17's requests: phase 5's prompts with the ``top_k`` 1 row's
    replaced by the first's, each row's ``SamplingParams`` (``None`` for
    greedy) from ``SAMPLED_ROWS``, and the ``top_k`` 1 row's index."""
    from tpusystem_torch.serve import SamplingParams

    prompts = serving_prompts(seed, vocab)
    top_k_one = next(index for index, spec in enumerate(SAMPLED_ROWS)
                     if isinstance(spec, dict) and spec.get('top_k') == 1)
    prompts[top_k_one] = prompts[0]
    samplings = [None if spec is None
                 else SamplingParams(mask_fn=even_ids) if spec == 'masked'
                 else SamplingParams(**spec) for spec in SAMPLED_ROWS]
    return prompts, samplings, top_k_one


def check_row_uniforms(torch):
    """Phase 17: the sampler's per-row uniform kernel equals its plain bits
    (the integer ops of ``tpusystem_torch.ops.threefry``, on a CPU copy of
    the keys) bit for bit at 64 ``(seed, position)`` keys over GPT-2's
    vocabulary; timed at the engine's shape [8, 50257] beside the plain
    version on the card. No library call draws jax's bits. Its bound counts
    the float32 uniforms written once and the keys read, and ~123 32-bit
    integer operations an element (the mask kernel's count) over the 67 T/s
    non-tensor rate."""
    from tpusystem_torch.ops import threefry
    from tpusystem_torch.ops.cuda import threefry as tf
    from tpusystem_torch.train.generate import sampling_key

    keys = threefry.key_tensor([sampling_key(seed, 7 * seed + 3)
                                for seed in range(UNIFORM_PAIRS)])
    got = tf.row_uniforms(keys.to('cuda'), GPT2_VOCAB)
    want = threefry.uniform_rows(keys, GPT2_VOCAB)
    mismatches = int((got.cpu().view(torch.int32)
                      != want.view(torch.int32)).sum())
    engine_keys = keys[:ROWS].to('cuda')
    timed = measure(lambda i: tf.row_uniforms(engine_keys, GPT2_VOCAB))
    plain = measure(lambda i: threefry.uniform_rows(engine_keys, GPT2_VOCAB),
                    calls=10, warmup=2)
    count = ROWS * GPT2_VOCAB
    memory = (count * 4 + ROWS * 16) / HBM_BYTES_PER_S
    compute = count * 123 / FP32_OPS
    bound = (max(memory, compute) * 1e3,
             'bytes' if memory >= compute else 'operations')
    return record_check('row_uniforms', [ROWS, GPT2_VOCAB], mismatches, 0,
                        timed, plain, None, bound, keys_checked=UNIFORM_PAIRS)


def sampler_frequencies(torch, seed: int) -> dict:
    """Phase 17: ``sample_token`` at ``CHI_POSITIONS`` positions of one seed
    on fixed logits (temperature 1, ``top_k`` 8) against the renormalised
    softmax of the 8 highest logits: no token outside them, and the
    chi-square statistic of the counts (7 degrees of freedom) under
    ``CHI_BOUND``, its 0.999 quantile."""
    from tpusystem_torch.train.generate import sample_token

    generator = torch.Generator('cuda').manual_seed(seed)
    logits = torch.randn(GPT2_VOCAB, generator=generator, device='cuda')
    mask = torch.ones(GPT2_VOCAB, dtype=torch.bool, device='cuda')
    tokens = torch.stack([sample_token(logits, seed, position, 1.0,
                                       CHI_TOP_K, 1.0, mask)
                          for position in range(CHI_POSITIONS)])
    counts = torch.bincount(tokens, minlength=GPT2_VOCAB).double()
    top = torch.topk(logits, CHI_TOP_K)
    expected = torch.softmax(top.values.double(), 0) * CHI_POSITIONS
    observed = counts[top.indices]
    outside = int(CHI_POSITIONS - observed.sum().item())
    chi_square = ((observed - expected) ** 2 / expected).sum().item()
    if outside or not chi_square <= CHI_BOUND:
        fail(f'sample_token frequencies: {outside} tokens outside the top '
             f'{CHI_TOP_K}, chi-square {chi_square} over {CHI_BOUND}')
    return dict(positions=CHI_POSITIONS, top_k=CHI_TOP_K,
                chi_square=chi_square, bound=CHI_BOUND,
                observed=observed.tolist(), expected=expected.tolist())


def sampler_cost(torch) -> dict:
    """Phase 17: what sampling adds to a step, at the engine's [8, 50257]
    with ``SAMPLED_ROWS``' settings: the device ms of ``sample_rows`` (the
    profiler's kernel sum) and the host ms a step of the keys' derivation
    and upload plus ``sample_rows`` (100 calls, synchronised at the end),
    each beside the plain argmax's."""
    from tpusystem_torch.train.generate import sample_rows, sampling_keys

    generator = torch.Generator('cuda').manual_seed(1)
    logits = torch.randn((ROWS, GPT2_VOCAB), generator=generator,
                         device='cuda') * 3
    specs = [spec if isinstance(spec, dict) else {} for spec in SAMPLED_ROWS]
    temperature, top_k, top_p = (torch.tensor(
        [spec.get(name, default) for spec in specs], device='cuda')
        for name, default in (('temperature', 0.0), ('top_k', 0),
                              ('top_p', 1.0)))
    mask = torch.ones((ROWS, GPT2_VOCAB), dtype=torch.bool, device='cuda')
    mask[SAMPLED_ROWS.index('masked')] = torch.as_tensor(even_ids([]))
    seeds = [spec.get('seed', 0) for spec in specs]

    def sampled(position):
        # as the engine derives and uploads them: one hash on the host,
        # pinned, not blocking
        keys = torch.from_numpy(sampling_keys(seeds, [position] * ROWS))
        keys = keys.pin_memory().to('cuda', non_blocking=True)
        return sample_rows(logits, keys, temperature, top_k, top_p, mask)

    def host_ms(fn, calls: int = 100):
        for i in range(5):
            fn(i)
        torch.cuda.synchronize()
        started = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - started) / calls

    return dict(shape=[ROWS, GPT2_VOCAB],
                sampled_device_ms=measure(sampled)[0],
                argmax_device_ms=measure(lambda i: logits.argmax(-1))[0],
                sampled_host_ms=host_ms(sampled),
                argmax_host_ms=host_ms(lambda i: logits.argmax(-1)))


def serve_sampled(torch, seed: int, bf16_tokens: list) -> dict:
    """Phase 17: GPT-2 125M (phase 5's weights and prompts, the seventh
    prompt replaced by the first's) through ``Engine(rows=8,
    block_size=16)`` on the fused step, all greedy and then with the rows
    ``SAMPLED_ROWS``: two greedy, two at temperature 0.8, one at ``top_k``
    40, one at ``top_p`` 0.9, one at ``top_k`` 1 on the first greedy row's
    prompt, one greedy under a grammar (``even_ids``). K1, K4, K5 and the
    per-row uniform kernel launch in the mixed run and the plain sampler
    never runs; the all-greedy run equals phase 5's tokens on the prompts
    they share; the greedy and ``top_k`` 1 rows equal the all-greedy run's;
    a second engine with the rows seated in reverse order emits the same
    streams, sampled ones included; the masked row's tokens pass its mask;
    then ``sampler_frequencies`` and ``sampler_cost``. Decode tokens/s and
    step ms of both runs, with the card's name and power limit, and a trace
    of four steps of each after the eighth (``profile_steps``: where the
    mixed step's extra time goes)."""
    import gc

    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda import threefry as tf
    from tpusystem_torch.serve import Engine

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    prompts, samplings, top_k_one = sampled_requests(seed, module.vocab_size)
    greedy = drive_engine(torch, Engine(module, None, rows=ROWS,
                                        block_size=BLOCK), prompts,
                          profile_at=8)
    for index, (got, want) in enumerate(zip(greedy['tokens'], bf16_tokens)):
        if index != top_k_one and got != want:
            fail(f'all-greedy row {index} differs from phase 5 at the same '
                 'prompt')
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK)
    if engine.decode_impl != 'fused':
        fail(f"the engine chose decode_impl={engine.decode_impl!r}")
    dm.reset_launches()
    flash.flash_attention_lse.launches = 0
    tf.row_uniforms.launches = tf.row_uniforms_plain.runs = 0
    mixed = drive_engine(torch, engine, prompts, samplings=samplings,
                         profile_at=8)
    launches = {'flash_attention_lse': flash.flash_attention_lse.launches,
                'decode_matmul': dm.decode_matmul.launches,
                'decode_ffn': dm.decode_ffn.launches,
                'row_uniforms': tf.row_uniforms.launches}
    if not all(launches.values()) or tf.row_uniforms_plain.runs:
        fail(f'sampled serving launched {launches}, the plain sampler ran '
             f'{tf.row_uniforms_plain.runs} times')
    same = [index for index, spec in enumerate(SAMPLED_ROWS)
            if spec is None or index == top_k_one]
    for index in same:
        if mixed['tokens'][index] != greedy['tokens'][index]:
            fail(f'row {index} ({SAMPLED_ROWS[index]}) differs from the '
                 'all-greedy run')
    masked = mixed['tokens'][SAMPLED_ROWS.index('masked')]
    if any(token % 2 for token in masked):
        fail(f'the masked row emitted odd tokens: {masked}')
    order = list(reversed(range(ROWS)))
    again = drive_engine(torch, Engine(module, None, rows=ROWS,
                                       block_size=BLOCK),
                         [prompts[i] for i in order],
                         samplings=[samplings[i] for i in order])
    if [again['tokens'][order.index(i)] for i in range(ROWS)] \
            != mixed['tokens']:
        fail('the rows seated in reverse order emitted other streams')
    sampled = [index for index, spec in enumerate(SAMPLED_ROWS)
               if isinstance(spec, dict) and index != top_k_one]
    moved = sum(mixed['tokens'][i] != greedy['tokens'][i] for i in sampled)
    frequencies = sampler_frequencies(torch, seed)
    cost = sampler_cost(torch)
    timing = ('decode_tokens_per_s', 'step_ms', 'step_ms_quantiles',
              'admission_s', 'steps', 'profile')
    return dict(launches=launches, rows=[str(spec) for spec in SAMPLED_ROWS],
                greedy={key: greedy[key] for key in timing},
                mixed={key: mixed[key] for key in timing},
                equal_to_greedy_rows=same, reordered_equal=True,
                sampled_rows_differing_from_greedy=moved,
                masked_tokens_even=True, frequencies=frequencies,
                sampler_cost=cost, card=card_line(),
                seconds=time.perf_counter() - started)


def prefix_prompts(seed: int, vocab: int) -> list:
    """Phase 18's prompts: ``PREFIX_SUFFIXES`` behind one block-aligned
    ``PREFIX_SHARED``-token prefix, then ``LONG_SUFFIXES`` behind a
    ``LONG_PREFIX``-token one."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    prompts = []
    for shared, suffixes in ((PREFIX_SHARED, PREFIX_SUFFIXES),
                             (LONG_PREFIX, LONG_SUFFIXES)):
        head = rng.integers(0, vocab, (shared,))
        prompts += [np.concatenate([head, rng.integers(0, vocab, (n,))])
                    for n in suffixes]
    return prompts


def serve_queue(torch, engine, prompts, probe: bool = False) -> dict:
    """Serve ``prompts`` (``MAX_NEW`` tokens each) in order, admitting while
    the pool can seat the next one: each request's tokens, first token,
    admission seconds (synchronised) and adopted prefix length. With
    ``probe``, each resumed admission's first-token logits (the resume
    again, on the seated row) are held against a full prefill of its prompt
    within phase 5's tolerance, 2**-4 of the largest logit (the full
    prefill takes K1 at these lengths; those launches are counted apart),
    and the first resumed prompt's resume and full prefill are traced
    (``profile_steps``, four calls each: where a resumed admission's time
    goes). Ends with every row evicted and the pool's audit clean."""
    from tpusystem_torch.ops.cuda import flash

    queue, rows, out = list(range(len(prompts))), {}, {}
    probes, probe_launches, traces = [], 0, None
    while queue or engine.active_rows:
        while queue and engine.can_admit(len(prompts[queue[0]]), MAX_NEW,
                                         prompt=prompts[queue[0]]):
            index = queue.pop(0)
            prompt = prompts[index]
            torch.cuda.synchronize()
            started = time.perf_counter()
            admission = engine.admit(prompt, MAX_NEW)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - started
            shared = engine.pool.shared_tokens(admission.row)
            rows[admission.row] = index
            out[index] = dict(first=admission.token, ttft_s=seconds,
                              shared=shared)
            if probe and shared:
                before = flash.flash_attention_lse.launches
                slots = engine.pool.slots(admission.row)
                resumed, _ = engine._resume(prompt, slots, shared)
                full, _ = engine._prefill(prompt)
                if not traces:
                    traces = dict(prompt=index, resumed=profile_steps(
                        torch, lambda: engine._resume(prompt, slots, shared)),
                        full=profile_steps(
                            torch, lambda: engine._prefill(prompt)))
                probe_launches += flash.flash_attention_lse.launches - before
                err = (resumed - full).abs().max().item()
                tol = 2 ** -4 * full.abs().max().item()
                if not err <= tol:
                    fail(f'resumed prompt {index}: logits {err} from the '
                         f'full prefill, over {tol}')
                probes.append(dict(prompt=index, max_abs_err=err, tol=tol,
                                   argmax_equal=bool(resumed.argmax()
                                                     == full.argmax())))
        for row, reason, tokens in engine.step().finished:
            if reason != 'length' or len(tokens) != MAX_NEW:
                fail(f'row {row}: {reason}, {len(tokens)} tokens')
            out[rows.pop(row)]['tokens'] = tokens
    audit = engine.pool.audit()
    if audit['live'] or audit['free'] + audit['cached'] \
            != engine.pool.blocks - 1:
        fail(f'pool audit after every eviction: {audit}')
    return dict(requests=[out[index] for index in range(len(prompts))],
                probes=probes, probe_k1_launches=probe_launches, audit=audit,
                traces=traces)


def serve_prefix(torch, seed: int) -> dict:
    """Phase 18: GPT-2 125M (phase 5's weights) through ``Engine(rows=8,
    block_size=16, share_prefix=True)``: eight prompts behind one 256-token
    prefix with suffixes of 16-200 tokens, two behind one 640-token prefix
    (the first of each group prefills in full through K1: buckets 512 and
    1024). Every admission that hits resumes (``resumed_prefills`` equals
    ``prefix_hits``, eight here), K1 launches only for the two full
    prefills, each resumed first-token logit row is within tolerance of a
    full prefill (``serve_queue``), the pool's audit is clean at the end;
    then the same prompts without sharing: the shares of equal first tokens
    and of equal 32-token streams, and TTFT resumed against full."""
    import gc
    import statistics

    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.serve import Engine

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    prompts = prefix_prompts(seed, module.vocab_size)
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK,
                    share_prefix=True)
    flash.flash_attention_lse.launches = 0
    shared = serve_queue(torch, engine, prompts, probe=True)
    k1 = flash.flash_attention_lse.launches - shared['probe_k1_launches']
    hits = len(prompts) - 2
    if engine.sharing['prefix_hits'] != hits \
            or engine.sharing['resumed_prefills'] != hits:
        fail(f'sharing counters {engine.sharing}: {hits} hits, each resumed')
    if k1 != 2 * module.layers:
        fail(f'K1 launched {k1} times for the shared run, not once a layer '
             'for each of the two full prefills')
    full = serve_queue(torch, Engine(module, None, rows=ROWS,
                                     block_size=BLOCK), prompts)
    pairs = list(zip(shared['requests'], full['requests']))
    resumed = [a['ttft_s'] for a, _ in pairs if a['shared']]
    unshared = [b['ttft_s'] for a, b in pairs if a['shared']]
    return dict(
        sharing=dict(engine.sharing), prefix_hit_rate=engine.prefix_hit_rate(),
        k1_launches=k1, probes=shared['probes'],
        first_token_equal=sum(a['first'] == b['first'] for a, b in pairs)
        / len(pairs),
        stream_equal=sum(a['tokens'] == b['tokens'] for a, b in pairs)
        / len(pairs),
        ttft_s=[dict(shared=a['shared'], prompt=len(prompt),
                     resumed=a['ttft_s'], full=b['ttft_s'])
                for (a, b), prompt in zip(pairs, prompts)],
        ttft_median_resumed_s=statistics.median(resumed),
        ttft_median_full_s=statistics.median(unshared),
        traces=shared['traces'], audit=shared['audit'],
        seconds=time.perf_counter() - started)


def mlp_card_vs_cpu(torch) -> dict:
    """Phase 19: one step of the verybasic MLP (dropout 0.1, one hidden
    layer of 128, the example's Adam at 1e-3) from the same weights, batch
    and seed on the card and on the CPU: the same masks (the mask kernel
    against the plain bits), so loss and parameters agree within
    ``MLP_TOL`` (float32 sums in another order). The card's module loads
    the CPU's weights: an MLP draws its first weights on its own device,
    and the card's generator gives other numbers than the CPU's."""
    import numpy as np

    from tpusystem_torch.data import SyntheticDigits
    from tpusystem_torch.models import MLP
    from tpusystem_torch.train import Adam, CrossEntropyLoss, init_state

    images, labels = SyntheticDigits(samples=64)[np.arange(64)]
    weights = MLP(features=(128,), device='cpu').state_dict()
    results = []
    for where in ('cuda', 'cpu'):
        module = MLP(features=(128,), device=where)
        module.load_state_dict(weights)
        optimizer = Adam(lr=1e-3)
        state = init_state(module, optimizer)
        step = build_train_step(module_apply(module), CrossEntropyLoss(),
                                optimizer)
        state, (_, loss) = step(state, torch.from_numpy(images).to(where),
                                torch.from_numpy(labels).to(where))
        results.append((loss.item(), {name: tensor.detach().cpu() for
                                      name, tensor in state.params.items()}))
    (card, card_params), (cpu, cpu_params) = results
    err = max([abs(card - cpu)] + [
        (card_params[name] - tensor).abs().max().item()
        for name, tensor in cpu_params.items()])
    if not err <= MLP_TOL:
        fail(f'the MLP step on the card is {err} from the CPU, over '
             f'{MLP_TOL}')
    return dict(loss_card=card, loss_cpu=cpu, max_abs_err=err, tol=MLP_TOL)


def verybasic(torch) -> dict:
    """Phase 19: ``examples/verybasic_torch/train.py``'s ``main()`` on the
    card (the MLP on ``SyntheticDigits``, Adam, three epochs): the epoch
    loss falls every epoch and the mask kernel launches once a step and
    hidden layer; ``mlp_card_vs_cpu``; then ``events.py``, ``prodcon.py``
    and ``pubsub.py`` print what the reference's scripts print
    (``VERYBASIC_OUTPUT``)."""
    import contextlib
    import importlib.util
    import io

    from tpusystem_torch.ops.cuda import threefry as tf

    directory = pathlib.Path(__file__).resolve().parent / 'examples' / \
        'verybasic_torch'

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f'verybasic_torch_{name}', directory / f'{name}.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    started = time.perf_counter()
    train_example = load('train')
    tf.bernoulli_mask.launches = 0
    losses = train_example.main()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - started
    launches = tf.bernoulli_mask.launches
    steps, hidden = 3 * (2048 // 64), 1
    if launches != steps * hidden:
        fail(f'the mask kernel launched {launches} times in {steps} steps '
             f'of {hidden} hidden layer')
    if not all(a > b for a, b in zip(losses, losses[1:])):
        fail(f'the verybasic epoch losses did not fall: {losses}')
    step = mlp_card_vs_cpu(torch)
    for name, want in VERYBASIC_OUTPUT.items():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            load(name).main()
        if printed.getvalue() != want:
            fail(f'examples/verybasic_torch/{name}.py printed '
                 f'{printed.getvalue()!r}, not {want!r}')
    return dict(losses=losses, steps=steps, bernoulli_mask_launches=launches,
                train_s=train_s, step_card_vs_cpu=step,
                examples=sorted(VERYBASIC_OUTPUT),
                seconds=time.perf_counter() - started)


def spec_generate(torch, seed: int) -> dict:
    """Phase 20: ``benchmarks/speculative_decode.py``'s pair trained on the
    card through the port's ``build_train_step`` as that script trains them
    (``SPEC_TARGET`` and ``SPEC_DRAFT``, float32, 300 AdamW steps at lr 1e-3
    each on the same 64 x 64 ``SyntheticTokens`` batch, losses falling),
    then ``generate`` against ``speculative_generate`` at batch 1 and 8,
    ``SPEC_STEPS`` new tokens from 16-token prompts, for K in
    ``SPEC_WIDTHS``: tokens/s of both (each timed on a second call), the
    mean tokens a row takes a round (``speculative_generate.rounds``
    counts the verify forwards) and the share of rows equal to plain
    greedy (float32 on the card: a K+1-token verify may round a near-tie
    apart from a one-token step, so the share is printed, not required);
    ``tree_fanout=2`` at K = 5; and one pass at temperature 0.8, whose
    tokens must lie in the vocabulary and repeat with the same key (its
    draws launch the uniform kernel)."""
    import numpy as np

    from tpusystem_torch.data import SyntheticTokens
    from tpusystem_torch.models import GPT2
    from tpusystem_torch.ops.cuda import threefry as tf
    from tpusystem_torch.train import (AdamW, NextTokenLoss,
                                       build_train_step, generate,
                                       init_state, module_apply,
                                       speculative_generate)

    started = time.perf_counter()
    dataset = SyntheticTokens(samples=64 * 16, sequence_length=64,
                              vocab_size=SPEC_VOCAB)
    batch = torch.as_tensor(np.stack([dataset[i][0] for i in range(64)]),
                            device='cuda').long()

    def trained(config, offset: int):
        module = GPT2(**config, device='cuda')
        module.init_weights(torch.Generator('cuda').manual_seed(seed
                                                                + offset))
        optimizer = AdamW(lr=1e-3)
        state = init_state(module, optimizer)
        step = build_train_step(module_apply(module), NextTokenLoss(),
                                optimizer)
        losses = []
        for _ in range(SPEC_TRAIN_STEPS):
            state, (_, loss) = step(state, batch, batch)
            losses.append(loss)
        losses = [losses[0].item(), losses[-1].item()]
        if not (math.isfinite(losses[1]) and losses[1] < losses[0]):
            fail(f'speculative pair: training losses {losses}')
        return module, losses

    target, target_losses = trained(SPEC_TARGET, 0)
    draft, draft_losses = trained(SPEC_DRAFT, 1)
    train_s = time.perf_counter() - started

    def timed(fn, tokens: int):
        fn()
        torch.cuda.synchronize()
        began = time.perf_counter()
        out = fn().cpu().numpy()
        return out, tokens / (time.perf_counter() - began)

    runs = []
    for rows in (1, 8):
        prompt = torch.as_tensor(np.stack([SyntheticTokens(
            samples=1, sequence_length=16, vocab_size=SPEC_VOCAB,
            seed=99 + i)[0][0] for i in range(rows)]), device='cuda')
        plain, plain_tps = timed(lambda: generate(
            target, None, prompt, steps=SPEC_STEPS), rows * SPEC_STEPS)
        cases = [(K, 1) for K in SPEC_WIDTHS] + [(SPEC_TREE_K, 2)]
        for K, fanout in cases:
            spec, spec_tps = timed(lambda: speculative_generate(
                target, None, prompt, steps=SPEC_STEPS, draft_module=draft,
                draft_params=None, speculate=K, tree_fanout=fanout),
                rows * SPEC_STEPS)
            runs.append(dict(
                batch=rows, speculate=K, tree_fanout=fanout,
                plain_tokens_per_s=plain_tps, spec_tokens_per_s=spec_tps,
                speedup=spec_tps / plain_tps,
                tokens_per_round=(SPEC_STEPS - 1)
                / speculative_generate.rounds,
                rows_equal_to_greedy=float(np.mean(
                    (spec == plain).all(1)))))
    prompt = torch.as_tensor(np.stack([SyntheticTokens(
        samples=1, sequence_length=16, vocab_size=SPEC_VOCAB,
        seed=99 + i)[0][0] for i in range(8)]), device='cuda')
    tf.row_uniforms.launches = 0
    sampled = [speculative_generate(
        target, None, prompt, steps=SPEC_STEPS, draft_module=draft,
        draft_params=None, speculate=SPEC_TREE_K, temperature=0.8,
        rng=(0, seed)).cpu().numpy() for _ in range(2)]
    if not ((sampled[0] >= 0) & (sampled[0] < SPEC_VOCAB)).all():
        fail('sampled speculative tokens out of the vocabulary')
    if not np.array_equal(*sampled):
        fail('sampled speculative decode differs on a repeat with the same '
             'key')
    if not tf.row_uniforms.launches:
        fail('sampled speculative decode did not launch the uniform kernel')
    return dict(target=SPEC_TARGET, draft=SPEC_DRAFT,
                target_losses=target_losses, draft_losses=draft_losses,
                train_s=train_s, steps=SPEC_STEPS, runs=runs,
                sampled=dict(temperature=0.8, repeat_equal=True,
                             tokens_per_round=(SPEC_STEPS - 1)
                             / speculative_generate.rounds,
                             row_uniforms_launches=tf.row_uniforms.launches),
                card=card_line(), seconds=time.perf_counter() - started)


def spec_engines(torch, module, draft):
    """Phase 21's engines: the self-draft at ``tree_fanout`` 1 and 2 and the
    random draft, ``speculate`` 3 each."""
    from tpusystem_torch.serve import Engine

    return {
        'self-f1': Engine(module, None, rows=ROWS, block_size=BLOCK,
                          draft_module=module, speculate=SPEC_K),
        'self-f2': Engine(module, None, rows=ROWS, block_size=BLOCK,
                          draft_module=module, speculate=SPEC_K,
                          tree_fanout=2),
        'random': Engine(module, None, rows=ROWS, block_size=BLOCK,
                         draft_module=draft, speculate=SPEC_K)}


def serve_spec(torch, seed: int, bf16_tokens: list) -> dict:
    """Phase 21: speculative rows on phase 5's GPT-2 125M weights and
    prompts, 32 new tokens each, ``speculate`` 3, through (a) a self-draft
    (the target drafting for itself with its own weights) at
    ``tree_fanout`` 1 and 2, (b) a random draft at the benchmark's draft
    shape with GPT-2's vocabulary (``SPEC_SERVE_DRAFT``), and (c) the
    self-draft with ``SPEC_SAMPLED`` rows (two at temperature 0.8, one at
    ``top_k`` 40, one greedy on a 700-token prompt, so the deepest row,
    and with it every read window, is the same as in (a) while it runs).
    (a) takes fewer engine steps than it emits tokens and its first tokens
    equal phase 5's; the streams' share equal to phase 5's is printed
    (bf16 near-ties between a 4-token verify and a one-token step); (b)
    emits in the vocabulary, its share equal to (a)'s printed; (c) launches
    the uniform kernel, its greedy row equals its stream in (a), and a
    ``mask_fn`` admission raises. K1 launches once a layer for every target
    and draft prefill of 512 tokens or more; K4/K5 never; the pool's audit
    is clean after every eviction. Decode tokens/s, step ms, tokens a step
    and accepted drafts a request and step for each engine, and four traced
    steps of (a) with the draft's and the verify's device ms apart."""
    import gc

    from tpusystem_torch.models import GPT2, gpt2_small
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda import threefry as tf
    from tpusystem_torch.serve import Engine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    draft = GPT2(**SPEC_SERVE_DRAFT, device='cuda')
    draft.init_weights(torch.Generator('cuda').manual_seed(seed + 1))
    prompts = serving_prompts(seed, module.vocab_size)
    buckets = [prefill_bucket_of(len(p)) for p in prompts]
    results, streams = {}, {}
    for name, engine in spec_engines(torch, module, draft).items():
        if engine.decode_impl != 'flax':
            fail(f'the {name} engine chose decode_impl='
                 f"{engine.decode_impl!r}, not 'flax'")
        dm.reset_launches()
        flash.flash_attention_lse.launches = 0
        run = drive_engine(torch, engine, prompts, audit=True,
                           profile_at=4 if name == 'self-f1' else None)
        drafter = engine._drafter
        flashed = sum(module.layers + drafter.layers for bucket in buckets
                      if bucket >= 512)
        launches = {'flash_attention_lse': flash.flash_attention_lse.launches,
                    'decode_matmul': dm.decode_matmul.launches,
                    'decode_ffn': dm.decode_ffn.launches}
        if launches != {'flash_attention_lse': flashed, 'decode_matmul': 0,
                        'decode_ffn': 0}:
            fail(f'{name}: launched {launches}; expected K1 {flashed} times '
                 '(each target and draft prefill of 512 tokens or more) and '
                 'K4/K5 never')
        audit = engine.pool.audit()
        if audit['live'] or audit['free'] != engine.pool.blocks - 1:
            fail(f'{name}: pool audit at the end {audit}')
        tokens = streams[name] = run.pop('tokens')
        spec = engine.speculation
        pairs = [(a, b) for got, want in zip(tokens, bf16_tokens)
                 for a, b in zip(got, want)]
        results[name] = dict(
            run, launches=launches, speculation=dict(spec),
            tokens_per_request_step=run['decode_tokens'] / spec['groups'],
            accepted_per_round=spec['accepted'] / spec['groups'],
            equal_to_phase5=sum(a == b for a, b in pairs) / len(pairs),
            first_tokens_equal_to_phase5=sum(
                got[0] == want[0] for got, want in zip(tokens, bf16_tokens))
            / len(tokens))
        if name.startswith('self'):
            if not run['engine_steps'] < run['decode_tokens']:
                fail(f"{name}: {run['engine_steps']} steps for "
                     f"{run['decode_tokens']} tokens")
            if results[name]['first_tokens_equal_to_phase5'] != 1.0:
                fail(f'{name}: first tokens differ from phase 5')
        print(f'serve-spec-{name} ' + json.dumps(
            {key: value for key, value in results[name].items()
             if key != 'profile'}))
        del engine
    pairs = [(a, b) for got, want in zip(streams['random'],
                                         streams['self-f1'])
             for a, b in zip(got, want)]
    results['random']['equal_to_self_draft'] = sum(
        a == b for a, b in pairs) / len(pairs)
    trace = results['self-f1'].pop('profile')
    results['self-f1']['trace'] = {key: trace[key] for key in (
        'steps', 'traced_step_ms', 'device_ms_per_step',
        'device_busy_share', 'device_ops_per_step', 'range_device_ms')}

    # (c): sampled rows on the self-draft; the greedy row is the 700-token
    # prompt's
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK,
                    draft_module=module, speculate=SPEC_K)
    try:
        engine.admit(prompts[0], MAX_NEW, sampling=SamplingParams(
            mask_fn=even_ids))
        fail('a mask_fn admission on speculative rows did not raise')
    except ValueError as error:
        if 'speculative' not in str(error):
            raise
    chosen = [index for index, _ in SPEC_SAMPLED]
    tf.row_uniforms.launches = tf.row_uniforms_plain.runs = 0
    run = drive_engine(torch, engine, [prompts[i] for i in chosen],
                       samplings=[None if spec is None
                                  else SamplingParams(**spec)
                                  for _, spec in SPEC_SAMPLED], audit=True)
    if not tf.row_uniforms.launches or tf.row_uniforms_plain.runs:
        fail(f'sampled speculative rows launched the uniform kernel '
             f'{tf.row_uniforms.launches} times, the plain version ran '
             f'{tf.row_uniforms_plain.runs}')
    for got, (index, spec) in zip(run['tokens'], SPEC_SAMPLED):
        if spec is None and got != streams['self-f1'][index]:
            fail(f'the greedy row on prompt {index} differs from its stream '
                 'in the self-draft run')
    spec = engine.speculation
    results['sampled'] = dict(
        {key: run[key] for key in ('decode_tokens_per_s', 'step_ms',
                                   'step_ms_quantiles', 'engine_steps',
                                   'decode_tokens')},
        rows=[str(spec) for _, spec in SPEC_SAMPLED],
        row_uniforms_launches=tf.row_uniforms.launches,
        tokens_per_request_step=run['decode_tokens'] / spec['groups'],
        accepted_per_round=spec['accepted'] / spec['groups'],
        greedy_row_equal=True, mask_fn_refused=True)
    return dict(results, buckets=buckets, speculate=SPEC_K,
                draft=SPEC_SERVE_DRAFT, card=card_line(),
                seconds=time.perf_counter() - started)


def prefill_bucket_of(length: int) -> int:
    """The engine's prefill bucket of a GPT-2 125M prompt (block 16,
    ``max_seq`` 1024)."""
    from tpusystem_torch.serve import prefill_bucket
    return prefill_bucket(length, BLOCK, 1024)


def check_grouped_serving(torch, generator) -> list:
    """Phase 22's kernel checks: K6 and K7's forward calls at the serving
    shapes of the MoE model (8 experts, top-2, full capacity): a decode
    step's 8 tokens at capacity 8 (a 64-row buffer) and a 1,024-token
    prefill's at capacity 1,024, each against its plain version, repeated
    bitwise, timed beside the plain version, ``torch.bmm`` over the rows
    gathered into the buffer beforehand and its bound (the seated rows'
    flops; each input read once, each output written once). The kernel
    and ``bmm`` are timed by ``graph_measure`` (CUDA events over calls back
    to back in a graph: a profiled window of calls this short came back
    under the bytes' bound in one run), each call on the next of several
    input sets (``rotating``), since one set's expert weights (37.7 MB a
    product) would otherwise stay in the 50 MB L2 from call to call, as
    they cannot between a serving step's layers; the plain version by
    ``measure``'s events (K7's plain combine syncs, so no graph)."""
    from tpusystem_torch.ops import moe
    from tpusystem_torch.ops.cuda import grouped_matmul as gm

    results = []
    for label, tokens in GROUPED_SERVING:
        def make():
            g = grouped_inputs(torch, generator, tokens, MOE_EXPERTS, MOE_K,
                               tokens)
            g['gathered'] = moe._take(g['x'], g['slot_token']).reshape(
                MOE_EXPERTS, tokens, DIM)
            return g
        first = make()
        capacity, seated = first['capacity'], first['seated']
        rows = MOE_EXPERTS * capacity
        ids_bytes = rows * 8
        flops = 2 * seated * DIM * HIDDEN
        moved = {
            'gather_rows_matmul[fwd]':
                tokens * DIM * 2 + first['w1'].numel() * 2 + ids_bytes
                + rows * HIDDEN * 2,
            'matmul_scatter_rows[fwd]':
                rows * HIDDEN * 2 + first['w2'].numel() * 2 + MOE_EXPERTS
                * DIM * 2 + ids_bytes + tokens * DIM * 2 + rows * DIM * 2}
        sets = [first] + rotating(make, moved['gather_rows_matmul[fwd]'])
        calls = [grouped_calls(gm, g) for g in sets]
        library = {'gather_rows_matmul[fwd]': lambda g: (g['gathered'],
                                                         g['w1']),
                   'matmul_scatter_rows[fwd]': lambda g: (
                       g['grown'].reshape(MOE_EXPERTS, capacity, HIDDEN),
                       g['w2'])}
        for name in moved:
            kernel, plain, args, options = calls[0][name]
            run = lambda i: calls[i % len(sets)][name][0](
                *calls[i % len(sets)][name][2], **options)
            bitwise, finite, pairs = grouped_errors(
                torch, run(0), run(len(sets)), plain(*args, **options),
                tokens, first['slot_token'])
            err, tol = worst(pairs)
            kernel_name = name.split('[')[0]
            if not (finite and bitwise):
                fail(f'{kernel_name}[{label}]: finite {finite}, bitwise '
                     f'repeat {bitwise}')
            operands = [library[name](g) for g in sets]
            results.append(record_check(
                f'{kernel_name}[{label}]', [tokens, MOE_EXPERTS, capacity,
                                             DIM, HIDDEN],
                err, tol, graph_measure(torch, cycling(run)),
                measure(lambda i: plain(*args, **options), calls=5),
                graph_measure(torch, cycling(
                    lambda i: torch.bmm(*operands[i % len(sets)]))),
                bound_ms(moved[name], flops), by_events=True, flops=flops,
                bitwise_repeat=bitwise, seated_rows=seated, buffer_rows=rows,
                input_sets=len(sets),
                timing='graph_measure: CUDA events over a graph (plain: '
                'measure, CUDA events)',
                library_call='torch.bmm over the rows gathered into the '
                f'[8, {capacity}, k] buffer beforehand: the product alone'))
        del sets, calls
    return results


def serve_moe(torch, seed: int) -> dict:
    """Phase 22: the 8-expert GPT-2 MoE (``benchmarks/moe_ceiling.py``'s
    whole-model settings: the 125M body, 8 experts top-2 in every second
    block, vocab 50304, ``moe_sparse_impl='fused'``; random weights from
    ``seed``) through ``Engine(rows=8, block_size=16)`` on phase 5's
    prompts, 32 new tokens each: the route resolves to the module paged
    step, K4/K5 never launch, K6 and K7 once per MoE block for every
    prefill and every decode step (6 each a step), K1 once a layer for
    each prefill of 512 tokens or more; then the logits through the paged
    cache at one request's prefill and first 4 decode steps against the
    non-cached forward (xla attention, the gather impl at a capacity that
    seats every token: no kernel), within phase 15's tolerance; decode
    tokens/s, step ms and a traced window of 4 steps with the grouped
    kernels' device ms."""
    import gc

    from tpusystem_torch.models import GPT2
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.ops.cuda import grouped_matmul as gm
    from tpusystem_torch.serve import Engine

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    module = GPT2(vocab_size=50304, dropout=0.0, moe_experts=MOE_EXPERTS,
                  moe_every=2, moe_k=MOE_K, moe_sparse_impl='fused',
                  device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK)
    if engine.decode_impl != 'flax':
        fail(f'the MoE engine chose decode_impl={engine.decode_impl!r}, '
             "not 'flax' (the module paged step)")
    prompts = serving_prompts(seed, 50257)
    buckets = [engine.bucket(len(prompt)) for prompt in prompts]
    moe_layers = sum(module.is_moe(i) for i in range(module.layers))
    counters = (gm.gather_rows_matmul, gm.matmul_scatter_rows,
                flash.flash_attention_lse)
    dm.reset_launches()
    for counter in counters:
        counter.launches = 0
    run = drive_engine(torch, engine, prompts, profile_at=8,
                       sums=('grouped_gemm_kernel', 'combine_rows_kernel'))
    launches = {counter.__name__: counter.launches for counter in counters}
    launches.update(decode_matmul=dm.decode_matmul.launches,
                    decode_ffn=dm.decode_ffn.launches)
    grouped = moe_layers * (len(prompts) + run['engine_steps'])
    want = {'gather_rows_matmul': grouped, 'matmul_scatter_rows': grouped,
            'flash_attention_lse': module.layers * sum(
                bucket >= 512 for bucket in buckets),
            'decode_matmul': 0, 'decode_ffn': 0}
    if launches != want:
        fail(f'MoE serving launched {launches}, expected {want}')
    full = module.replace(decode=False, attention='xla',
                          moe_sparse_impl='gather',
                          moe_capacity_factor=MOE_EXPERTS / MOE_K)
    before = {counter.__name__: counter.launches for counter in counters}
    probe = llama_probe(torch, engine, module, prompts[1], full=full)
    del run['tokens']
    profile = run.pop('profile')
    return dict(run, **probe, launches=launches, moe_layers=moe_layers,
                grouped_per_decode_step=moe_layers, buckets=buckets,
                probe_launches={name: counter.launches - before[name]
                                for name, counter in zip(before, counters)},
                profile={key: profile[key] for key in (
                    'steps', 'traced_step_ms', 'device_ms_per_step',
                    'device_busy_share', 'device_ops_per_step',
                    'kernel_ms_per_step', 'top_kernels_us_per_step')},
                card=card_line(), seconds=time.perf_counter() - started)


def handoff_timers(torch, fleet, wire, prefill_handle, prefill_engine,
                   decode_engine) -> dict:
    """Wrap each step of a hand-off with a host timer: the prefill engine's
    ``export_prefill`` (its prefill, first token and the strips' copy to
    the host), ``pack_handoff`` (pickle and digest), the prefill handle's
    offer into its ``KVStripStore``, the ``Loopback`` fetch,
    ``unpack_handoff`` (digest and unpickle) and the decode engine's
    ``admit_prefilled`` (the strips' copy to the card and the scatter,
    synchronised). K1's counter must not move across an
    ``admit_prefilled``; the K1, K4 and K5 launches of each engine's calls
    are tallied by side. ``restore()`` puts the fleet module's functions
    back."""
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash

    record = {name: [] for name in DISAGG_PARTS}
    record['payload_bytes'] = []
    sides = {side: dict(flash_attention_lse=0, decode_matmul=0,
                        decode_ffn=0) for side in ('prefill', 'decode')}

    def counts():
        return dict(flash_attention_lse=flash.flash_attention_lse.launches,
                    decode_matmul=dm.decode_matmul.launches,
                    decode_ffn=dm.decode_ffn.launches)

    def timed(name, call, side=None, sync=False):
        def run(*args, **kwargs):
            before = counts()
            started = time.perf_counter()
            out = call(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            if name is not None:
                record[name].append(time.perf_counter() - started)
            after = counts()
            if side is not None:
                for key, value in after.items():
                    sides[side][key] += value - before[key]
            if name == 'admit_prefilled' and (
                    after['flash_attention_lse']
                    != before['flash_attention_lse']):
                fail('K1 launched inside admit_prefilled')
            if name == 'pack':
                record['payload_bytes'].append(len(out))
            return out
        return run

    originals = (fleet.pack_handoff, fleet.unpack_handoff)
    fleet.pack_handoff = timed('pack', fleet.pack_handoff)
    fleet.unpack_handoff = timed('unpack', fleet.unpack_handoff)
    wire.fetch_blob = timed('fetch', wire.fetch_blob)
    prefill_handle.offer_strips = timed('offer', prefill_handle.offer_strips)
    prefill_engine.export_prefill = timed(
        'export_prefill', prefill_engine.export_prefill, 'prefill')
    prefill_engine.step = timed(None, prefill_engine.step, 'prefill')
    decode_engine.admit_prefilled = timed(
        'admit_prefilled', decode_engine.admit_prefilled, 'decode',
        sync=True)
    decode_engine.step = timed(None, decode_engine.step, 'decode')

    def restore():
        fleet.pack_handoff, fleet.unpack_handoff = originals
    return dict(record=record, sides=sides, restore=restore)


def engine_clock(torch, engine, seated: dict, method: str) -> dict:
    """Time ``engine``'s decode steps (host seconds of the steps that
    emitted, and their tokens) and stamp the moment each request's first
    token is seated (``method``: ``'admit'`` or ``'admit_prefilled'``,
    synchronised; keyed by the request id the scheduler passes as
    ``tag``)."""
    clock = dict(step_s=0.0, emitted=0, steps=0)
    step, seat = engine.step, getattr(engine, method)

    def stepped():
        report = step()
        if report.emitted:
            clock['step_s'] += engine.last_step_seconds
            clock['steps'] += 1
            clock['emitted'] += sum(len(t) for t in report.emitted.values())
        return report

    def seating(*args, **kwargs):
        admission = seat(*args, **kwargs)
        torch.cuda.synchronize()
        seated[kwargs['tag']] = time.perf_counter()
        return admission

    engine.step = stepped
    setattr(engine, method, seating)
    return clock


def decode_rates(clock: dict, submitted: dict, seated: dict,
                 wall: float) -> dict:
    return dict(decode_tokens_per_s=clock['emitted'] / clock['step_s'],
                step_ms=1e3 * clock['step_s'] / clock['steps'],
                ttft_s=[seated[rid] - submitted[rid]
                        for rid in sorted(seated)], wall_s=wall)


def stream_share(got: dict, want: dict) -> dict:
    """The share of requests whose streams equal ``want``'s, and the first
    differing request and token index where one differs."""
    equal, first = 0, None
    for rid in want:
        a, b = list(got[rid].tokens), list(want[rid].tokens)
        if a == b:
            equal += 1
        elif first is None:
            step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                        min(len(a), len(b)))
            first = dict(request=rid, step=step)
    return dict(share=equal / len(want), first_difference=first)


def disagg_requests(prompts: list) -> list:
    from tpusystem_torch.serve import Request
    return [Request(f'r{index}', [int(t) for t in prompt], MAX_NEW)
            for index, prompt in enumerate(prompts)]


def check_completed(name: str, results: dict, count: int) -> None:
    if sorted(results) != sorted(f'r{i}' for i in range(count)):
        fail(f'{name}: {len(results)} of {count} requests completed')
    for rid, completion in results.items():
        if completion.reason != 'length' or len(completion.tokens) \
                != MAX_NEW:
            fail(f'{name} {rid}: {completion.reason}, '
                 f'{len(completion.tokens)} tokens')


def fused_engine(module, **knobs):
    from tpusystem_torch.serve import Engine
    engine = Engine(module, None, rows=ROWS, block_size=BLOCK, **knobs)
    if engine.decode_impl != 'fused':
        fail(f'a phase 23 engine chose decode_impl={engine.decode_impl!r}, '
             "not 'fused'")
    return engine


def disagg_serving(torch, module, prompts) -> tuple:
    """Phase 23 (a): a colocated ``Scheduler`` on one engine, then a
    ``Router`` over a prefill ``ServingReplica``
    (``Scheduler(prefill_only=True)``) and a decode one, the hand-offs over
    one ``Loopback`` through the prefill handle's ``KVStripStore``, on the
    same requests. Returns (the colocated completions, the record)."""
    from tpusystem_torch.observe.events import PrefillHandoff
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.parallel.multihost import Loopback
    from tpusystem_torch.serve import (ReplicaHandle, Router, Scheduler,
                                       ServingReplica, fleet)
    from tpusystem_torch.services.prodcon import Consumer, Producer

    colocated_engine, prefill_engine, decode_engine = (
        fused_engine(module) for _ in range(3))
    submitted, seated = {}, {}
    clock = engine_clock(torch, colocated_engine, seated, 'admit')
    scheduler = Scheduler(colocated_engine)
    torch.cuda.synchronize()
    started = time.perf_counter()
    for request in disagg_requests(prompts):
        submitted[request.id] = time.perf_counter()
        scheduler.submit(request)
    colocated = scheduler.run()
    torch.cuda.synchronize()
    colocated_rates = decode_rates(clock, submitted, seated,
                                   time.perf_counter() - started)

    wire, producer, handoffs = Loopback(), Producer(), []
    consumer = Consumer('phase-23')
    consumer.register(PrefillHandoff, handoffs.append)
    producer.register(consumer)
    prefill = ReplicaHandle(ServingReplica(
        lambda: Scheduler(prefill_engine, prefill_only=True),
        identity='prefill', role='prefill'), transport=wire)
    decode = ReplicaHandle(ServingReplica(
        lambda: Scheduler(decode_engine), identity='decode', role='decode'),
        transport=wire)
    router = Router([prefill, decode], producer=producer)
    submitted, seated = {}, {}
    clock = engine_clock(torch, decode_engine, seated, 'admit_prefilled')
    timers = handoff_timers(torch, fleet, wire, prefill, prefill_engine,
                            decode_engine)
    dm.reset_launches()
    flash.flash_attention_lse.launches = 0
    try:
        torch.cuda.synchronize()
        started = time.perf_counter()
        for request in disagg_requests(prompts):
            submitted[request.id] = time.perf_counter()
            if router.submit(request) != 'prefill':
                fail(f'{request.id} did not land on the prefill replica')
        disaggregated = router.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
    finally:
        timers['restore']()
    launches = {'flash_attention_lse': flash.flash_attention_lse.launches,
                'decode_matmul': dm.decode_matmul.launches,
                'decode_ffn': dm.decode_ffn.launches}
    sides, record = timers['sides'], timers['record']
    if not (sides['decode']['decode_matmul']
            and sides['decode']['decode_ffn']):
        fail(f'K4/K5 did not launch on the decode side: {sides}')
    if sides['prefill']['decode_matmul'] or sides['prefill']['decode_ffn'] \
            or sides['decode']['flash_attention_lse']:
        fail(f'a replica ran the other role\'s kernels: {sides}')
    want_k1 = module.layers * sum(prefill_engine.bucket(len(prompt)) >= 512
                                  for prompt in prompts)
    if sides['prefill']['flash_attention_lse'] != want_k1:
        fail(f"K1 launched {sides['prefill']['flash_attention_lse']} times "
             f'on the prefill side, expected {want_k1}')
    check_completed('colocated', colocated, len(prompts))
    check_completed('disaggregated', disaggregated, len(prompts))
    firsts = sum(disaggregated[rid].tokens[0] == colocated[rid].tokens[0]
                 for rid in colocated)
    if firsts != len(colocated):
        fail(f'first tokens: {firsts} of {len(colocated)} equal to the '
             'colocated run')
    if len(record['admit_prefilled']) != len(prompts) \
            or len(handoffs) != len(prompts):
        fail(f"{len(record['admit_prefilled'])} admit_prefilled calls and "
             f'{len(handoffs)} hand-offs for {len(prompts)} requests')
    return colocated, dict(
        streams_equal=stream_share(disaggregated, colocated),
        first_tokens_equal_share=firsts / len(colocated),
        launches=launches, launches_by_side=sides,
        handoff_kv_bytes=sorted({event.bytes for event in handoffs}),
        handoff_payload_bytes=sorted(set(record['payload_bytes'])),
        handoff_ms={name: [1e3 * s for s in record[name]]
                    for name in DISAGG_PARTS},
        handoff_ms_median={name: 1e3 * quantiles(record[name])[1]
                           for name in DISAGG_PARTS},
        colocated=colocated_rates,
        disaggregated=dict(decode_rates(clock, submitted, seated, wall),
                           router_ticks=router.ticks))


def service_streams(torch, module, prompts, colocated: dict) -> dict:
    """Phase 23 (b): ``InferenceService`` on the card (no ``device=``), the
    same requests with ``on_token`` callbacks: the streamed and completed
    tokens equal the colocated run's, and the ``Producer``'s events are
    counted by type."""
    from tpusystem_torch.observe import events
    from tpusystem_torch.serve import InferenceService
    from tpusystem_torch.services.prodcon import Consumer, Producer

    producer, seen = Producer(), {}
    consumer = Consumer('phase-23b')
    for name in ('RequestAdmitted', 'RequestCompleted', 'RequestEvicted',
                 'ServeStepped', 'TokenStreamed'):
        consumer.register(getattr(events, name), lambda event, name=name:
                          seen.__setitem__(name, seen.get(name, 0) + 1))
    producer.register(consumer)
    service = InferenceService(module, None, producer=producer, rows=ROWS,
                               block_size=BLOCK)
    if service.engine.device.type != 'cuda' \
            or service.engine.decode_impl != 'fused':
        fail(f'InferenceService built its engine on '
             f'{service.engine.device} with {service.engine.decode_impl!r}')
    streamed = {}
    started = time.perf_counter()
    for request in disagg_requests(prompts):
        streamed[request.id] = []
        service.submit(request, on_token=lambda index, token, rid=request.id:
                       streamed[rid].append(token))
    results = service.run_until_idle()
    torch.cuda.synchronize()
    check_completed('service', results, len(prompts))
    for rid, completion in colocated.items():
        if results[rid].tokens != completion.tokens \
                or streamed[rid] != completion.tokens:
            fail(f'InferenceService {rid} differs from the colocated run')
    return dict(events=seen, streams_equal_share=1.0,
                seconds=time.perf_counter() - started)


def kill_drill(torch, module, prompts, colocated: dict) -> dict:
    """Phase 23 (c): the (a) fleet with its decode replica journaling into a
    ``MemStore`` and killed by ``DieAtStep`` at its tick
    ``DISAGG_KILL_TICK``: the router's verdict recovers the journal, the
    dead replica is retired and its engine dropped, and a relaunched decode
    replica (a fresh engine) is adopted, onto which the router replays the
    rows (hot: prompt and emitted prefix re-prefilled). Every request
    completes, its journaled prefix equal to the colocated stream's; the old
    engine is collected, and the memory allocated after the relaunch is
    within one KV pool of that before. The share of streams equal to the
    colocated run's is printed: a replay re-makes the prefix's KV through
    the prefill's products, not K4's, and in bfloat16 the two round
    apart, so a stream may fork at a near-tie after the kill."""
    import gc
    import weakref

    from tpusystem_torch.checkpoint import MemStore
    from tpusystem_torch.observe.events import RequestRerouted
    from tpusystem_torch.parallel.chaos import DieAtStep
    from tpusystem_torch.parallel.multihost import Loopback
    from tpusystem_torch.serve import (ReplicaHandle, Router, Scheduler,
                                       ServingReplica)
    from tpusystem_torch.services.prodcon import Consumer, Producer

    wire, producer, rerouted = Loopback(), Producer(), []
    consumer = Consumer('phase-23c')
    consumer.register(RequestRerouted, rerouted.append)
    producer.register(consumer)
    prefill_engine = fused_engine(module)
    built = []

    def build():
        engine = fused_engine(module)
        built.append(weakref.ref(engine))
        return Scheduler(engine)
    store = MemStore()
    victim = ReplicaHandle(ServingReplica(
        build, identity='decode-a', role='decode', client=store,
        fault=DieAtStep(step=DISAGG_KILL_TICK)), transport=wire)
    router = Router([ReplicaHandle(ServingReplica(
        lambda: Scheduler(prefill_engine, prefill_only=True),
        identity='prefill', role='prefill'), transport=wire), victim],
        producer=producer)
    pool = sum(leaf.nbytes for path, leaf in
               victim.scheduler.engine._cache.items()
               if path.endswith(('/key', '/value')))
    for request in disagg_requests(prompts):
        router.submit(request)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    while victim.healthy:
        if router.idle:
            fail('the decode replica was never killed')
        router.step()
    killed_at = router.ticks
    # the supervisor's part: the dead replica's process is gone, so its
    # handle is retired and its engine with it
    router.handles.remove(victim)
    del victim
    gc.collect()
    torch.cuda.synchronize()
    if built[0]() is not None:
        fail('the killed decode engine is still reachable')
    started = time.perf_counter()
    router.adopt(ReplicaHandle(ServingReplica(
        build, identity='decode-b', role='decode', client=MemStore()),
        transport=wire))
    torch.cuda.synchronize()
    relaunch_s = time.perf_counter() - started
    after = torch.cuda.memory_allocated()
    if abs(after - before) > pool:
        fail(f'memory allocated after the relaunch ({after}) is more than '
             f'one KV pool ({pool}) from before it ({before})')
    results = router.run_until_idle()
    check_completed('kill drill', results, len(prompts))
    hot = [event.id for event in rerouted if event.where == 'hot']
    cold = [event.id for event in rerouted if event.where == 'cold']
    if not hot:
        fail('the kill replayed no seated row hot')
    for event in rerouted:
        # the journaled prefix survives the kill token for token
        if results[event.id].tokens[:event.prefix] \
                != colocated[event.id].tokens[:event.prefix]:
            fail(f'{event.id}: the replayed prefix differs from the '
                 'colocated stream')
    return dict(killed_at_router_tick=killed_at, replayed_hot=len(hot),
                replayed_cold=len(cold),
                replayed_prefix_tokens=sum(event.prefix
                                           for event in rerouted),
                relaunch_s=relaunch_s, memory_before=before,
                memory_after=after, kv_pool_bytes=pool,
                streams_equal=stream_share(results, colocated))


def certify(torch, module, prompts) -> dict:
    """Phase 23 (d): ``certify_fleet`` at seed ``CERTIFY_SEED`` on a fleet
    of three port engines on the card (the reference's
    ``test_certify_fleet_real_engines``: a journaled router holding a lease,
    kills of the router (the standby takes over), the standby and a
    replica), greedy and seeded-sampled requests."""
    from tpusystem_torch.checkpoint import MemStore
    from tpusystem_torch.serve import (FleetHarness, ReplicaHandle, Request,
                                       Router, RouterJournal, RouterLease,
                                       SamplingParams, Scheduler,
                                       ServingReplica, certify_fleet)

    class Clock:
        now = 1000.0

        def __call__(self):
            return self.now

    def workload():
        return [Request(f'r{index}', [int(t) for t in prompt],
                        CERTIFY_MAX_NEW,
                        sampling=SamplingParams(temperature=0.8,
                                                seed=100 + index, top_k=16)
                        if index % 2 else None)
                for index, prompt in enumerate(prompts[:6])]

    def build():
        clock, plane = Clock(), MemStore()
        handles = []
        for index in range(3):
            engine = fused_engine(module)
            handles.append(ReplicaHandle(ServingReplica(
                lambda engine=engine: Scheduler(engine, clock=clock),
                identity=f'rep{index}', client=MemStore(), clock=clock)))
        lease = RouterLease(client=plane, clock=clock)
        router = Router(handles, clock=clock,
                        journal=RouterJournal(client=plane), lease=lease)
        lease.acquire()

        def takeover():
            lease = RouterLease(client=plane, clock=clock, holder='standby')
            standby = Router(router.handles, clock=clock,
                             journal=RouterJournal(client=plane),
                             lease=lease)
            lease.acquire()
            return standby, standby.recover((plane,))

        def advance():
            clock.now += 0.05
        return FleetHarness(router=router, workload=workload(),
                            kills={'router': takeover,
                                   'standby': lambda: None,
                                   'decode': handles[2].kill},
                            advance=advance)
    started = time.perf_counter()
    report = certify_fleet(build, seed=CERTIFY_SEED, lo=1, hi=4)
    if not report.ok:
        fail(f'certify_fleet: {report.summary()}')
    return dict(summary=report.summary(), ok=report.ok,
                component=report.component, step=report.step,
                completed=report.completed, degraded=report.degraded,
                takeover=report.takeover,
                seconds=time.perf_counter() - started)


def serve_disagg(torch, seed: int) -> dict:
    """Phase 23: GPT-2 125M (phase 5's weights and requests) served through
    the port's control plane: (a) disaggregated prefill and decode against
    a colocated ``Scheduler``; (b) ``InferenceService``; (c) a kill drill on
    the decode replica; (d) ``certify_fleet`` at one seed. K1's, K4's and
    K5's launches count (a)'s run."""
    import gc

    from tpusystem_torch.models import gpt2_small

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    prompts = serving_prompts(seed, module.vocab_size)
    colocated, disagg = disagg_serving(torch, module, prompts)
    gc.collect()
    service = service_streams(torch, module, prompts, colocated)
    gc.collect()
    drill = kill_drill(torch, module, prompts, colocated)
    gc.collect()
    certified = certify(torch, module, prompts)
    return dict(disagg, service=service, kill=drill, certify=certified,
                prompt_lengths=list(PROMPT_LENGTHS), max_new=MAX_NEW,
                card=card_line(), seconds=time.perf_counter() - started)


# ---------------------------------------------------------------------------
# phase 24: the resilient trainer


RESILIENT_STEPS, RESILIENT_GROUP = 12, 4
# (e): a hot push after every step is ~1.5 GB through four BLAKE2b passes
# (~12 s a step on an H100 80GB HBM3 host), so the drill runs 8 steps, not 12
RESILIENT_KILL_STEPS, RESILIENT_DIE_AT = 8, 5
RESILIENT_BATCHES = 8           # distinct batches, cycled by step
RESILIENT_SAVE_EVERY = 4
RESILIENT_IDENTITY = 'resilient-gpt2'
# bench.py's recipe (bench.py:408-434): GPT-2 125M, vocab padded to 50304,
# flash attention, the chunked loss, AdamW at 3e-4 clipped at 1.0
RESILIENT_MODEL = dict(vocab_size=50304, dropout=0.0, attention='flash',
                       return_features=True)


class Recipe:
    """Phase 24's training cell: a module factory (the unrolled weights
    drawn from ``seed``, restacked under ``hs`` for ``scan_layers``), its
    criterion, optimizer and batches. ``model`` overrides ``gpt2_small``'s
    fields; the CPU test passes ``gpt2_tiny``'s widths."""

    def __init__(self, torch, seed: int, device: str = 'cuda',
                 model: dict | None = None, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ, vocab: int = 50257):
        self.torch, self.seed, self.device = torch, seed, device
        self.model = dict(RESILIENT_MODEL if model is None else model)
        self.batch, self.seq, self.vocab = batch, seq, vocab

    def module(self, scan_layers: bool = True):
        from tpusystem_torch.models import gpt2_small
        torch = self.torch
        unrolled = gpt2_small(**self.model, device=self.device)
        unrolled.init_weights(torch.Generator(self.device).manual_seed(
            self.seed))
        if not scan_layers:
            return unrolled
        scanned = gpt2_small(**self.model, scan_layers=True,
                             device=self.device)
        scanned.load_state_dict(restack(torch, unrolled.state_dict(),
                                        unrolled.layers))
        return scanned

    def criterion(self):
        from tpusystem_torch.train import ChunkedNextTokenLoss
        return ChunkedNextTokenLoss(chunks=8)

    def optimizer(self):
        from tpusystem_torch.train import AdamW
        return AdamW(lr=3e-4, grad_clip=1.0)

    def batches(self, count: int = RESILIENT_BATCHES) -> list:
        import numpy as np
        return [self.torch.as_tensor(np.random.default_rng(
            [self.seed, index]).integers(0, self.vocab, (self.batch,
                                                         self.seq)),
            device=self.device) for index in range(count)]

    def cell(self, module, guard=None, fault=None):
        """``(state, step)`` over ``module``'s own weights."""
        from tpusystem_torch.train import init_state
        optimizer = self.optimizer()
        state = init_state(module, optimizer, rng=self.seed)
        if guard is not None:
            state = guard.arm(state)
        step = build_train_step(module_apply(module), self.criterion(),
                                optimizer, guard=guard, fault=fault)
        return state, step

    def sync(self) -> None:
        if self.device == 'cuda':
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.device == 'cuda':
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int | None:
        if self.device != 'cuda':
            return None
        self.torch.cuda.synchronize()
        return self.torch.cuda.max_memory_allocated()


def restack(torch, flat: dict, layers: int) -> dict:
    """An unrolled GPT-2 state dict under a scanned model's names: every
    ``h_{i}.x`` stacked into ``hs.x`` (copies; the rest cloned)."""
    out = {name: tensor.clone() for name, tensor in flat.items()
           if not name.startswith('h_')}
    names = sorted({name.split('.', 1)[1] for name in flat
                    if name.startswith('h_')})
    for name in names:
        out['hs.' + name] = torch.stack([flat[f'h_{index}.{name}']
                                         for index in range(layers)])
    return out


def state_tensors(state) -> list:
    """The parameters and every optimizer slot, the count included."""
    opt = state.opt_state
    return ([state.step, opt['count']] + list(state.params.values())
            + list(opt['mu'].values()) + list(opt['nu'].values()))


def state_digest(state) -> str:
    """BLAKE2b-128 of the parameters' and slots' bytes, in order."""
    import hashlib

    import torch
    digest = hashlib.blake2b(digest_size=16)
    for tensor in state_tensors(state):
        digest.update(tensor.detach().contiguous().reshape(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def run_steps(recipe, step, state, batches, first: int, last: int) -> list:
    """Steps ``first`` to ``last`` (1-based), step ``k`` on batch
    ``(k - 1) % len(batches)``; the losses, read after the last step."""
    losses = []
    for at in range(first, last + 1):
        tokens = batches[(at - 1) % len(batches)]
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(loss)
    return [float(loss) for loss in losses]


def timed(recipe, call) -> float:
    recipe.sync()
    started = time.perf_counter()
    call()
    recipe.sync()
    return time.perf_counter() - started


def scan_against_unrolled(recipe) -> dict:
    """(a) Two steps of the scanned model and two of the unrolled one from
    the same weights: losses and parameters bit for bit; the peak memory of
    each (the other run's parameters kept on the host meanwhile)."""
    torch = recipe.torch
    batches = recipe.batches(2)
    result = {}
    for scan in (False, True):
        module = recipe.module(scan_layers=scan)
        state, step = recipe.cell(module)
        recipe.reset_peak()
        losses = run_steps(recipe, step, state, batches, 1, 2)
        peak = recipe.peak()
        params = {name: tensor.detach().to('cpu', copy=True)
                  for name, tensor in module.state_dict().items()}
        result['scanned' if scan else 'unrolled'] = dict(
            losses=losses, peak_memory_bytes=peak,
            params=(params if scan
                    else restack(torch, params, module.layers)))
        del module, state, step, params
    unrolled, scanned = result['unrolled'], result['scanned']
    losses_equal = unrolled['losses'] == scanned['losses']
    params_equal = all(torch.equal(tensor, scanned['params'][name])
                       for name, tensor in unrolled['params'].items())
    if not (losses_equal and params_equal):
        fail(f"scan_layers differs from the unrolled model: losses "
             f"{unrolled['losses']} vs {scanned['losses']}, params equal "
             f'{params_equal}')
    return dict(losses=scanned['losses'], losses_equal=losses_equal,
                params_equal=params_equal,
                peak_memory_bytes={name: result[name]['peak_memory_bytes']
                                   for name in ('unrolled', 'scanned')})


def multi_against_single(recipe) -> dict:
    """(b) ``build_multi_step`` at N = 4 over 8 batches against 8 single
    steps from the same weights: losses and final parameters bit for bit,
    and the ms a step of each."""
    from tpusystem_torch.train import build_multi_step
    torch = recipe.torch
    batches = recipe.batches()
    module = recipe.module()
    initial = {name: tensor.detach().clone()
               for name, tensor in module.state_dict().items()}
    state, step = recipe.cell(module)
    single = []
    seconds = timed(recipe, lambda: single.extend(
        run_steps(recipe, step, state, batches, 1, len(batches))))
    single_ms = 1e3 * seconds / len(batches)
    final = [tensor.detach().clone() for tensor in state_tensors(state)]
    module.load_state_dict(initial)
    state, step = recipe.cell(module)
    multi = build_multi_step(step)
    stacked = torch.stack(batches)
    groups = []

    def run():
        nonlocal state
        for start in range(0, len(batches), RESILIENT_GROUP):
            group = stacked[start:start + RESILIENT_GROUP]
            state, losses = multi(state, group, group)
            groups.append(losses)
    seconds = timed(recipe, run)
    multi_losses = [float(loss) for losses in groups for loss in losses]
    equal = multi_losses == single and all(
        torch.equal(a, b) for a, b in zip(final, state_tensors(state)))
    if not equal:
        fail(f'build_multi_step differs from single steps: {multi_losses} '
             f'vs {single}')
    return dict(n=RESILIENT_GROUP, steps=len(batches), losses=multi_losses,
                bitwise_equal=equal, single_ms_per_step=single_ms,
                multi_ms_per_step=1e3 * seconds / len(batches))


def both(*faults):
    """The faults applied in turn at the ``fault=`` seam."""
    def apply(current, grads, loss):
        for fault in faults:
            grads, loss = fault(current, grads, loss)
        return grads, loss
    return apply


def host_syncs(torch, call) -> dict:
    """Synchronizing CUDA operations ``call`` issues, as
    ``torch.cuda.set_sync_debug_mode('warn')`` reports them: their count
    and the Python lines that issued them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    sites = [f'{pathlib.Path(warning.filename).name}:{warning.lineno}'
             for warning in caught if 'synchroniz' in str(warning.message)]
    return dict(count=len(sites), sites=sorted(set(sites)))


def guard_drill(recipe) -> dict:
    """(c) Guard(warmup=4, zmax=6); CorruptGrads NaN at step 6 and a 200x
    spike at step 9. Step 6's row has ok = 0 and leaves the parameters and
    every AdamW slot bit for bit; ``bad_steps`` counts the suppressed
    steps; the step counter advances while Adam's does not. The spike's
    z-score and verdict are printed, not checked. ``Sentinel.review`` over
    each group's ``[4, 4]`` rows emits ``AnomalyDetected``. The guarded
    step's ms and host syncs beside the unguarded one's."""
    from tpusystem_torch.observe.events import AnomalyDetected
    from tpusystem_torch.parallel.chaos import CorruptGrads
    from tpusystem_torch.services.prodcon import Consumer, Producer
    from tpusystem_torch.train import Guard, Sentinel
    from tpusystem_torch.train.sentinel import HEALTH_OK, HEALTH_Z
    torch = recipe.torch
    batches = recipe.batches()
    module = recipe.module()
    initial = {name: tensor.detach().clone()
               for name, tensor in module.state_dict().items()}
    fault = both(CorruptGrads(step=6), CorruptGrads(step=9, mode='spike',
                                                    scale=200.0))
    state, step = recipe.cell(module, guard=Guard(warmup=4, zmax=6.0),
                              fault=fault)
    producer, seen = Producer(), []
    consumer = Consumer()
    consumer.register(AnomalyDetected, seen.append)
    producer.register(consumer)
    sentinel = Sentinel(producer=producer, model=RESILIENT_IDENTITY)
    rows, frozen = [], None
    for at in range(1, RESILIENT_STEPS + 1):
        tokens = batches[(at - 1) % len(batches)]
        before = ([tensor.detach().clone()
                   for tensor in state_tensors(state)[1:]]
                  if at == 6 else None)
        state, _ = step(state, tokens, tokens)
        rows.append(state.health.last.clone())
        if before is not None:
            frozen = all(torch.equal(a, b) for a, b in zip(
                before, state_tensors(state)[1:]))
        if at % RESILIENT_GROUP == 0:
            sentinel.review(state, torch.stack(rows[-RESILIENT_GROUP:]))
    rows = torch.stack(rows).cpu()
    adam_count, bad_steps = (int(state.opt_state['count']),
                             int(state.health.bad_steps))
    flagged = [index + 1 for index in range(len(rows))
               if rows[index, HEALTH_OK] < 0.5]
    checks = {'nan_row_ok_is_0': bool(rows[5, HEALTH_OK] == 0.0),
              'nan_step_frozen_bitwise': frozen,
              'bad_steps_counts_suppressed': bad_steps == len(flagged),
              'step_advances': int(state.step) == RESILIENT_STEPS,
              'adam_count_skips': adam_count == RESILIENT_STEPS - len(flagged),
              'anomaly_events': [event.step for event in seen] == flagged
              and 6 in flagged}
    if not all(checks.values()):
        fail(f'guard drill: {checks}, rows {rows.tolist()}')

    # the guard's cost: a guarded step against an unguarded one, in turns
    module.load_state_dict(initial)
    plain_state, plain_step = recipe.cell(module)
    guarded_state, guarded_step = recipe.cell(module, guard=Guard())
    tokens = batches[0]
    times = {'plain': [], 'guarded': []}
    for _ in range(3):
        for name, (run, held) in (('plain', (plain_step, plain_state)),
                                  ('guarded', (guarded_step, guarded_state))):
            times[name].append(1e3 * timed(
                recipe, lambda: run(held, tokens, tokens)))
    syncs = {name: (host_syncs(torch, lambda: run(held, tokens, tokens))
                    if recipe.device == 'cuda' else None)
             for name, (run, held) in (
                 ('plain', (plain_step, plain_state)),
                 ('guarded', (guarded_step, guarded_state)))}
    if recipe.device == 'cuda' and (syncs['guarded']['count']
                                    > syncs['plain']['count']):
        fail(f'the guarded step adds host syncs: {syncs}')
    return dict(checks=checks, rows=rows.tolist(), flagged=flagged,
                spike=dict(step=9, zscore=float(rows[8, HEALTH_Z]),
                           flagged=9 in flagged),
                bad_steps=bad_steps, adam_count=adam_count,
                anomaly_steps=[event.step for event in seen],
                step_ms=times, syncs=syncs)


def checkpoint_rollback(recipe, root: pathlib.Path) -> dict:
    """(d) An async ``Checkpointer`` saves every 4 steps of a guarded run;
    a forced ``Sentinel`` rollback (a bad row at step 5) restores step 4 in
    place and steps 5-8 repeat the first run's losses bit for bit. The host
    ms ``save`` blocks for, each commit's ms and the bytes a step."""
    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.train import Guard, Sentinel, resume_extras
    torch = recipe.torch
    batches = recipe.batches()
    module = recipe.module()
    state, step = recipe.cell(module, guard=Guard())
    blocked, losses = [], []
    with Checkpointer(root, async_save=True, max_to_keep=None) as ckpt:
        for at in range(1, RESILIENT_STEPS + 1):
            losses += run_steps(recipe, step, state, batches, at, at)
            if at % RESILIENT_SAVE_EVERY == 0:
                started = time.perf_counter()
                ckpt.save(RESILIENT_IDENTITY, at, state,
                          extras=resume_extras(state))
                blocked.append(1e3 * (time.perf_counter() - started))
        ckpt.wait()
        store = ckpt._manager(RESILIENT_IDENTITY)
        commits = [dict(timing) for timing in store.timings]
        rows = torch.stack([torch.tensor([1.0, 0.0, 0.0, 0.0])] * 4)
        rows[0] = torch.tensor([0.0, math.nan, math.nan, 0.0])  # step 5
        sentinel = Sentinel(checkpointer=ckpt, identity=RESILIENT_IDENTITY,
                            rollback_after=1)
        # the rows of steps 5-8, read at step 8
        state.step.fill_(8)
        restored = sentinel.review(state, rows)
        rolled_to = int(restored.step)
        again = run_steps(recipe, step, restored, batches, 5, 8)
        kept = ckpt.epochs(RESILIENT_IDENTITY)
    repeats = again == losses[4:8]
    if not (rolled_to == 4 and repeats and restored is state):
        fail(f'rollback: to step {rolled_to}, losses {again} vs '
             f'{losses[4:8]}')
    return dict(save_blocked_ms=blocked, commits=commits,
                bytes_per_step=commits[0]['bytes'], rolled_to=rolled_to,
                repeats_bitwise=repeats, kept_after_rollback=kept,
                losses=losses)


def resilient_worker(out_path: str, root: str, die_at: str, total: str,
                     seed: str, device: str, cell: str) -> None:
    """(e)'s worker, run by the ``Supervisor`` through ``sys.executable
    -c``: the scanned, guarded GPT-2 of phase 24 resumed through
    ``hot_resume``, then trained to step ``total``: the ``first-step`` mark
    right after its first step, a hot push after every step, an async disk
    save every 4, SIGKILLed after step ``die_at``'s push. A resumed worker
    then times a disk restore of the newest committed step by a fresh
    ``Checkpointer`` (its verify included) into a second state. Writes JSON
    lines to ``out_path``."""
    import os
    import signal

    import torch

    from tpusystem_torch.checkpoint import (Checkpointer, hot_resume,
                                            serialize_state,
                                            supervisor_client)
    from tpusystem_torch.observe import FlightRecorder
    from tpusystem_torch.parallel.chaos import DieAtStep
    from tpusystem_torch.train import Guard, resume_extras
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def out(record):
        with open(out_path, 'a') as handle:
            handle.write(json.dumps(record) + '\n')

    recipe = Recipe(torch, int(seed), device, **json.loads(cell))
    batches = recipe.batches()
    state, step = recipe.cell(recipe.module(), guard=Guard())
    client = supervisor_client()
    # the black box at the supervisor's TPUSYSTEM_FLIGHT path: a write-ahead
    # ring of the steps, which survives the SIGKILL
    recorder = FlightRecorder.from_env(process='resilient-worker')
    if recorder is not None:
        recorder.install()
    ckpt = Checkpointer(root, async_save=True, max_to_keep=None)
    die = DieAtStep(step=int(die_at),
                    action=lambda: os.kill(os.getpid(), signal.SIGKILL))
    try:
        started = time.perf_counter()
        state, at, extras, source = hot_resume(ckpt, RESILIENT_IDENTITY,
                                               state, client)
        recipe.sync()
        restore_s = time.perf_counter() - started
    except FileNotFoundError:
        at, source = 0, None
    else:
        out({'resumed': at, 'source': source, 'restore_s': restore_s})
    first = True
    for current in range(at + 1, int(total) + 1):
        loss, = run_steps(recipe, step, state, batches, current, current)
        if first and client is not None:
            first = False
            client.mark('first-step', step=current)
        extras = resume_extras(state)
        blob = serialize_state(state)
        if client is not None:
            client.push(RESILIENT_IDENTITY, current, blob, extras=extras)
        if current % RESILIENT_SAVE_EVERY == 0:
            ckpt.save(RESILIENT_IDENTITY, current, state, extras=extras)
        out({'step': current, 'loss': loss, 'hot_bytes': len(blob)})
        if recorder is not None:
            recorder.note('step', step=current, loss=loss)
        die(current)
    ckpt.close()
    out({'done': True, 'digest': state_digest(state)})
    if source is not None:
        spare, _ = recipe.cell(recipe.module(), guard=Guard())
        with Checkpointer(root) as fresh:
            started = time.perf_counter()
            disk_at = fresh.latest(RESILIENT_IDENTITY)
            fresh.restore(RESILIENT_IDENTITY, spare, epoch=disk_at)
            recipe.sync()
        out({'disk_restore_s': time.perf_counter() - started,
             'disk_step': disk_at})


def kill_and_relaunch(recipe, root: pathlib.Path) -> dict:
    """(e) The uninterrupted run in this process, then the worker under the
    ``Supervisor`` with its ``MemStoreServer``: killed after step 5's hot
    push, relaunched, restored from the supervisor's RAM (source
    ``'hot'``), it finishes steps 6-8; its 8 losses and final state equal
    the uninterrupted run's bit for bit. The supervisor traces (``tracer=``)
    and gives the worker a flight recorder (``flight_path=``): the killed
    worker's ``WorkerExited.postmortem`` holds its write-ahead ring of steps
    1-5, and the tracer one recovery span with its stages as children
    (phase 25 (d))."""
    from tpusystem_torch.observe import Tracer
    from tpusystem_torch.observe.events import (RecoveryTimeline,
                                                WorkerExited)
    from tpusystem_torch.parallel import Supervisor
    from tpusystem_torch.services.prodcon import Consumer, Producer
    from tpusystem_torch.train import Guard
    torch = recipe.torch
    batches = recipe.batches()
    state, step = recipe.cell(recipe.module(), guard=Guard())
    reference = run_steps(recipe, step, state, batches, 1,
                          RESILIENT_KILL_STEPS)
    digest = state_digest(state)
    del state, step
    if recipe.device == 'cuda':
        torch.cuda.empty_cache()
    root.mkdir(parents=True, exist_ok=True)
    out_path = root / 'worker.jsonl'
    here = str(pathlib.Path(__file__).resolve().parent)
    code = (f'import sys; sys.path.insert(0, {here!r}); import chip_smoke; '
            f'chip_smoke.resilient_worker(*sys.argv[1:])')
    argv = [sys.executable, '-c', code, str(out_path), str(root / 'ckpt'),
            str(RESILIENT_DIE_AT), str(RESILIENT_KILL_STEPS),
            str(recipe.seed),
            recipe.device, json.dumps(dict(
                model=recipe.model, batch=recipe.batch, seq=recipe.seq,
                vocab=recipe.vocab))]
    producer, seen = Producer(), []
    consumer = Consumer()
    for kind in (WorkerExited, RecoveryTimeline):
        consumer.register(kind, seen.append)
    producer.register(consumer)
    tracer = Tracer('supervisor')
    supervisor = Supervisor(argv, producer=producer, env={'PYTHONPATH': here},
                            backoff_base=0.05, backoff_cap=0.2,
                            crash_loop_window=0.0, tracer=tracer,
                            flight_path=str(root / 'flight.json'))
    started = time.perf_counter()
    exit_code = supervisor.run()
    seconds = time.perf_counter() - started
    records = [json.loads(line) for line in out_path.read_text().splitlines()]
    losses = {r['step']: r['loss'] for r in records if 'step' in r}
    resumes = [r for r in records if 'resumed' in r]
    done = [r for r in records if r.get('done')]
    disk = [r for r in records if 'disk_restore_s' in r]
    timelines = [event for event in seen
                 if isinstance(event, RecoveryTimeline)]
    result = dict(
        exit_code=exit_code,
        exit_codes=[event.code for event in seen
                    if isinstance(event, WorkerExited)],
        restarts=supervisor.restarts, resume=resumes, disk_restore=disk,
        losses=[losses.get(at) for at in range(1, RESILIENT_KILL_STEPS + 1)],
        reference_losses=reference,
        hot_bytes=max(r['hot_bytes'] for r in records if 'hot_bytes' in r),
        detect_to_first_step_s=(timelines[0].seconds if timelines else None),
        stages=(timelines[0].stages if timelines else None),
        digest_equal=bool(done) and done[0]['digest'] == digest,
        supervised_s=seconds)
    result['losses_equal'] = result['losses'] == reference
    if not (exit_code == 0 and resumes and resumes[0]['source'] == 'hot'
            and resumes[0]['resumed'] == RESILIENT_DIE_AT
            and result['losses_equal'] and result['digest_equal']):
        fail(f'kill and hot relaunch: {result}')
    result.update(postmortem_and_spans(seen, tracer))
    return result


def postmortem_and_spans(seen: list, tracer) -> dict:
    """Phase 25 (d): the killed worker's post-mortem holds the steps it
    noted before the kill (its write-ahead ring, each step's loss), and the
    supervisor's tracer one connected recovery trace: a ``recovery rank0``
    root over its stage spans."""
    from tpusystem_torch.observe.events import WorkerExited
    from tpusystem_torch.observe.trace import connected_traces
    exits = [event for event in seen if isinstance(event, WorkerExited)]
    killed = exits[0].postmortem if exits else None
    steps = ([entry['step'] for entry in killed['entries']
              if entry['kind'] == 'step'] if killed else [])
    traces = connected_traces(tracer.events())
    names = [sorted(event['name'] for event in group)
             for group in traces.values()]
    roots = [[event for event in group if 'parent' not in event['args']]
             for group in traces.values()]
    record = dict(postmortem_steps=steps,
                  postmortem_process=killed and killed['process'],
                  recovery_spans=names)
    if steps != list(range(1, RESILIENT_DIE_AT + 1)):
        fail(f'the killed worker\'s post-mortem holds steps {steps}')
    if not (len(traces) == 1 and len(roots[0]) == 1
            and roots[0][0]['name'] == 'recovery rank0'
            and len(names[0]) >= 3):
        fail(f'the supervisor traced {names}, not one recovery span over '
             f'its stages')
    return record


def train_resilient(torch, seed: int, device: str = 'cuda',
                    model: dict | None = None, **shape) -> dict:
    """Phase 24: GPT-2 125M at phase 7's recipe through the resilient
    trainer (``scan_layers``, ``build_multi_step``, the guard and the
    ``Sentinel``, the ``Checkpointer``, a SIGKILL and a hot relaunch under
    the ``Supervisor``); K1 and K2b launch in every in-process step."""
    import tempfile

    from tpusystem_torch.ops.cuda import flash
    recipe = Recipe(torch, seed, device, model, **shape)
    started = time.perf_counter()
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused)
    for counter in counters:
        counter.launches = 0
    with tempfile.TemporaryDirectory() as scratch:
        scratch = pathlib.Path(scratch)
        result = dict(scan=scan_against_unrolled(recipe),
                      multi=multi_against_single(recipe),
                      guard=guard_drill(recipe),
                      checkpoint=checkpoint_rollback(recipe,
                                                     scratch / 'rollback'))
        launches = {counter.__name__: counter.launches
                    for counter in counters}
        result['kill'] = kill_and_relaunch(recipe, scratch / 'kill')
    for counter in counters:
        counter.launches = 0                 # the reference run of (e)
    result.update(launches=launches, seconds=time.perf_counter() - started)
    if device == 'cuda' and not all(launches.values()):
        fail(f'phase 24 launched no flash kernel: {launches}')
    return result



# ---------------------------------------------------------------------------
# phase 25: observability and the LM example system

LM_EPOCHS = (2, 3)          # the first run's epochs, then the resumed run's
# examples/lm_torch/main.py's presets: (batch, sequence) of --full and tiny
LM_SHAPE = {True: (16, 1024), False: (16, 128)}
LM_BATCHES = (64, 8)        # its train and evaluation batches an epoch
PROFILED_STEPS = 2
FLASH_KERNELS = ('flash_fwd_kernel', 'flash_bwd_fused_kernel')


def lm_example():
    """``examples/lm_torch/main.py`` as a module (a script, not a
    package)."""
    import importlib.util
    path = (pathlib.Path(__file__).resolve().parent / 'examples'
            / 'lm_torch' / 'main.py')
    spec = importlib.util.spec_from_file_location('lm_torch_main', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pretrain_lm(torch, lm, root: pathlib.Path, full: bool = True,
                device=None) -> dict:
    """Phase 25 (a): the LM example's ``main(epochs=2)`` then ``main(epochs=3)``
    into ``root``: the second run resumes at epoch 2 and ends at 3, the
    store holds one model with loss and perplexity rows in both phases,
    ``weights/`` one identity, every loss is finite, the last evaluation
    loss is below the first, and K1 (K2b) launch at least once a layer for
    every step (every train step). Tokens/s from the ``StepTimed`` events of
    the train phases."""
    import contextlib
    import io

    from tpusystem_torch.observe.events import StepTimed
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.services.prodcon import Consumer
    from tpusystem_torch.storage import (DocumentMetrics, DocumentModels,
                                         DocumentStore)

    timed = []

    class Observed(lm.Runtime):
        """The example's ``Runtime`` with one more consumer, for the
        ``StepTimed`` events."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            consumer = Consumer('phase-25')
            consumer.register(StepTimed, timed.append)
            self.producer.register(consumer)

    lm.Runtime, lm.ROOT = Observed, root
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused)
    outputs, seconds = [], []
    for counter in counters:
        counter.launches = 0
    for epochs in LM_EPOCHS:
        text = io.StringIO()
        started = time.perf_counter()
        with contextlib.redirect_stdout(text):
            lm.main(epochs=epochs, full=full, device=device)
        seconds.append(time.perf_counter() - started)
        print(text.getvalue(), end='')
        outputs.append(text.getvalue())
    launches = {counter.__name__: counter.launches for counter in counters}
    store = DocumentStore(root / 'experiments.json')
    try:
        models = DocumentModels(store).list(lm.experiment())
        rows = DocumentMetrics(store).list(models[0].hash) if models else []
    finally:
        store.close()
    identities = [path.name for path in (root / 'weights').iterdir()
                  if path.is_dir()]
    curves = {}
    for row in sorted(rows, key=lambda row: row.epoch):
        curves.setdefault(f'{row.name}/{row.phase}', []).append(row.value)
    batch, sequence = LM_SHAPE[full]
    train = [event for event in timed if event.phase == 'train']
    epochs = LM_EPOCHS[-1]
    layers = 12 if full else 2
    steps = dict(train=LM_BATCHES[0] * epochs, evaluation=LM_BATCHES[1] * epochs)
    record = dict(
        printed=[line for text in outputs for line in text.splitlines()
                 if 'from epoch' in line],
        run_s=seconds, models=[(m.hash, m.epoch) for m in models],
        identities=identities, curves=curves, launches=launches,
        steps=steps, layers=layers,
        train_tokens_per_s=[event.steps * batch * sequence / event.seconds
                            for event in train],
        evaluation_steps_per_s=[event.steps_per_second for event in timed
                                if event.phase == 'evaluation'],
        card=card_line())
    losses = [value for values in curves.values() for value in values]
    evaluation = curves.get('loss/evaluation', [])
    checks = {
        'resumed where the first run ended': 'from epoch 0' in outputs[0]
        and f'from epoch {LM_EPOCHS[0]}' in outputs[1],
        'one model at the last epoch': [m.epoch for m in models] == [epochs],
        'rows in both phases': set(curves) == {
            f'{name}/{phase}' for name in ('loss', 'perplexity')
            for phase in ('train', 'evaluation')}
        and all(len(values) == epochs for values in curves.values()),
        'one identity': len(identities) == 1,
        'finite losses': bool(losses) and all(map(math.isfinite, losses)),
        'evaluation loss fell': len(evaluation) == epochs
        and evaluation[-1] < evaluation[0],
        'K1 a layer a step': launches['flash_attention_lse']
        >= layers * (steps['train'] + steps['evaluation']),
        'K2b a layer a train step': launches['flash_bwd_fused']
        >= layers * steps['train'],
    }
    record['checks'] = checks
    failed = [name for name, held in checks.items() if not held]
    if failed:
        fail(f'phase 25 (a): {failed}: {record}')
    return record


def step_kernels(events: list) -> dict:
    """The kernels of a ``torch.profiler`` Chrome trace that ran inside its
    ``ProfilerStep#`` ranges: a kernel whose start lies in a device-side
    step range (``gpu_user_annotation``), or whose launch (the runtime or
    driver call of the same ``correlation``) lies in a host-side one. Counts
    of the flash kernels among them and their device ms."""
    ranges = [event for event in events if event.get('ph') == 'X'
              and str(event.get('name', '')).startswith('ProfilerStep#')]

    def spans(category):
        return [(event['ts'], event['ts'] + event.get('dur', 0))
                for event in ranges if event.get('cat') == category]

    host, device = spans('user_annotation'), spans('gpu_user_annotation')
    launched = {event['args']['correlation']: event['ts']
                for event in events
                if event.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'correlation' in event.get('args', {})}
    kernels = [event for event in events if event.get('cat') == 'kernel']

    def inside(kernel) -> bool:
        if any(low <= kernel['ts'] <= high for low, high in device):
            return True
        at = launched.get(kernel.get('args', {}).get('correlation'))
        return at is not None and any(low <= at <= high
                                      for low, high in host)

    stepped = [kernel for kernel in kernels if inside(kernel)]
    return dict(
        kernels=len(kernels), kernels_in_steps=len(stepped),
        step_ranges=len(host), device_step_ranges=len(device),
        flash_in_steps={name: sum(name in kernel['name']
                                  for kernel in stepped)
                        for name in FLASH_KERNELS},
        flash_ms_in_steps={name: sum(kernel.get('dur', 0)
                                     for kernel in stepped
                                     if name in kernel['name']) / 1e3
                           for name in FLASH_KERNELS},
        kernel_ms_in_steps=sum(kernel.get('dur', 0)
                               for kernel in stepped) / 1e3)


def profile_lm(torch, lm, logdir: pathlib.Path, full: bool = True,
               device=None) -> dict:
    """Phase 25 (b): the LM example's aggregate at the same recipe, one
    warm-up step, then ``observe.trace(logdir)`` around one more step and
    two train steps each under ``observe.step_span``: the exported trace
    names the port's flash kernels (K1's ``flash_fwd_kernel``, K2b's
    ``flash_bwd_fused_kernel``) inside the step ranges. Fails if the
    profiler saw no CUDA kernel or either kernel is missing from the
    ranges; ``complete`` says whether every launch (a layer's worth of
    each a step) was recorded."""
    from tpusystem_torch.data import SyntheticTokens
    from tpusystem_torch.models import GPT2, gpt2_tiny
    from tpusystem_torch.observe import step_span, trace
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.train import AdamW, ChunkedNextTokenLoss

    devices = None if device is None else [torch.device(device)]
    placed = MeshSpec(fsdp=-1).build(devices)
    if full:
        network = GPT2(vocab_size=50304, dropout=0.0, return_features=True,
                       attention='flash', device=placed.device)
    else:
        network = gpt2_tiny(return_features=True, device=placed.device)
    model = lm.LanguageModel(network, ChunkedNextTokenLoss(chunks=8),
                             AdamW(lr=3e-4, grad_clip=1.0))
    model.place(lm.sample_tokens(), placed, lm.policy())
    batch, sequence = LM_SHAPE[full]
    tokens = model.shard_batch(SyntheticTokens(
        samples=batch, sequence_length=sequence).arrays[0])
    model.fit(tokens)                                  # warm-up, untraced
    torch.cuda.synchronize()
    with trace(str(logdir)):
        # a step outside the ranges first: the profiler can miss the
        # kernels of its first milliseconds (one run lost a step's first
        # 46, K1 among them)
        model.fit(tokens)
        torch.cuda.synchronize()
        started = time.perf_counter()
        for step in range(1, PROFILED_STEPS + 1):
            with step_span('train', step):
                loss = model.fit(tokens)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - started
    files = sorted(logdir.glob('*.pt.trace.json'))
    if not files:
        fail(f'observe.trace wrote no trace into {logdir}')
        return {}
    events = json.loads(files[-1].read_text())['traceEvents']
    record = dict(step_kernels(events), steps=PROFILED_STEPS,
                  loss=float(loss), traced_s=traced_s,
                  trace_bytes=files[-1].stat().st_size)
    counts = record['flash_in_steps'].values()
    record['complete'] = all(count == network.layers * PROFILED_STEPS
                             for count in counts)
    if not record['kernels']:
        fail('phase 25 (b): the profiler saw no CUDA kernel')
    elif not all(counts):
        fail(f'phase 25 (b): a flash kernel is missing from the step '
             f'ranges: {record}')
    return record


def traced_serving(torch, module, prompts, device=None) -> dict:
    """Phase 25 (c): the requests through ``InferenceService`` (a bf16
    ``Engine(rows=8)`` under a ``Scheduler``) untraced, then traced
    (``tracer=Tracer()``, a ``FlightRecorder`` watching it, a
    ``serve_metrics_consumer`` on the producer): the traced streams equal
    the untraced ones, the export parses and gives one connected trace per
    request with one ``request`` root, K1 runs once a layer for every
    prefill of 512 tokens or more and K4/K5 in decode. TTFT p50/p99 from
    ``ServeLatency``; decode tokens/s of both runs (a measure: single
    serving runs swing)."""
    import tempfile

    from tpusystem_torch.observe import (FlightRecorder, ServeLatency,
                                         SummaryWriter, Tracer,
                                         serve_metrics_consumer)
    from tpusystem_torch.observe import tensorboard as tb
    from tpusystem_torch.observe.trace import connected_traces
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.serve import InferenceService
    from tpusystem_torch.services.prodcon import Producer

    def run(name, tracer, producer):
        levers = {} if device is None else {'device': device}
        service = InferenceService(module, None, producer=producer,
                                   rows=ROWS, block_size=BLOCK,
                                   tracer=tracer, **levers)
        if service.engine.decode_impl != 'fused':
            fail(f'phase 25 (c) chose decode_impl='
                 f'{service.engine.decode_impl!r}, not \'fused\'')
        submitted, seated = {}, {}
        clock = engine_clock(torch, service.engine, seated, 'admit')
        dm.reset_launches()
        flash.flash_attention_lse.launches = 0
        torch.cuda.synchronize()
        started = time.perf_counter()
        for request in disagg_requests(prompts):
            submitted[request.id] = time.perf_counter()
            service.submit(request)
        results = service.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
        launches = {'flash_attention_lse': flash.flash_attention_lse.launches,
                    'decode_matmul': dm.decode_matmul.launches,
                    'decode_ffn': dm.decode_ffn.launches}
        check_completed(name, results, len(prompts))
        want_k1 = module.layers * sum(service.engine.bucket(len(prompt))
                                      >= 512 for prompt in prompts)
        if launches['flash_attention_lse'] != want_k1 \
                or not launches['decode_matmul'] \
                or not launches['decode_ffn']:
            fail(f'phase 25 (c) {name}: K1/K4/K5 launches {launches}, '
                 f'K1 expected {want_k1}')
        return results, dict(decode_rates(clock, submitted, seated, wall),
                             launches=launches)

    with tempfile.TemporaryDirectory() as scratch:
        scratch = pathlib.Path(scratch)
        plain, untraced = run('untraced', None, Producer())
        tracer = Tracer('serve')
        recorder = FlightRecorder(scratch / 'flight.json',
                                  process='serve').watch(tracer)
        latency, producer = ServeLatency(), Producer()
        metrics = serve_metrics_consumer(latency, cadence=4)
        writer = SummaryWriter(scratch / 'tensorboard')
        metrics.dependency_overrides[tb.writer] = lambda: writer
        producer.register(metrics)
        got, traced = run('traced', tracer, producer)
        writer.close()
        exported = tracer.export(scratch / 'serve-trace.json')
        payload = json.loads(exported.read_text())
        flight = FlightRecorder.read(scratch / 'flight.json')
    events = payload['traceEvents']
    try:
        traces = connected_traces(events)
    except ValueError as error:
        fail(f'phase 25 (c): {error}')
        traces = {}
    roots = sorted(sum(event['name'].startswith('request ')
                       for event in group) for group in traces.values())
    equal = sum(got[rid].tokens == plain[rid].tokens for rid in plain)
    record = dict(
        untraced=untraced, traced=traced,
        traces=len(traces), request_roots=roots,
        spans=sum(event['ph'] in ('X', 'i') for event in events),
        flight_entries=len(flight['entries']) if flight else 0,
        streams_equal_share=equal / len(plain),
        ttft_p50_s=latency.ttft.percentile(0.5) if latency.ttft.count
        else None,
        ttft_p99_s=latency.ttft.percentile(0.99) if latency.ttft.count
        else None,
        ttft_count=latency.ttft.count,
        tokens_per_s=dict(traced=traced['decode_tokens_per_s'],
                          untraced=untraced['decode_tokens_per_s']),
        card=card_line())
    if len(traces) != len(prompts) or roots != [1] * len(prompts):
        fail(f'phase 25 (c): {len(traces)} connected traces with request '
             f'roots {roots} for {len(prompts)} requests')
    if equal != len(plain):
        fail(f'phase 25 (c): {equal} of {len(plain)} traced streams equal '
             f'the untraced ones')
    if not record['flight_entries'] or latency.ttft.count != len(prompts):
        fail(f'phase 25 (c): {record["flight_entries"]} flight entries, '
             f'{latency.ttft.count} TTFT samples')
    return record


def observe_lm(torch, seed: int, drill: dict) -> dict:
    """Phase 25: the LM example system pretrained and resumed at GPT-2 125M
    (a), two of its steps profiled (b), phase 5's weights and requests
    served traced (c); ``drill`` is phase 24 (e)'s supervised kill, traced
    with a flight recorder (d). K1 and K2b's launches count (a), K1, K4
    and K5's (c)'s two runs."""
    import gc
    import tempfile

    from tpusystem_torch.models import gpt2_small

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    lm = lm_example()
    with tempfile.TemporaryDirectory() as scratch:
        scratch = pathlib.Path(scratch)
        pretrained = pretrain_lm(torch, lm, scratch / 'lm')
        gc.collect()
        torch.cuda.empty_cache()
        profiled = profile_lm(torch, lm, scratch / 'profile')
    gc.collect()
    torch.cuda.empty_cache()
    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    served = traced_serving(torch, module,
                            serving_prompts(seed, module.vocab_size))
    serving = [served[run]['launches'] for run in ('untraced', 'traced')]
    launches = dict(
        flash_attention_lse=pretrained['launches']['flash_attention_lse']
        + sum(run['flash_attention_lse'] for run in serving),
        flash_bwd_fused=pretrained['launches']['flash_bwd_fused'],
        decode_matmul=sum(run['decode_matmul'] for run in serving),
        decode_ffn=sum(run['decode_ffn'] for run in serving))
    return dict(pretrain=pretrained, profile=profiled, serving=served,
                drill={key: drill[key] for key in (
                    'postmortem_steps', 'postmortem_process',
                    'recovery_spans', 'stages')},
                launches=launches, card=card_line(),
                seconds=time.perf_counter() - started)


# phase 26: benchmarks/ladder_mfu.py:150-153's image rung, ResNet-50 at
# 224x224, bf16, NHWC, batch 64; a few warm-up steps, then timed ones
RESNET_BATCH, RESNET_SIZE, RESNET_WARMUP, RESNET_STEPS = 64, 224, 3, 10
RESNET_PROFILED = 2
# (a): resnet_tiny with the ImageNet-style stem and pool at 32x32, so the
# stem's, the pool's and the strided conv's asymmetric 'SAME' pads all run
RESNET_SMALL = dict(stem_stride=2, stem_pool=True)
RESNET_SMALL_SHAPE = (4, 32, 32, 3)
# float32 tolerances: the port against the plain forward below on one
# device, and the card against the CPU with cuDNN's TF32 off (both
# 1e-4 absolute); bf16 convolutions against the plain forward's: 2e-3
RESNET_TOL, RESNET_BF16_TOL = 1e-4, 2e-3


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """XLA's 'SAME' padding of one dim: output ceil(size / stride), the odd
    element after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def plain_resnet(torch, params: dict, groups: int, stem_stride: int,
                 stem_pool: bool, images, dtype):
    """The ResNet's forward written plainly from its parameters (contiguous
    NCHW, every pad an explicit ``F.pad``, GroupNorm as E[x^2] - E[x]^2 in
    float32, the residual stream float32): what phase 26 (a) holds the
    port's module to. Float32 logits."""
    F = torch.nn.functional

    def conv(hidden, kernel, stride):
        size = kernel.shape[0]
        top, bottom = same_pads(hidden.shape[2], size, stride)
        left, right = same_pads(hidden.shape[3], size, stride)
        hidden = F.pad(hidden.to(dtype), (left, right, top, bottom))
        return F.conv2d(hidden, kernel.to(dtype).permute(3, 2, 0, 1),
                        stride=stride)

    def norm(hidden, name):
        batch, channels, height, width = hidden.shape
        grouped = hidden.float().reshape(batch, groups, -1)
        mean = grouped.mean(-1, keepdim=True)
        variance = ((grouped * grouped).mean(-1, keepdim=True)
                    - mean * mean).clamp_min(0.0)
        normed = ((grouped - mean) * torch.rsqrt(variance + 1e-6)).reshape(
            batch, channels, height, width)
        return (normed * params[f'{name}.scale'].view(1, -1, 1, 1)
                + params[f'{name}.bias'].view(1, -1, 1, 1))

    hidden = images.permute(0, 3, 1, 2).contiguous()
    hidden = torch.relu(norm(conv(hidden, params['stem.kernel'],
                                  stem_stride), 'stem_norm'))
    if stem_pool:
        top, bottom = same_pads(hidden.shape[2], 3, 2)
        left, right = same_pads(hidden.shape[3], 3, 2)
        hidden = F.max_pool2d(F.pad(hidden, (left, right, top, bottom),
                                    value=float('-inf')), 3, 2)
    blocks = sorted({tuple(map(int, found.groups())) for found in (
        re.match(r's(\d+)_b(\d+)\.', name) for name in params) if found})
    for stage, index in blocks:
        block = f's{stage}_b{index}'
        stride = 2 if stage > 0 and index == 0 else 1
        shortcut = hidden
        if f'{block}.proj.kernel' in params:
            shortcut = norm(conv(hidden, params[f'{block}.proj.kernel'],
                                 stride), f'{block}.proj_norm')
        out = torch.relu(norm(conv(hidden, params[f'{block}.conv1.kernel'],
                                   1), f'{block}.norm1'))
        out = torch.relu(norm(conv(out, params[f'{block}.conv2.kernel'],
                                   stride), f'{block}.norm2'))
        out = norm(conv(out, params[f'{block}.conv3.kernel'], 1),
                   f'{block}.norm3')
        hidden = torch.relu(out + shortcut)
    pooled = hidden.float().mean(dim=(2, 3))
    return pooled @ params['head.kernel'] + params['head.bias']


def resnet_forward_flops(module, size: int) -> int:
    """One image's forward through ``module`` at ``size`` x ``size``:
    2 k^2 C_in C_out H_out W_out a convolution, from the shapes, plus the
    head's 2 in out (norms, pools and adds not counted)."""
    flops = 0

    def conv(layer, height, width):
        nonlocal flops
        size, _, fan_in, fan_out = layer.kernel.shape
        height, width = (-(-height // layer.stride),
                         -(-width // layer.stride))
        flops += 2 * size * size * fan_in * fan_out * height * width
        return height, width

    height, width = conv(module.stem, size, size)
    if module.stem_pool:
        height, width = -(-height // 2), -(-width // 2)
    for block in module.blocks():
        if block.project:
            conv(block.proj, height, width)
        conv(block.conv1, height, width)
        height, width = conv(block.conv2, height, width)
        conv(block.conv3, height, width)
    return flops + 2 * module.head.kernel.numel()


def kernel_counters():
    """Every hand-written kernel's wrapper (each keeps ``launches``)."""
    import importlib
    counters = []
    for name in ('decode_matmul', 'embedding_lookup', 'flash',
                 'grouped_matmul', 'threefry'):
        module = importlib.import_module(f'tpusystem_torch.ops.cuda.{name}')
        counters += [value for value in vars(module).values()
                     if callable(value) and hasattr(value, 'launches')]
    return counters


def residual_dtypes(torch, module, images) -> set:
    """The dtypes each block of ``module`` takes and returns on
    ``images``: the residual stream, float32 whatever the conv dtype."""
    seen = set()
    hooks = [block.register_forward_hook(
        lambda _, args, out: seen.update((str(args[0].dtype),
                                          str(out.dtype))))
        for block in module.blocks()]
    try:
        module(images)
    finally:
        for hook in hooks:
            hook.remove()
    return seen


@contextlib.contextmanager
def conv_tf32_off(torch):
    """cuDNN's TF32 off inside the block, the setting before restored
    after: float32 convolutions on the card compared with the CPU's."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def resnet_card_vs_cpu(torch, seed: int, device: str = 'cuda') -> dict:
    """Phase 26 (a): ``resnet_tiny`` with the ImageNet-style stem and pool
    at 32x32. Its weights are drawn on the CPU from ``seed`` and crossed
    into a second module on ``device``. (1) the port's logits, on the CPU,
    against :func:`plain_resnet` (float32 within 1e-4; with the conv dtype
    overridden to bf16, within 2e-3, every block taking and returning
    float32): a symmetric pad or a bf16 residual stream fails; (2) the module on ``device`` against the CPU's,
    float32 with cuDNN's TF32 off: logits, and one
    ``build_train_step(module_apply(...), CrossEntropyLoss(), AdamW(...))``
    step's loss and gradients (read through the step's ``fault=`` seam),
    within 1e-4."""
    import numpy as np

    from tpusystem_torch.models import resnet_tiny
    from tpusystem_torch.train import (AdamW, CrossEntropyLoss,
                                       build_train_step, init_state,
                                       module_apply)

    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=RESNET_SMALL_SHAPE).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(
        0, 10, RESNET_SMALL_SHAPE[0]).astype(np.int64))
    record = {}
    for dtype in ('float32', 'bfloat16'):
        cpu = resnet_tiny(dtype=dtype, device='cpu', **RESNET_SMALL)
        cpu.init_weights(torch.Generator().manual_seed(seed))
        params = {name: tensor.detach()
                  for name, tensor in cpu.state_dict().items()}
        with torch.no_grad():
            want = plain_resnet(torch, params, cpu.groups, cpu.stem_stride,
                                cpu.stem_pool, images,
                                getattr(torch, dtype))
            got = cpu(images)
            stream = residual_dtypes(torch, cpu, images)
        record[f'plain_{dtype}_max_abs_err'] = float(
            (got - want).abs().max())
        record[f'logit_scale_{dtype}'] = float(want.abs().max())
        record[f'residual_{dtype}'] = sorted(stream)
    if not (record['plain_float32_max_abs_err'] <= RESNET_TOL
            and record['plain_bfloat16_max_abs_err'] <= RESNET_BF16_TOL
            and record['residual_bfloat16'] == ['torch.float32']):
        fail(f'phase 26 (a): the ResNet against its plain forward: {record}')

    cpu = resnet_tiny(device='cpu', **RESNET_SMALL)
    cpu.init_weights(torch.Generator().manual_seed(seed))
    card = resnet_tiny(device=device, **RESNET_SMALL)
    card.load_state_dict(cpu.state_dict())
    runs = {}
    with conv_tf32_off(torch):
        for name, module in (('cpu', cpu), ('card', card)):
            where = module.head.kernel.device
            seen = {}

            def capture(step, grads, loss, seen=seen):
                seen['grads'] = {key: grad.detach().cpu()
                                 for key, grad in grads.items()}
                return grads, loss
            with torch.no_grad():
                logits = module(images.to(where)).cpu()
            optimizer = AdamW(lr=1e-3)
            state = init_state(module, optimizer, rng=seed)
            step = build_train_step(module_apply(module), CrossEntropyLoss(),
                                    optimizer, fault=capture)
            state, (_, loss) = step(state, images.to(where),
                                    labels.to(where))
            runs[name] = dict(logits=logits, loss=float(loss),
                              grads=seen['grads'])
    grad_err = max(float((runs['card']['grads'][key]
                          - runs['cpu']['grads'][key]).abs().max())
                   for key in runs['cpu']['grads'])
    record.update(
        device=str(device), shape=list(RESNET_SMALL_SHAPE),
        logits_max_abs_err=float((runs['card']['logits']
                                  - runs['cpu']['logits']).abs().max()),
        loss=runs['card']['loss'], cpu_loss=runs['cpu']['loss'],
        loss_abs_err=abs(runs['card']['loss'] - runs['cpu']['loss']),
        grads_max_abs_err=grad_err, tolerance=RESNET_TOL,
        bf16_tolerance=RESNET_BF16_TOL, conv_tf32=False)
    if not (record['logits_max_abs_err'] <= RESNET_TOL
            and record['loss_abs_err'] <= RESNET_TOL
            and grad_err <= RESNET_TOL and math.isfinite(record['loss'])):
        fail(f'phase 26 (a): the card against the CPU: {record}')
    return record


def train_resnet(torch, seed: int, device: str = 'cuda',
                 batch: int = RESNET_BATCH, size: int = RESNET_SIZE,
                 steps: int = RESNET_STEPS, warmup: int = RESNET_WARMUP,
                 **overrides) -> dict:
    """Phase 26 (b): ResNet-50 (``resnet50``, bf16 convolutions, random
    weights from ``seed``) trains on one fixed synthetic NHWC batch from
    ``seed`` with AdamW: ``warmup`` steps, then ``steps`` timed ones and a
    profiled window of two. Fails unless every loss is finite, the last
    is below the first and the parameter count is 25.0-26.5 M. ``mfu``
    counts the convolutions' and the head's products (2 k^2 C_in C_out
    H_out W_out each), training as three forwards, over 989 TFLOP/s."""
    import numpy as np

    from tpusystem_torch.models import resnet50
    from tpusystem_torch.train import (AdamW, CrossEntropyLoss,
                                       build_train_step, init_state,
                                       module_apply)

    module = resnet50(device=device, **overrides)
    module.init_weights(torch.Generator(device).manual_seed(seed))
    params = sum(parameter.numel() for parameter in module.parameters())
    if not overrides and not 25.0e6 <= params <= 26.5e6:
        fail(f'phase 26 (b): ResNet-50 has {params} parameters')
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(
        0, module.classes, batch).astype(np.int64)).to(device)
    optimizer = AdamW(lr=1e-3)
    state = init_state(module, optimizer, rng=seed)
    step = build_train_step(module_apply(module), CrossEntropyLoss(),
                            optimizer)
    synchronize = (torch.cuda.synchronize if device != 'cpu'
                   else (lambda: None))
    losses = []
    started = time.perf_counter()
    for _ in range(warmup):
        state, (_, loss) = step(state, images, labels)
        losses.append(loss.item())
    warmup_s = time.perf_counter() - started
    synchronize()
    if device != 'cpu':
        torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(steps):
        started = time.perf_counter()
        state, (_, loss) = step(state, images, labels)
        losses.append(loss.item())                    # waits for the step
        seconds.append(time.perf_counter() - started)
    if not all(math.isfinite(value) for value in losses):
        fail(f'phase 26 (b): non-finite ResNet loss: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'phase 26 (b): the ResNet loss did not fall: {losses}')
    median = sorted(seconds)[len(seconds) // 2]
    forward = resnet_forward_flops(module, size)
    flops = 3 * forward * batch
    record = dict(
        batch=batch, image=[size, size, 3], dtype=module.dtype,
        params=params, losses=losses, warmup_s=warmup_s,
        step_ms=[1e3 * s for s in seconds], median_step_ms=1e3 * median,
        min_step_ms=1e3 * min(seconds), max_step_ms=1e3 * max(seconds),
        images_per_s=batch / median, forward_flops_per_image=forward,
        flops_per_step=flops, mfu=flops / median / BF16_FLOPS,
        mfu_convention='2 k^2 C_in C_out H_out W_out a conv plus the '
        "head's 2 in out, training = 3 x forward, over 989 TFLOP/s dense "
        'bf16')
    if device != 'cpu':
        record['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
        record['profile'] = profile_steps(
            torch, lambda: step(state, images, labels),
            steps=RESNET_PROFILED, top_n=10,
            sums=('conv', 'xmma', 'GroupNorm', 'Moments', 'elementwise',
                  'adam', 'foreach'))
    return record


def resnet_phase(torch, seed: int) -> dict:
    """Phase 26: (a) ``resnet_tiny`` on the card against the CPU, (b)
    ResNet-50 trained at ``ladder_mfu.py``'s rung. Launches none of the
    hand-written kernels: every counter is set to 0 before and read
    after."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    counters = kernel_counters()
    for counter in counters:
        counter.launches = 0
    small = resnet_card_vs_cpu(torch, seed)
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True      # cuDNN picks its algorithms
    try:
        trained = train_resnet(torch, seed)
    finally:
        torch.backends.cudnn.benchmark = before
    launched = {counter.__name__: counter.launches for counter in counters
                if counter.launches}
    if launched:
        fail(f'phase 26 launched hand-written kernels: {launched}')
    return dict(small=small, train=trained, cudnn_benchmark=True,
                card=card_line(), seconds=time.perf_counter() - started)



# phase 27: collectives and data parallelism at world size one

DP_STEPS = 3                    # AdamW steps under each policy
DP_RANKS = 2                    # (c): processes sharing the one card
DP_RTOL = 2e-5                  # the CPU parity tests' (reference's) rtol


def free_port() -> int:
    import socket
    with socket.socket() as probe:
        probe.bind(('127.0.0.1', 0))
        return probe.getsockname()[1]


def host_checksum(tensor) -> int:
    """A leaf's bit checksum computed on the host with numpy: its bytes as
    unsigned words (a 64-bit element as two 32-bit words) summed mod
    2**32, the definition ``replica_checksums`` computes on the device."""
    import numpy as np
    import torch

    size = tensor.element_size()
    kind = {8: torch.int32, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    words = tensor.detach().cpu().contiguous().reshape(-1).view(
        kind[size]).numpy()
    unsigned = words.view({8: np.uint32, 4: np.uint32, 2: np.uint16,
                           1: np.uint8}[size])
    return int(unsigned.astype(np.uint64).sum() % (1 << 32))


def collectives_at_one(torch, device) -> dict:
    """Phase 27 (a): every collective of ``parallel/collectives.py`` on
    tensors on ``device`` over a mesh of one rank (NCCL on the card),
    against its definition at world size one, bit for bit: the sums and
    gathers are the tensor itself, the stacked gather adds a dimension, the
    gradients of the gather and the reduce-scatter pass through."""
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel import collectives as c

    generator = torch.Generator(device).manual_seed(0)
    x = torch.randn((8, 6), generator=generator, device=device)
    record = {}
    for spec in ('data', 'fsdp'):
        mesh = MeshSpec(**{spec: -1}).build()
        cases = {
            'all_reduce_sum': (c.all_reduce_sum(x, mesh, spec), x),
            'all_reduce_sum[data,fsdp]': (
                c.all_reduce_sum(x, mesh, ('data', 'fsdp')), x),
            'all_reduce_mean': (c.all_reduce_mean(x, mesh, spec), x),
            'all_gather': (c.all_gather(x, mesh, spec, dimension=1), x),
            'all_gather_stacked': (c.all_gather(x, mesh, spec, tiled=False),
                                   x[None]),
            'reduce_scatter': (c.reduce_scatter(x, mesh, spec), x),
            'all_to_all': (c.all_to_all(x, mesh, spec, split_dimension=1,
                                        concat_dimension=0), x),
            'ring_shift': (c.ring_shift(x, mesh, spec), x),
            'ring_shift_chunked': (c.ring_shift_chunked(
                x, mesh, spec, chunks=2, reverse=True), x),
            'ring_allgather': (c.ring_allgather(x, mesh, spec, chunks=2), x),
            'ring_reducescatter': (c.ring_reducescatter(x, mesh, spec), x),
        }
        for name, collective in (('all_gather_grad', c.all_gather),
                                 ('reduce_scatter_grad', c.reduce_scatter)):
            leaf = x.clone().requires_grad_()
            (collective(leaf, mesh, spec) * x).sum().backward()
            cases[name] = (leaf.grad, x)
        wrong = [name for name, (got, want) in cases.items()
                 if not (got.shape == want.shape and torch.equal(got, want))]
        if (wrong or c.axis_index(mesh, spec) != 0
                or c.axis_size(mesh, spec) != 1):
            fail(f'phase 27 (a): collectives over {spec} at world size one: '
                 f'{wrong}, index {c.axis_index(mesh, spec)}, size '
                 f'{c.axis_size(mesh, spec)}')
        record[spec] = dict(checked=sorted(cases),
                            backend=torch.distributed.get_backend(
                                mesh.group(spec)))
    return record


def checksum_check(torch, module) -> dict:
    """Phase 27 (a): ``replica_checksums`` of the model's parameters,
    placed by ``DataParallel``, equal the same sums computed on the host,
    leaf for leaf; one ``FlipParamBit`` changes exactly that leaf's
    entry."""
    from tpusystem_torch.parallel import (DataParallel, FlipParamBit,
                                          MeshSpec, replica_checksums)

    mesh = MeshSpec(data=-1).build()
    params = DataParallel().place(dict(module.named_parameters()), mesh)
    host = [host_checksum(leaf) for leaf in module.parameters()]
    started = time.perf_counter()
    matrix, paths = replica_checksums(params, mesh)
    seconds = time.perf_counter() - started
    if matrix.shape != (1, len(host)) or [int(v) for v in matrix[0]] != host:
        fail(f'phase 27 (a): device checksums differ from the host\'s at '
             f'{[p for p, a, b in zip(paths, matrix[0], host) if a != b][:4]}')
    leaf = 4                                    # a block's qkv kernel
    index = module.get_parameter(paths[leaf].replace('/', '.')).numel() // 3
    FlipParamBit(leaf=leaf, index=index, bit=7)(params, mesh)
    flipped, _ = replica_checksums(params, mesh)
    changed = [index for index in range(len(host))
               if flipped[0, index] != matrix[0, index]]
    if changed != [leaf]:
        fail(f'phase 27 (a): a flip of leaf {leaf} changed entries {changed}')
    return dict(leaves=len(host), checksum_s=seconds, flipped=paths[leaf],
                index=index, changed=changed)


def policy_steps(torch, seed: int, device: str, factory, shape: tuple,
                 steps: int = DP_STEPS) -> dict:
    """Phase 27 (b): ``steps`` AdamW steps of ``factory()``'s model from the
    same weights and tokens, unplaced, under ``DataParallel()`` and under
    ``FullyShardedDataParallel()`` over the one-rank mesh; losses and
    final parameters bit for bit those of the unplaced steps (every
    collective is the identity at world size one). Each run's K1/K2b
    launches (counts set to 0 just before it), step ms and peak memory."""
    import numpy as np

    from tpusystem_torch.ops.cuda import flash
    from tpusystem_torch.parallel import (DataParallel,
                                          FullyShardedDataParallel, MeshSpec,
                                          batch_sharding)
    from tpusystem_torch.parallel.sharding import local
    from tpusystem_torch.train import AdamW, ChunkedNextTokenLoss, init_state

    module = factory()
    module.init_weights(torch.Generator(device).manual_seed(seed))
    initial = {name: value.detach().clone()
               for name, value in module.state_dict().items()}
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, min(50257, module.vocab_size), shape), device=device)
    criterion = ChunkedNextTokenLoss(chunks=8)
    counters = (flash.flash_attention_lse, flash.flash_bwd_fused)
    cuda = device == 'cuda'
    runs, final = {}, None
    for name, policy, spec in (
            ('unplaced', None, None),
            ('dp', DataParallel(), MeshSpec(data=-1)),
            ('fsdp', FullyShardedDataParallel(), MeshSpec(fsdp=-1))):
        module.load_state_dict(initial)
        optimizer = AdamW(lr=3e-4, grad_clip=1.0)
        state = init_state(module, optimizer, rng=seed)
        rows = tokens
        if policy is not None:
            mesh = spec.build()
            state = policy.place(state, mesh)
            rows = batch_sharding(mesh)(tokens)
        step = build_train_step(module_apply(module), criterion, optimizer)
        for counter in counters:
            counter.launches = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, seconds = [], []
        for _ in range(steps):
            started = time.perf_counter()
            state, (_, loss) = step(state, rows, rows)
            losses.append(loss.item())              # waits for the step
            seconds.append(time.perf_counter() - started)
        params = {key: local(value).detach()
                  for key, value in state.params.items()}
        if final is None:
            final = {key: value.clone() for key, value in params.items()}
        runs[name] = dict(
            losses=losses, step_ms=[1e3 * s for s in seconds],
            median_step_ms=1e3 * sorted(seconds)[len(seconds) // 2],
            launches={counter.__name__: counter.launches
                      for counter in counters},
            peak_memory_bytes=(torch.cuda.max_memory_allocated() if cuda
                               else None),
            params_equal=all(torch.equal(params[key], final[key])
                             for key in final),
            losses_equal=losses == runs.get('unplaced', {'losses': losses})[
                'losses'])
        del state, step, params
    layers = module.layers
    for name, run in runs.items():
        if not (run['params_equal'] and run['losses_equal']):
            fail(f'phase 27 (b): {name} is not bit for bit the unplaced '
                 f'step: {run}')
        if not all(math.isfinite(value) for value in run['losses']):
            fail(f'phase 27 (b): non-finite {name} losses {run["losses"]}')
        if cuda and run['launches'] != {'flash_attention_lse': layers * steps,
                                        'flash_bwd_fused': layers * steps}:
            fail(f'phase 27 (b): {name} launched {run["launches"]}, not '
                 f'{layers} of K1 and K2b a step')
    return dict(runs=runs, shape=list(shape), steps=steps,
                params=sum(value.numel() for value in initial.values()),
                launches={counter.__name__: sum(
                    run['launches'][counter.__name__]
                    for run in runs.values()) for counter in counters})


def dp_model(torch, device: str):
    from tpusystem_torch.models import gpt2_small
    return gpt2_small(vocab_size=50304, dropout=0.0, attention='flash',
                      return_features=True, device=device)


def dp_worker(rank: int, port: int, out: str) -> None:
    """One of phase 27 (c)'s ranks (``--dp-worker RANK PORT OUT``): joins a
    world of ``DP_RANKS`` processes on the one card over gloo (CUDA
    tensors; NCCL refuses two ranks on one device), runs the DP steps of
    (b) on its rows and writes its losses, step ms and launches."""
    import torch

    from tpusystem_torch.ops.cuda._build import LIBRARIES
    from tpusystem_torch.parallel import multihost
    LIBRARIES.build()
    multihost.initialize(f'127.0.0.1:{port}', DP_RANKS, rank,
                         device='cuda', backend='gloo')
    try:
        import numpy as np

        from tpusystem_torch.ops.cuda import flash
        from tpusystem_torch.parallel import (DataParallel, MeshSpec,
                                              batch_sharding)
        from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                           init_state)
        torch.backends.cuda.matmul.allow_tf32 = False
        module = dp_model(torch, 'cuda')
        module.init_weights(torch.Generator('cuda').manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, 50257, (TRAIN_BATCH, TRAIN_SEQ)), device='cuda')
        optimizer = AdamW(lr=3e-4, grad_clip=1.0)
        mesh = MeshSpec(data=-1).build()
        state = DataParallel().place(init_state(module, optimizer, rng=0),
                                     mesh)
        rows = batch_sharding(mesh)(tokens)
        step = build_train_step(module_apply(module),
                                ChunkedNextTokenLoss(chunks=8), optimizer)
        counters = (flash.flash_attention_lse, flash.flash_bwd_fused)
        for counter in counters:
            counter.launches = 0
        losses, seconds = [], []
        for _ in range(DP_STEPS):
            started = time.perf_counter()
            state, (_, loss) = step(state, rows, rows)
            losses.append(loss.item())
            seconds.append(time.perf_counter() - started)
        pathlib.Path(out).write_text(json.dumps(dict(
            rank=rank, rows=list(rows.shape), losses=losses,
            step_ms=[1e3 * s for s in seconds],
            backend=torch.distributed.get_backend(),
            launches={counter.__name__: counter.launches
                      for counter in counters})))
    finally:
        multihost.shutdown()


def two_ranks_on_one_card(torch, unplaced: list, root: pathlib.Path) -> dict:
    """Phase 27 (c): ``DP_RANKS`` processes on the one card over gloo run
    (b)'s DP steps on their rows; their global losses equal each other and
    (b)'s unplaced losses within the CPU tests' rtol."""
    port = free_port()
    root.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         '--dp-worker', str(rank), str(port), str(root / f'rank{rank}.json')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(DP_RANKS)]
    try:
        outputs = [proc.communicate(timeout=300)[0].decode()
                   for proc in procs]
    finally:
        for proc in procs:          # no rank outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            fail(f'phase 27 (c): rank {rank} exited {proc.returncode}:\n'
                 f'{outputs[rank][-3000:]}')
    ranks = [json.loads((root / f'rank{rank}.json').read_text())
             for rank in range(DP_RANKS)]
    worst = max(abs(a - b) / abs(b) for record in ranks
                for a, b in zip(record['losses'], unplaced))
    if any(record['losses'] != ranks[0]['losses'] for record in ranks) \
            or worst > DP_RTOL:
        fail(f'phase 27 (c): losses {[r["losses"] for r in ranks]} against '
             f'the unplaced {unplaced} (rtol {DP_RTOL})')
    return dict(ranks=ranks, max_rel_err=worst, rtol=DP_RTOL)


def data_parallel(torch, seed: int, device: str = 'cuda', factory=None,
                  shape: tuple = (TRAIN_BATCH, TRAIN_SEQ),
                  two_ranks: bool = True) -> dict:
    """Phase 27: (a) the collectives and ``replica_checksums`` over a world
    of one rank (NCCL on the card, a local store), (b) GPT-2 125M's dense
    recipe through ``DataParallel`` and ``FullyShardedDataParallel``
    against the unplaced step, (c) two ranks sharing the card over gloo."""
    import tempfile

    from tpusystem_torch.parallel import multihost

    started = time.perf_counter()
    factory = factory or (lambda: dp_model(torch, device))
    multihost.initialize(f'127.0.0.1:{free_port()}', 1, 0, device=device)
    try:
        collective = collectives_at_one(torch, device)
        checksums = checksum_check(torch, factory())
        trained = policy_steps(torch, seed, device, factory, shape)
    finally:
        multihost.shutdown()
    record = dict(collectives=collective, checksums=checksums,
                  train=trained, launches=trained['launches'])
    if two_ranks:
        with tempfile.TemporaryDirectory() as root:
            record['two_ranks'] = two_ranks_on_one_card(
                torch, trained['runs']['unplaced']['losses'],
                pathlib.Path(root))
    record.update(card=card_line() if device == 'cuda' else None,
                  seconds=time.perf_counter() - started)
    return record


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', type=pathlib.Path, default=None,
                        help='also write the full result as JSON here')
    parser.add_argument('--dp-worker', nargs=3, default=None,
                        help=argparse.SUPPRESS)   # phase 27 (c)'s ranks
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device')
    if args.dp_worker is not None:
        rank, port, out = args.dp_worker
        dp_worker(int(rank), int(port), out)
        return
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
    llama_module, llama_prompts, llama_tokens, llama = serve_llama(
        torch, args.seed)
    print('serve-llama ' + json.dumps(llama))
    narrow = serve_llama_narrow(torch, llama_module, llama_prompts,
                                llama_tokens)
    print('serve-llama-narrow ' + json.dumps(narrow))
    del llama_module
    llama_trained = train_llama(torch, args.seed)
    print('train-llama ' + json.dumps(llama_trained))
    checks.append(check_row_uniforms(torch))
    sampled = serve_sampled(torch, args.seed, bf16_tokens)
    print('serve-sampled ' + json.dumps(sampled))
    prefix = serve_prefix(torch, args.seed)
    print('serve-prefix ' + json.dumps(prefix))
    basic = verybasic(torch)
    print('verybasic ' + json.dumps(basic))
    spec_generated = spec_generate(torch, args.seed)
    print('spec-generate ' + json.dumps(spec_generated))
    spec_served = serve_spec(torch, args.seed, bf16_tokens)
    print('serve-spec ' + json.dumps(spec_served))
    grouped_serving = check_grouped_serving(torch, generator)
    checks += grouped_serving
    moe_served = serve_moe(torch, args.seed)
    print('serve-moe ' + json.dumps(moe_served))
    disagg = serve_disagg(torch, args.seed)
    print('serve-disagg ' + json.dumps(disagg))
    resilient = train_resilient(torch, args.seed)
    print('train-resilient ' + json.dumps(resilient))
    observed = observe_lm(torch, args.seed, resilient['kill'])
    print('observe-lm ' + json.dumps(observed))
    resnet = resnet_phase(torch, args.seed)
    print('resnet ' + json.dumps(resnet))
    data_parallel_record = data_parallel(torch, args.seed)
    print('data-parallel ' + json.dumps(data_parallel_record))

    csrc = 'tpusystem_torch/ops/cuda/csrc/'
    pallas = 'tpusystem/ops/pallas/'
    # name: (source, replaces, headline check, launches on the main paths)
    table = {
        'decode_matmul': ('decode_matmul.cu', pallas + 'decode_matmul.py:99',
                          'decode_matmul[qkv]',
                          served['launches']['decode_matmul']
                          + disagg['launches']['decode_matmul']
                          + observed['launches']['decode_matmul']),
        'decode_ffn': ('decode_matmul.cu', pallas + 'decode_matmul.py:181',
                       'decode_ffn', served['launches']['decode_ffn']
                       + disagg['launches']['decode_ffn']
                       + observed['launches']['decode_ffn']),
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
            + sum(narrow[mode]['launches']['flash_attention_lse']
                  for mode in ('int8', 'fp8'))
            + llama_trained['launches']['flash_attention_lse']
            + sum(spec_served[name]['launches']['flash_attention_lse']
                  for name in ('self-f1', 'self-f2', 'random'))
            + moe_served['launches']['flash_attention_lse']
            + disagg['launches']['flash_attention_lse']
            + resilient['launches']['flash_attention_lse']
            + observed['launches']['flash_attention_lse']
            + data_parallel_record['launches']['flash_attention_lse']),
        'flash_bwd_fused_g1': ('flash_bwd.cu', pallas + 'flash.py:344',
                               'flash_bwd_fused_g1[1x16384]',
                               long['launches']['flash_bwd_fused_g1']),
        'flash_bwd_fused': ('flash_bwd.cu', pallas + 'flash.py:281',
                            'flash_bwd_fused[train]',
                            trained['launches']['flash_bwd_fused']
                            + dropout_trained['launches']['flash_bwd_fused']
                            + moe_trained['launches']['flash_bwd_fused']
                            + llama_trained['launches']['flash_bwd_fused']
                            + resilient['launches']['flash_bwd_fused']
                            + observed['launches']['flash_bwd_fused']
                            + data_parallel_record['launches'][
                                'flash_bwd_fused']),
        'flash_bwd_dq': ('flash_bwd.cu', pallas + 'flash.py:162',
                         'flash_bwd_dq[train]',
                         split['launches']['flash_bwd_dq']),
        'flash_bwd_dkv': ('flash_bwd.cu', pallas + 'flash.py:201',
                          'flash_bwd_dkv[train]',
                          split['launches']['flash_bwd_dkv']),
        'gather_rows_matmul': ('grouped_matmul.cu',
                               pallas + 'grouped_matmul.py:99',
                               'gather_rows_matmul[fwd]',
                               moe_trained['launches']['gather_rows_matmul']
                               + moe_served['launches'][
                                   'gather_rows_matmul']),
        'matmul_scatter_rows': (
            'grouped_matmul.cu', pallas + 'grouped_matmul.py:225',
            'matmul_scatter_rows[fwd]',
            moe_trained['launches']['matmul_scatter_rows']
            + moe_served['launches']['matmul_scatter_rows']),
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
                           dropout_trained['launches']['bernoulli_mask']
                           + basic['bernoulli_mask_launches']),
        # no pallas_call either: the reference samples with XLA's
        # jax.random.categorical
        'row_uniforms': ('threefry.cu', 'tpusystem/train/generate.py:195',
                         'row_uniforms', sampled['launches']['row_uniforms']
                         + spec_generated['sampled']['row_uniforms_launches']
                         + spec_served['sampled']['row_uniforms_launches']),
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
    # K6 and K7 at the MoE model's serving shapes, with their launches a
    # decode step
    for name in ('gather_rows_matmul', 'matmul_scatter_rows'):
        kernels[[k['name'] for k in kernels].index(name)]['serving'] = dict(
            launches=moe_served['launches'][name],
            launches_per_decode_step=moe_served['grouped_per_decode_step'],
            shapes={label: {key: measured[f'{name}[{label}]'][key]
                            for key in ('shape', 'max_abs_err', 'ms',
                                        'plain_ms', 'library_ms', 'bound_ms',
                                        'bound_by', 'bound_share', 'tflops',
                                        'bitwise_repeat')}
                    for label, _ in GROUPED_SERVING})
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
             'serve_sampled': sampled, 'serve_prefix': prefix,
             'verybasic': basic, 'serve_llama_narrow': narrow,
             'spec_generate': spec_generated, 'serve_spec': spec_served,
             'serve_moe': moe_served, 'serve_disagg': disagg,
             'train_resilient': resilient, 'observe_lm': observed,
             'resnet': resnet, 'data_parallel': data_parallel_record,
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
