#!/usr/bin/env python3
"""Where the fused flash backward (K2a, K2b) spends its time, on one NVIDIA card.

    python3 bwd_phases.py [--seed 0]

Builds ``tpusystem_torch/ops/cuda/csrc/flash_bwd.cu`` a second time with
``FLASH_BWD_PHASES`` defined: thread 0 of every block then sums its cycles
in each phase of a (q tile, query head) pair (the kernel's ``PHASE``
markers: issuing the next pair's loads, waiting for this pair's, S^T and
dP^T, P^T and dS^T, the ticket and its barrier, dV, dK and dQ, the dq adds,
the closing barrier and the release). At K2b's Llama-3 8B training shape
[1, 8192, 32, 8, 128], K2a's long-context shape [1, 16384, 12, 64] and K2b's
GPT-2 training shape [16, 1024, 12, 64] (causal, bf16 inputs drawn from
``--seed``) it prints one JSON line a shape: the kernel's milliseconds as
the port builds it and as instrumented (CUDA events, 5 calls after 2), each
phase's share of the work items' cycles, and the ticket wait share; then
the card's name and power limit. Imports nothing of JAX; exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

PHASES = ('load_issue', 'load_wait', 'scores', 'terms', 'ticket',
          'products', 'dq_add', 'close')
SHAPES = {'K2b [1, 8192, 32, 8, 128]': (1, 8192, 32, 8, 128),
          'K2a [1, 16384, 12, 64]': (1, 16384, 12, 12, 64),
          'K2b [16, 1024, 12, 64]': (16, 1024, 12, 12, 64)}


def events_ms(torch, fn, calls: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('bwd_phases: no CUDA device')
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from tpusystem_torch.ops.cuda import _build, flash

    libraries = _build.LIBRARIES.build()
    target = _build.BUILD / 'flash_bwd_phases.so'
    built = subprocess.run(
        [_build.nvcc(), *_build.FLAGS, '-DFLASH_BWD_PHASES', '-o', str(target),
         str(_build.CSRC / 'flash_bwd.cu')],
        capture_output=True, text=True)
    if built.returncode:
        sys.exit(f'bwd_phases: nvcc failed:\n{built.stdout}{built.stderr}')
    instrumented = ctypes.CDLL(str(target))

    @contextlib.contextmanager
    def phases_build():
        """The flash wrappers launch the instrumented library meanwhile."""
        port = libraries['flash_bwd']
        libraries['flash_bwd'] = instrumented
        try:
            yield
        finally:
            libraries['flash_bwd'] = port

    generator = torch.Generator('cuda').manual_seed(args.seed)
    for label, (batch, seq, heads, kv_heads, head_dim) in SHAPES.items():
        q, d_out = (torch.randn((batch, seq, heads, head_dim),
                                generator=generator,
                                device='cuda').to(torch.bfloat16)
                    for _ in range(2))
        k, v = (torch.randn((batch, seq, kv_heads, head_dim),
                            generator=generator,
                            device='cuda').to(torch.bfloat16)
                for _ in range(2))
        out, lse = flash.flash_attention_lse(q, k, v)
        delta = flash.attention_delta(out, d_out).contiguous()
        call = (q, k, v, d_out, lse, delta)
        ms = events_ms(torch, lambda: flash.flash_bwd_fused(*call))
        with phases_build():
            instrumented_ms = events_ms(
                torch, lambda: flash.flash_bwd_fused(*call))
            clocks = flash.fused_clocks(*call).double().sum(0)
        cycles = clocks[len(PHASES)].item()
        print(json.dumps({
            'shape': label, 'ms': ms, 'instrumented_ms': instrumented_ms,
            'phase_share': {name: clocks[n].item() / cycles
                            for n, name in enumerate(PHASES)},
            'ticket_wait_share': clocks[len(PHASES) + 1].item() / cycles}))
        del q, k, v, d_out, out, lse, delta, call
        torch.cuda.empty_cache()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(card or 'nvidia-smi unavailable')


if __name__ == '__main__':
    main()
