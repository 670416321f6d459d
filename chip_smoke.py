#!/usr/bin/env python3
"""Bring-up run of tpusystem_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out PATH]

Phases, in order; any failure exits non-zero:

1. build the hand-written kernels from ``tpusystem_torch/ops/cuda/csrc``
   (``nvcc`` for ``sm_90a``, one process per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (bfloat16, batch 8, prefill lengths 512 and 1024)
   and time it beside the plain version, the one PyTorch library call that
   computes the same function, and its bound;
3. serve GPT-2 125M (full width, random weights from ``--seed``) through the
   paged ``Engine``: eight requests of 20 to 700 prompt tokens, 32 new tokens
   each; every kernel's launch count must rise during this run, and one
   decode step's logits through the fused kernels must agree with the module
   path on the same state; then a traced window of decode steps says where
   a step's time goes;
4. print the ``kernels`` line, the card's name and power limit, and last the
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

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak, same source
L2_FLUSH_BYTES = 128 << 20      # rotating inputs exceed the 50 MB L2
ROWS, BLOCK, MAX_NEW = 8, 16, 32
PROMPT_LENGTHS = (20, 300, 700, 20, 300, 700, 100, 450)


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


def measure(fn, calls: int = 50):
    """Device milliseconds per call of ``fn(i)``: the summed kernel time of
    a profiled window, and the CUDA-event time of the same window (which
    also counts the gaps the host leaves between launches)."""
    import torch
    for i in range(5):
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
    with torch.profiler.profile(activities=activities) as profile:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    device_us = 0.0
    for event in profile.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            device_us += getattr(event, 'self_device_time_total', 0.0)
    device_ms = device_us / 1e3 / calls
    return (device_ms if device_ms > 0 else event_ms), event_ms


def bound_ms(moved_bytes: float, flops: float):
    memory, compute = moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(memory, compute) * 1e3, ('bytes' if memory >= compute
                                        else 'operations')


def rotating(make, one_set_bytes: int):
    """Enough independent input sets that cycling through them keeps every
    call's inputs out of L2, as the serving path finds them."""
    copies = max(2, math.ceil(L2_FLUSH_BYTES / one_set_bytes))
    return [make() for _ in range(copies)]


def check_kernels(torch, generator):
    """Phase 2: every kernel against its plain version, timed."""
    import torch.nn.functional as F

    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import flash

    device = torch.device('cuda')
    bf16 = torch.bfloat16
    dim, hidden = 768, 3072

    def normal(shape, scale=1.0):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(bf16)

    def vector(cols):
        return torch.randn(cols, generator=generator, device=device) * 0.1

    rows = []

    def record(name, shape, err, tol, timed, plain, library, bound):
        entry = dict(shape=shape, max_abs_err=err, tol=tol, ms=timed[0],
                     event_ms=timed[1], plain_ms=plain[0],
                     library_ms=None if library is None else library[0],
                     bound_ms=bound[0], bound_by=bound[1])
        print('kernel-check ' + json.dumps({'name': name, **entry}))
        if not err <= tol:
            fail(f'{name} {shape}: max abs err {err} over {tol}')
        rows.append((name, entry))

    # K4 decode_matmul at the qkv and out shapes of one decode step
    for label, cols in (('qkv', 3 * dim), ('out', dim)):
        sets = rotating(lambda: dict(x=normal((ROWS, dim)),
                                     w=normal((dim, cols), dim ** -0.5),
                                     b=vector(cols)),
                        dim * cols * 2)
        for s in sets:
            s['wt'], s['b16'] = s['w'].t().contiguous(), s['b'].to(bf16)
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
        moved = (ROWS * dim * 2 + dim * cols * 2 + cols * 4 + ROWS * cols * 2)
        record(f'decode_matmul[{label}]', [ROWS, dim, cols], err, tol, timed,
               plain, library, bound_ms(moved, 2 * ROWS * dim * cols))

    # K5 decode_ffn at the FFN shape of one decode step
    sets = rotating(lambda: dict(x=normal((ROWS, dim)),
                                 w1=normal((dim, hidden), dim ** -0.5),
                                 b1=vector(hidden),
                                 w2=normal((hidden, dim), hidden ** -0.5),
                                 b2=vector(dim)),
                    2 * dim * hidden * 2)
    for s in sets:
        s['w1t'], s['w2t'] = s['w1'].t().contiguous(), s['w2'].t().contiguous()
        s['b1h'], s['b2h'] = s['b1'].to(bf16), s['b2'].to(bf16)
    pick = lambda i: sets[i % len(sets)]
    args = lambda s: (s['x'], s['w1'], s['b1'], s['w2'], s['b2'])
    got = dm.decode_ffn(*args(sets[0]))
    want = dm.decode_ffn_plain(*args(sets[0]))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -7 * want.float().abs().max().item()
    timed = measure(lambda i: dm.decode_ffn(*args(pick(i))))
    plain = measure(lambda i: dm.decode_ffn_plain(*args(pick(i))))
    library = measure(lambda i: F.linear(F.gelu(
        F.linear(pick(i)['x'], pick(i)['w1t'], pick(i)['b1h']),
        approximate='tanh'), pick(i)['w2t'], pick(i)['b2h']))
    moved = (ROWS * dim * 2 + 2 * dim * hidden * 2 + hidden * 4 + dim * 4
             + ROWS * dim * 2)
    record('decode_ffn', [ROWS, dim, hidden, dim], err, tol, timed, plain,
           library, bound_ms(moved, 4 * ROWS * dim * hidden))

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
               plain, library, bound_ms(moved, flops))
    return rows


def profile_steps(torch, engine, steps: int = 4) -> dict:
    """Where a decode step's time goes: a traced window of ``steps`` engine
    steps (tracing slows the host, so the step time of the untraced run is
    the one to quote). Device busy share = summed kernel time over the
    window's wall time; the rest is the card waiting on the host."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as profile:
        started = time.perf_counter()
        for _ in range(steps):
            engine.step()
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
        ranked = sorted(table.items(), key=lambda item: -item[1])[:8]
        return {name[:90]: us / steps for name, us in ranked}

    return dict(steps=steps, traced_step_ms=1e3 * wall / steps,
                device_ms_per_step=busy_us / 1e3 / steps,
                device_busy_share=busy_us / 1e6 / wall,
                device_ops_per_step=launches / steps,
                top_kernels_us_per_step=top(kernels),
                top_operators_us_per_step=top(operators))


def serve(torch, seed: int):
    """Phase 3: GPT-2 125M through the paged Engine (the main path)."""
    import numpy as np

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
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, module.vocab_size, (n,))
               for n in PROMPT_LENGTHS]
    counters = (dm.decode_matmul, dm.decode_ffn, flash.flash_attention_lse)
    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    started = time.perf_counter()
    finished, steps, step_seconds, emitted = {}, 0, 0.0, 0
    for prompt in prompts:
        admission = engine.admit(prompt, MAX_NEW)
        if admission.finished:
            fail(f'request in row {admission.row} finished at admission')
    admit_seconds = time.perf_counter() - started
    while engine.active_rows:
        report = engine.step()
        steps += 1
        step_seconds += engine.last_step_seconds
        emitted += sum(len(tokens) for tokens in report.emitted.values())
        for row, reason, tokens in report.finished:
            finished[row] = (reason, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    launches = {counter.__name__: counter.launches for counter in counters}
    prefill_seconds = engine.timings['prefill']

    if len(finished) != len(prompts):
        fail(f'{len(finished)} of {len(prompts)} requests finished')
    for row, (reason, tokens) in finished.items():
        if reason != 'length' or len(tokens) != MAX_NEW or not all(
                0 <= t < module.vocab_size for t in tokens):
            fail(f'row {row}: {reason}, {len(tokens)} tokens')
    for name, count in launches.items():
        if count == 0:
            fail(f'{name} was not launched on the main path')

    # one decode step's logits, fused kernels vs module path, same state
    for prompt in prompts:
        engine.admit(prompt, MAX_NEW)
    fused = engine.next_logits('fused')
    module_path = engine.next_logits('flax')
    torch.cuda.synchronize()
    if not (torch.isfinite(fused).all() and fused.shape == (
            ROWS, module.vocab_size)):
        fail('fused step logits are not finite [rows, vocab]')
    logit_err = (fused - module_path).abs().max().item()
    # the two paths round at different points (the module rounds each dense
    # product before its bias, the kernels once after it): a few bfloat16
    # steps per layer, summed over 12 layers, of logits of order 1
    logit_tol = 2 ** -4 * module_path.abs().max().item()
    agree = (fused.argmax(-1) == module_path.argmax(-1)).float().mean().item()
    if logit_err > logit_tol:
        fail(f'fused vs module logits: max abs err {logit_err} over '
             f'{logit_tol}')
    print('step-profile ' + json.dumps(profile_steps(torch, engine)))
    return dict(launches=launches, steps=steps, decode_tokens=emitted,
                decode_tokens_per_s=emitted / step_seconds,
                step_ms=1e3 * step_seconds / steps,
                prefill_s=prefill_seconds, admit_s=admit_seconds,
                wall_s=wall, logit_max_abs_err=logit_err,
                logit_tol=logit_tol, argmax_agreement=agree,
                prompt_lengths=list(PROMPT_LENGTHS), max_new=MAX_NEW)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', type=pathlib.Path, default=None,
                        help='also write the full result as JSON here')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device')
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    try:
        from tpusystem_torch.ops.cuda._build import LIBRARIES
    except ImportError as error:
        fail(f'the tpusystem_torch package is not beside this script '
             f'({error})')
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

    generator = torch.Generator('cuda').manual_seed(args.seed)
    checks = check_kernels(torch, generator)
    served = serve(torch, args.seed)
    print('serve ' + json.dumps(served))

    csrc = 'tpusystem_torch/ops/cuda/csrc/'
    sources = {'decode_matmul': csrc + 'decode_matmul.cu',
               'decode_ffn': csrc + 'decode_matmul.cu',
               'flash_attention_lse': csrc + 'flash_fwd.cu'}
    replaces = {'decode_matmul': 'tpusystem/ops/pallas/decode_matmul.py:99',
                'decode_ffn': 'tpusystem/ops/pallas/decode_matmul.py:181',
                'flash_attention_lse': 'tpusystem/ops/pallas/flash.py:106'}
    # the line reports each kernel at its largest main-path shape
    headline = {'decode_matmul': 'decode_matmul[qkv]',
                'decode_ffn': 'decode_ffn',
                'flash_attention_lse': 'flash_attention[S=1024]'}
    measured = dict(checks)
    kernels = []
    for name, label in headline.items():
        entry = measured[label]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': sources[name],
            'replaces': replaces[name],
            'launches': served['launches'][name],
            'max_abs_err': entry['max_abs_err'], 'ms': entry['ms'],
            'plain_ms': entry['plain_ms'], 'bound_ms': entry['bound_ms'],
            'bound_by': entry['bound_by'], 'library_ms': entry['library_ms'],
            'shape': entry['shape']})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {'card': card, 'build_s': build_seconds, 'checks': checks,
             'serve': served, 'kernels': kernels,
             'compiler_output': LIBRARIES.compiler_output}, indent=1))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
