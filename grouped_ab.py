#!/usr/bin/env python3
"""The grouped MoE kernels K6 and K7 of two trees, timed in turns on one NVIDIA card.

    python3 grouped_ab.py OTHER_TREE [--seed 0]

``OTHER_TREE`` is a directory that holds another version's
``tpusystem_torch/`` (for example a parent commit unpacked there with
``git archive``). The two trees run in turns, other, this, this, other, each
turn in a process of its own that builds that tree's kernels and times
``gather_rows_matmul`` (K6) and ``matmul_scatter_rows`` (K7) at
``chip_smoke.py`` phase 10's four shapes (one MoE layer's training step:
16,384 tokens routed top-2 over 8 experts at capacity 5,120, widths 768 and
3,072) on the same inputs, drawn from ``--seed``: CUDA events over 20 calls
after 5. Prints one JSON line a turn, then one line with each shape's
milliseconds per tree (the mean of its two turns) and their ratio, then the
card's name and power limit. Imports nothing of JAX; exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SHAPES = ('gather_rows_matmul[fwd]', 'gather_rows_matmul[bwd]',
          'matmul_scatter_rows[fwd]', 'matmul_scatter_rows[bwd]')


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  HERE / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def events_ms(torch, fn, calls: int = 20, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def turn(tree: pathlib.Path, seed: int) -> dict:
    """Times the four shapes with the kernels of ``tree``."""
    sys.path.insert(0, str(tree))
    import torch
    from tpusystem_torch.ops.cuda import grouped_matmul as gm
    if not pathlib.Path(gm.__file__).resolve().is_relative_to(tree):
        sys.exit(f'grouped_ab: imported {gm.__file__}, not from {tree}')
    torch.backends.cuda.matmul.allow_tf32 = False
    g = chip_smoke().grouped_inputs(
        torch, torch.Generator('cuda').manual_seed(seed))
    capacity, tokens = g['capacity'], g['tokens']
    calls = {
        SHAPES[0]: lambda: gm.gather_rows_matmul(
            g['x'], g['w1'], g['clamped'], g['valid'],
            rows_per_group=capacity),
        SHAPES[1]: lambda: gm.gather_rows_matmul(
            g['d_out'], g['w2'], g['clamped'], g['w_slot'],
            rows_per_group=capacity, transpose_rhs=True),
        SHAPES[2]: lambda: gm.matmul_scatter_rows(
            g['grown'], g['w2'], g['b2'], g['slot_token'], g['w_slot'],
            tokens, rows_per_group=capacity),
        SHAPES[3]: lambda: gm.matmul_scatter_rows(
            g['d_pre'], g['w1'], None, g['slot_token'], g['valid'], tokens,
            rows_per_group=capacity, transpose_rhs=True, save_rows=False),
    }
    return {'tree': str(tree),
            'ms': {name: events_ms(torch, fn) for name, fn in calls.items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=pathlib.Path)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--turn', type=pathlib.Path, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('grouped_ab: no CUDA device')
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.seed)))
        return
    other = args.other.resolve()
    if not (other / 'tpusystem_torch').is_dir():
        sys.exit(f'grouped_ab: no tpusystem_torch/ in {other}')
    turns = []
    for tree in (other, HERE, HERE, other):
        result = subprocess.run(
            [sys.executable, __file__, str(other), '--seed', str(args.seed),
             '--turn', str(tree)], capture_output=True, text=True,
            check=False)
        if result.returncode != 0:
            sys.exit(f'grouped_ab: the turn on {tree} failed:\n'
                     f'{result.stderr[-4000:]}')
        turns.append(json.loads(result.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]))
    mean = {label: {name: sum(t['ms'][name] for t in turns
                              if t['tree'] == str(tree)) / 2
                    for name in SHAPES}
            for label, tree in (('other', other), ('this', HERE))}
    print(json.dumps({'ms': mean, 'other_over_this': {
        name: mean['other'][name] / mean['this'][name] for name in SHAPES}}))
    print(chip_smoke().card_line())


if __name__ == '__main__':
    main()
