#!/usr/bin/env python3
"""K4 and K5 (the decode matmul and FFN) and K9 (the ordered scatter-add) of two trees, timed in turns on one NVIDIA card.

    python3 decode_lookup_ab.py OTHER_TREE [--seed 0]

``OTHER_TREE`` is a directory that holds another version's
``tpusystem_torch/`` (for example a parent commit unpacked there with
``git archive``). The two trees run in turns, other, this, this, other, each
turn in a process of its own that builds that tree's kernels and times, on
the same inputs drawn from ``--seed``:

* ``decode_matmul`` at ``chip_smoke.py`` phases 2 and 6's shapes (8 rows of
  GPT-2's qkv [768, 2304] and out-projection [768, 768]) and
  ``decode_ffn`` at their FFN shape (8 rows through [768, 3072] and
  [3072, 768]), with bf16, int8 and e4m3 weights, cycling through enough
  input sets to keep them out of L2;
* ``scatter_add_rows`` at phase 13's fold (65,536 Zipf ids over the largest
  Criteo Kaggle table, deduplicated, their ``inverse`` folded into
  [65,536, 128]) and ``scatter_add_into`` (the kernels alone) on that fold
  and on the dedup path into the [10,131,227, 128] table.

Each time is the profiler's device time per call (``chip_smoke.measure``:
the kernels' sum, not the host's launch gaps). Prints one JSON line a turn,
then one line with each case's milliseconds per tree (the mean of its two
turns) and their ratio, then the card's name and power limit. Imports
nothing of JAX; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
MODES = (('', 'bf16'), ('_int8', 'int8'), ('_fp8', 'fp8'))
CASES = tuple(f'decode_matmul{suffix}[{shape}]'
              for suffix, _ in MODES for shape in ('qkv', 'out')
              ) + tuple(f'decode_ffn{suffix}' for suffix, _ in MODES) + (
                  'scatter_add_rows[fold]', 'scatter_add_into[fold]',
                  'scatter_add_into[dedup]')


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  HERE / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ffn_sets(torch, smoke, generator, mode):
    """Input sets of ``decode_ffn`` at the FFN shape, enough to keep them
    out of L2 when cycled."""
    from tpusystem_torch.ops.precision import quantize_leaf

    def weight(shape):
        w = torch.randn(shape, generator=generator,
                        device='cuda') * shape[0] ** -0.5
        return w.to(torch.bfloat16) if mode == 'bf16' else quantize_leaf(
            w, mode)

    def one_set():
        x = torch.randn((smoke.ROWS, smoke.DIM), generator=generator,
                        device='cuda').to(torch.bfloat16)
        return (x, weight((smoke.DIM, smoke.HIDDEN)),
                torch.randn(smoke.HIDDEN, generator=generator,
                            device='cuda') * 0.1,
                weight((smoke.HIDDEN, smoke.DIM)),
                torch.randn(smoke.DIM, generator=generator,
                            device='cuda') * 0.1)
    return smoke.rotating(one_set, 2 * smoke.DIM * smoke.HIDDEN
                          * (2 if mode == 'bf16' else 1))


def turn(tree: pathlib.Path, seed: int) -> dict:
    """Times every case with the kernels of ``tree``."""
    sys.path.insert(0, str(tree))
    import torch
    from tpusystem_torch.ops.cuda import decode_matmul as dm
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    from tpusystem_torch.ops.precision import quantize_leaf
    from tpusystem_torch.recsys import dedup_ids
    if not pathlib.Path(dm.__file__).resolve().is_relative_to(tree):
        sys.exit(f'decode_lookup_ab: imported {dm.__file__}, not from {tree}')
    smoke = chip_smoke()
    generator = torch.Generator('cuda').manual_seed(seed)
    times = {}
    for suffix, mode in MODES:
        for shape, cols in (('qkv', 3 * smoke.DIM), ('out', smoke.DIM)):
            def one_set():
                x = torch.randn((smoke.ROWS, smoke.DIM), generator=generator,
                                device='cuda').to(torch.bfloat16)
                w = torch.randn((smoke.DIM, cols), generator=generator,
                                device='cuda') * smoke.DIM ** -0.5
                w = (w.to(torch.bfloat16) if mode == 'bf16'
                     else quantize_leaf(w, mode))
                return x, w, torch.randn(cols, generator=generator,
                                         device='cuda') * 0.1
            sets = smoke.rotating(one_set, smoke.DIM * cols
                                  * (2 if mode == 'bf16' else 1))
            times[f'decode_matmul{suffix}[{shape}]'] = smoke.measure(
                lambda i: dm.decode_matmul(*sets[i % len(sets)]))[0]
        sets = ffn_sets(torch, smoke, generator, mode)
        times[f'decode_ffn{suffix}'] = smoke.measure(
            lambda i: dm.decode_ffn(*sets[i % len(sets)]))[0]
        del sets
    vocab, dim, count = max(smoke.CRITEO_KAGGLE), smoke.DLRM_DIM, 65536
    raw = torch.as_tensor(smoke.zipf_ids(vocab, count, seed), device='cuda')
    reps, inverse = dedup_ids(raw, vocab)
    d_rows = torch.randn((count, dim), generator=generator, device='cuda')
    ones = torch.ones(count, device='cuda')
    times['scatter_add_rows[fold]'] = smoke.measure(
        lambda i: el.scatter_add_rows(d_rows, inverse, ones, count),
        calls=20)[0]
    for case, (ids, scale, rows) in {
            'fold': (inverse, ones, count),
            'dedup': (reps, (reps < vocab).float(), vocab)}.items():
        sorted_ids, order = el.sort_ids(ids)
        out = torch.zeros((rows, dim), device='cuda')
        times[f'scatter_add_into[{case}]'] = smoke.measure(
            lambda i: el.scatter_add_into(out, d_rows, scale, sorted_ids,
                                          order), calls=20)[0]
        del out
    return {'tree': str(tree), 'ms': times}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=pathlib.Path)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--turn', type=pathlib.Path, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('decode_lookup_ab: no CUDA device')
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.seed)))
        return
    other = args.other.resolve()
    if not (other / 'tpusystem_torch').is_dir():
        sys.exit(f'decode_lookup_ab: no tpusystem_torch/ in {other}')
    turns = []
    for tree in (other, HERE, HERE, other):
        result = subprocess.run(
            [sys.executable, __file__, str(other), '--seed', str(args.seed),
             '--turn', str(tree)], capture_output=True, text=True,
            check=False)
        if result.returncode != 0:
            sys.exit(f'decode_lookup_ab: the turn on {tree} failed:\n'
                     f'{result.stderr[-4000:]}')
        turns.append(json.loads(result.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]))
    mean = {label: {case: sum(t['ms'][case] for t in turns
                              if t['tree'] == str(tree)) / 2
                    for case in CASES}
            for label, tree in (('other', other), ('this', HERE))}
    print(json.dumps({'ms': mean, 'other_over_this': {
        case: mean['other'][case] / mean['this'][case] for case in CASES}}))
    print(chip_smoke().card_line())


if __name__ == '__main__':
    main()
