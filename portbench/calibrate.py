"""The readings that a training cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--half] [--out <file>.jsonl]

For each seed, in one process: the program's set-up (its first steps),
then the plain reference: a sound run's readings, and each leaf's norms
(program and reference) behind them. With ``--control`` the reference
computed one precision below the configuration's, put in the program's
place; with ``--half`` the reference over half of each batch, the mean
over those rows. One JSON line a seed. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time
import types

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness, run                  # noqa: E402

# the nearest precision below the one a configuration states
CONTROL = {'bfloat16': 'fp8', 'float32': 'tf32'}


def cycle(chosen, seed: int, device) -> tuple:
    """One run of the cell without its window: set-up, whose first steps
    the check reads, then the reference. Returns the session and the
    program's and the reference's readings."""
    import torch

    ctx = types.SimpleNamespace(
        config=chosen.config, traffic=chosen.traffic, seed=seed,
        device=torch.device(device), spans=harness.Spans(),
        bench=chosen.bench)
    driver = chosen.driver
    session = driver.prepare(ctx)
    program = driver.warm(session)
    driver.release(session)
    gc.collect()
    return session, program, driver.reference(session, program)


def leaves(program: dict, reference: dict) -> dict:
    """``{key: {leaf: [program's norm, reference's norm]}}`` for the
    gradient and the change: what :func:`harness.train_checks` reduces."""
    return {key: {name: [program[key][name], norm]
                  for name, norm in reference[key].items()}
            for key in ('grads', 'changes')}


def readings(chosen, seed: int, device, control: bool,
             half: bool) -> dict:
    driver = chosen.driver
    started = time.perf_counter()
    session, program, reference = cycle(chosen, seed, device)
    line = {'seed': seed, 'seconds': time.perf_counter() - started,
            'sound': driver.checks(program, reference),
            'worst': harness.worst_leaves(program, reference),
            'losses': [program['losses'], reference['losses']],
            'leaves': leaves(program, reference)}
    if control:
        precision = CONTROL[chosen.config['program']['dtype']]
        line['control'] = dict(driver.planted(session, precision),
                               precision=precision)
    if half:
        line['half'] = driver.planted(session,
                                      keep=chosen.traffic['batch'] // 2)
    return line


def main(argv=None, *, device: str = 'cuda') -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--control', action='store_true')
    parser.add_argument('--half', action='store_true')
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    import torch

    chosen = run.cell(args.workload)
    if device == 'cuda':
        reason = run.card(torch, chosen.workload['chips'])
        if reason:
            print(reason, file=sys.stderr)
            return 2
    for seed in (int(seed) for seed in args.seeds.split(',')):
        line = json.dumps(readings(chosen, seed, device, args.control,
                                   args.half))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as out:
                out.write(line + '\n')
        if device == 'cuda':
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
