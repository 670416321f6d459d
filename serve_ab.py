#!/usr/bin/env python3
"""Sampled and prefix-shared serving (``chip_smoke.py`` phases 17 and 18) of two trees, timed in turns on one NVIDIA card.

    python3 serve_ab.py OTHER_TREE [--seed 0] [--out FILE]

``OTHER_TREE`` is a directory that holds another version's
``tpusystem_torch/`` (for example a parent commit unpacked there with
``git archive``). The two trees run in turns, other, this, this, other, each
turn in a process of its own that builds that tree's kernels and serves
GPT-2 125M (weights and prompts from ``--seed``) through that tree's
``Engine``, with this tree's ``chip_smoke.py`` driving it:

* phase 17's requests (``chip_smoke.sampled_requests``), all greedy and
  then with the mixed rows ``SAMPLED_ROWS``, each run with four steps
  traced after the eighth (``chip_smoke.profile_steps``); then mixed and
  greedy again untraced, each step's host time split from outside the
  engine (``StepClock``: the keys, the decode's launches, the sampler, the
  grammar hook, the rest, and the garbage collector's pauses);
* phase 18 (``chip_smoke.serve_prefix``): ten prompts behind two shared
  prefixes with and without ``share_prefix``, TTFT per admission, and the
  traces of one resumed and one full prefill.

Prints one line a turn (step and TTFT medians, and the split of the
untraced steps), then each tree's mean over
its two turns: the median step ms of the greedy and the mixed run and
their ratio, the median TTFT of the resumed and the full prefills and
their ratio; then the card's name and power limit. Fails if a turn fails
or the trees' token streams differ. ``--out`` writes every turn in full
(traces included) as JSON. Imports nothing of JAX; exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


class StepClock:
    """Host milliseconds of each ``Engine.step``, split into its parts,
    timed from outside the engine with no profiler: ``_step_keys`` (the
    keys' hash and upload), ``_decode`` (the step's launches),
    ``sample_rows`` (the sampler's launches), ``_grammar_mask`` (the
    grammar hook and nothing else: its upload is in ``rest``) and ``rest``
    (the cursors, the token read that waits for the card, the
    bookkeeping); and the garbage collector's pauses inside the step."""

    PARTS = ('_step_keys', '_decode', '_grammar_mask')

    def __init__(self, engine, engine_module):
        self.steps = []
        self._now = dict.fromkeys(self.PARTS + ('sample_rows', 'gc'), 0.0)
        self._module = engine_module
        self._sample_rows = engine_module.sample_rows
        for name in self.PARTS:
            setattr(engine, name, self._timed(name, getattr(engine, name)))
        engine_module.sample_rows = self._timed('sample_rows',
                                                self._sample_rows)
        step = engine.step

        def timed_step():
            before, started = dict(self._now), time.perf_counter()
            report = step()
            record = {name: 1e3 * (self._now[name] - before[name])
                      for name in self._now}
            record['step'] = 1e3 * (time.perf_counter() - started)
            record['rest'] = record['step'] - sum(
                record[name] for name in self._now if name != 'gc')
            self.steps.append(record)
            return report

        engine.step = timed_step
        gc.callbacks.append(self._gc)

    def _timed(self, name, fn):
        def timed(*args, **kwargs):
            started = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._now[name] += time.perf_counter() - started
        return timed

    def _gc(self, phase, info):
        if phase == 'start':
            self._gc_started = time.perf_counter()
        else:
            self._now['gc'] += time.perf_counter() - self._gc_started

    def close(self) -> dict:
        """Restores the module's sampler; the medians a step of each part,
        and the collector's milliseconds over all steps."""
        self._module.sample_rows = self._sample_rows
        gc.callbacks.remove(self._gc)
        medians = {name: statistics.median(step[name] for step in self.steps)
                   for name in self.steps[0]}
        medians['gc_total'] = sum(step['gc'] for step in self.steps)
        return medians


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  HERE / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def turn(tree: pathlib.Path, seed: int) -> dict:
    """Phase 17's two runs and phase 18 with the ``Engine`` of ``tree``."""
    sys.path.insert(0, str(tree))
    import torch

    from tpusystem_torch.models import gpt2_small
    from tpusystem_torch.serve import Engine
    from tpusystem_torch.serve import engine as engine_module
    if not pathlib.Path(engine_module.__file__).resolve().is_relative_to(
            tree):
        sys.exit(f'serve_ab: imported {engine_module.__file__}, not from '
                 f'{tree}')
    smoke = chip_smoke()
    module = gpt2_small(device='cuda')
    module.init_weights(torch.Generator('cuda').manual_seed(seed))
    prompts, samplings, _ = smoke.sampled_requests(seed, module.vocab_size)
    runs = {}
    for name, rows in (('greedy', None), ('mixed', samplings)):
        engine = Engine(module, None, rows=smoke.ROWS, block_size=smoke.BLOCK)
        run = smoke.drive_engine(torch, engine, prompts, profile_at=8,
                                 samplings=rows)
        runs[name] = {key: run[key] for key in (
            'tokens', 'steps', 'step_ms', 'step_ms_quantiles',
            'decode_tokens_per_s', 'profile')}
    for name, rows in (('mixed', samplings), ('greedy', None)):
        engine = Engine(module, None, rows=smoke.ROWS, block_size=smoke.BLOCK)
        clock = StepClock(engine, engine_module)
        run = smoke.drive_engine(torch, engine, prompts, samplings=rows)
        if run['tokens'] != runs[name]['tokens']:
            sys.exit(f'serve_ab: the second {name} run emitted other tokens')
        runs[name]['split_ms'] = clock.close()
    del module
    prefix = smoke.serve_prefix(torch, seed)
    return {'tree': str(tree), 'serve': runs, 'prefix': prefix}


def summary(result: dict) -> dict:
    """A turn's medians: step ms of both runs, TTFT of both prefills."""
    serve, prefix = result['serve'], result['prefix']
    return {'tree': result['tree'],
            'greedy_step_ms': serve['greedy']['step_ms_quantiles'][1],
            'mixed_step_ms': serve['mixed']['step_ms_quantiles'][1],
            'resumed_ttft_ms': 1e3 * prefix['ttft_median_resumed_s'],
            'full_ttft_ms': 1e3 * prefix['ttft_median_full_s'],
            'greedy_split_ms': serve['greedy']['split_ms'],
            'mixed_split_ms': serve['mixed']['split_ms']}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=pathlib.Path)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', type=pathlib.Path, default=None)
    parser.add_argument('--turn', type=pathlib.Path, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('serve_ab: no CUDA device')
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.seed)))
        return
    other = args.other.resolve()
    if not (other / 'tpusystem_torch').is_dir():
        sys.exit(f'serve_ab: no tpusystem_torch/ in {other}')
    turns = []
    for tree in (other, HERE, HERE, other):
        result = subprocess.run(
            [sys.executable, __file__, str(other), '--seed', str(args.seed),
             '--turn', str(tree)], capture_output=True, text=True,
            check=False)
        if result.returncode != 0:
            sys.exit(f'serve_ab: the turn on {tree} failed:\n'
                     f'{result.stderr[-4000:]}')
        turns.append(json.loads(result.stdout.strip().splitlines()[-1]))
        print(json.dumps(summary(turns[-1])))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(turns, indent=1))
    for name in ('greedy', 'mixed'):
        streams = {json.dumps(t['serve'][name]['tokens']) for t in turns}
        if len(streams) != 1:
            sys.exit(f'serve_ab: the {name} runs emitted other tokens in '
                     'another turn')
    means = {}
    for label, tree in (('other', other), ('this', HERE)):
        rows = [summary(t) for t in turns if t['tree'] == str(tree)]
        mean = {key: sum(row[key] for row in rows) / len(rows)
                for key in rows[0] if key.endswith(('_step_ms', '_ttft_ms'))}
        mean['mixed_over_greedy'] = (mean['mixed_step_ms']
                                     / mean['greedy_step_ms'])
        mean['resumed_over_full'] = (mean['resumed_ttft_ms']
                                     / mean['full_ttft_ms'])
        means[label] = mean
    print(json.dumps(means))
    print(chip_smoke().card_line())


if __name__ == '__main__':
    main()
