"""A copy of the benchmark with cells at test size, for the CPU tests.

:func:`make` copies the benchmark's folder into ``root`` and adds, as new
files only, tiny configurations, mixes and limits, and a ``BENCHMARK.json``
that lists a tiny cell for every driver and opens every metric of a real cell
to its tiny twin.
"""

from __future__ import annotations

import json
import pathlib
import shutil

from portbench import harness

TWINS = {'gpt2-small.train': 'gpt2-tiny.train',
         'dlrm-kaggle.train': 'dlrm-tiny.train'}
CONFIGS = {
    'gpt2-tiny': ('gpt2-small', dict(n_embd=64, n_head=4, n_layer=2,
                                     n_positions=128, n_ctx=128,
                                     vocab_size=256, reference_rows=2)),
    'dlrm-tiny': ('dlrm-kaggle', dict(
        num_embeddings_per_feature=[64, 32, 1000, 3], embedding_dim=8,
        dense_in_features=4, dense_arch_layer_sizes=[16, 8],
        over_arch_layer_sizes=[16, 1]))}
MIXES = {
    'lm-train-tiny': ('lm-train', dict(batch=4, length=64, rows=32)),
    'clicks-tiny': ('clicks', dict(batch=256, samples=2048))}
CELLS = {'gpt2-tiny.train': ('gpt2-tiny', 'lm-train-tiny'),
         'dlrm-tiny.train': ('dlrm-tiny', 'clicks-tiny')}
# set from sound runs and controls at this size on the CPU
LIMITS = {'gpt2-tiny.train': {'grad_gap': 3e-3, 'change_gap': 0.05},
          'dlrm-tiny.train': {'loss_gap': 1e-5, 'grad_gap': 1e-3,
                              'change_gap': 1e-4}}


def _write(path: pathlib.Path, value) -> None:
    path.write_text(json.dumps(value, indent=1))


def make(root: pathlib.Path) -> pathlib.Path:
    """The copied benchmark folder under ``root``."""
    bench = root / 'portbench'
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    for name, (source, changes) in CONFIGS.items():
        _write(bench / 'configs' / f'{name}.json',
               dict(harness.data_file('configs', source), **changes))
    for name, (source, changes) in MIXES.items():
        _write(bench / 'traffic' / f'{name}.json',
               dict(harness.data_file('traffic', source), **changes))
    spec = harness.benchmark()
    for twin, (config, mix) in CELLS.items():
        spec['workloads'].append(dict(name=twin, config=config, traffic=mix,
                                      chips=1, why='test size'))
        _write(bench / 'limits' / f'{twin}.json', LIMITS[twin])
    for metric in spec['end_to_end'] + spec['per_layer']:
        if 'workloads' in metric:
            metric['workloads'] += [TWINS[name]
                                    for name in metric['workloads']]
    _write(root / 'BENCHMARK.json', spec)
    return bench
