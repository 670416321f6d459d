"""Whole runs of the tiny cells on the CPU, the card's absence, the modules
a run may not load, and the correctness check against a broken program and
against its control."""

import json
import pathlib
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import calibrate, harness, run
from portbench.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY = sorted(tiny.CELLS)
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def result(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def main(bench, cell, trace=0, seed=3_000_000_019):
    return run.main(['--workload', cell, '--seed', str(seed), '--seconds',
                     '1', '--trace', str(trace)], device='cpu', bench=bench,
                    root=bench.parent)


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', TINY)
def test_a_tiny_run_prints_the_result_line(bench, cell, trace, capsys):
    assert main(bench, cell, trace) == 0
    line = result(capsys)
    assert list(line)[:5] == KEYS and list(line)[-1] == 'checks'
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] > 0
    chosen = run.cell(cell, bench, bench.parent)
    expected = chosen.per_layer if trace else chosen.end_to_end
    names = {metric['name'] for metric in expected}
    assert set(line['metrics']) <= names
    assert 'setup_s' in line['metrics'] or trace
    if trace:
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
        assert line['device']['window_s'] > 0
    for check in line['checks'].values():
        assert check['value'] <= check['limit']


def test_no_card_no_result(bench, capsys):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    code = run.main(['--workload', 'gpt2-small.train', '--seed', '1',
                     '--seconds', '1', '--trace', '0'])
    captured = capsys.readouterr()
    assert code == 2 and captured.out == ''
    assert 'no CUDA card' in captured.err


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    done = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'gpt2-small.train', '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ''


def test_runs_load_no_forbidden_module(bench):
    """Every driver's tiny run in one fresh interpreter, then its modules
    by whole top-level name."""
    script = f'''
import sys
sys.path.insert(0, {str(ROOT)!r})
import pathlib
from portbench import harness, run
bench = pathlib.Path({str(bench)!r})
for cell in {TINY!r}:
    code = run.main(['--workload', cell, '--seed', '5', '--seconds', '0.5',
                     '--trace', '0'], device='cpu', bench=bench,
                    root=bench.parent)
    assert code == 0, (cell, code)
print('FOUND', sorted({{name.split('.')[0] for name in sys.modules}}))
'''
    done = subprocess.run([sys.executable, '-c', script], capture_output=True,
                          text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-2000:]
    found = json.loads(done.stdout.strip().splitlines()[-1][6:]
                       .replace("'", '"'))
    assert 'tpusystem_torch' in found
    assert not set(found) & set(harness.FORBIDDEN)
    assert harness.forbidden_modules(['tpusystem_torch.train', 'jaxtyping',
                                      'flax.linen', 'tpusystem']) == [
        'flax', 'tpusystem']


def _unchanged(build):
    def builder(apply_fn, criterion, optimizer, **options):
        def step(state, inputs, targets):
            with torch.no_grad():
                loss = criterion(apply_fn(state.params, inputs, None, True),
                                 targets)
            return state, (None, loss)
        return step
    return builder


def _half(tree):
    if isinstance(tree, dict):
        return {key: _half(value) for key, value in tree.items()}
    return tree[:tree.shape[0] // 2]


def _half_batch(build):
    def builder(apply_fn, criterion, optimizer, **options):
        real = build(apply_fn, criterion, optimizer, **options)

        def step(state, inputs, targets):
            return real(state, _half(inputs), _half(targets))
        return step
    return builder


TRAIN_FAULTS = {'unchanged': _unchanged, 'half': _half_batch}


@pytest.mark.parametrize('fault', sorted(TRAIN_FAULTS))
@pytest.mark.parametrize('cell', ['gpt2-tiny.train', 'dlrm-tiny.train'])
def test_a_broken_train_step_is_not_correct(bench, cell, fault, capsys,
                                            monkeypatch):
    import tpusystem_torch.train as train
    monkeypatch.setattr(train, 'build_train_step',
                        TRAIN_FAULTS[fault](train.build_train_step))
    assert main(bench, cell) == 0
    assert result(capsys)['correct'] is False


def _limits(bench, cell):
    return harness.data_file('limits', cell, bench)


@pytest.mark.parametrize('cell', ['gpt2-tiny.train', 'dlrm-tiny.train'])
def test_the_training_control_fails_and_the_program_passes(bench, cell):
    chosen = run.cell(cell, bench, bench.parent)
    line = calibrate.readings(chosen, 7, 'cpu', True, True)
    limits = _limits(bench, cell)
    assert all(line['sound'][name] <= limit
               for name, limit in limits.items())
    for planted in ('control', 'half'):
        assert any(line[planted][name] > limit
                   for name, limit in limits.items()), planted


@pytest.mark.cuda
def test_a_cell_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: the benchmark measures only on the card')
    assert run.main(['--workload', 'gpt2-small.train', '--seed', '9',
                     '--seconds', '2', '--trace', '0']) == 0
    line = result(capsys)
    assert line['correct'] is True and line['device']['platform'] == 'gpu'
    assert types.SimpleNamespace(**line['metrics']).train_tokens_per_s
