"""BENCHMARK.json and the files it names: every cell, configuration, mix,
driver, limit and metric resolves by name, and one more of each, added as
files only, is found with no edit."""

import json
import math
import re
import shutil

import pytest

from portbench import harness, run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
SPEC = harness.benchmark()


def test_top_level_keys_and_command():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['command'] == ['python3', 'portbench/run.py']
    assert SPEC['paths'] == ['portbench']
    assert 1 <= SPEC['run_seconds'] <= 51


def test_budget_holds_with_every_cell_there_may_be():
    runs = 2 + 14 * 24
    total = runs * (SPEC['run_seconds'] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize('entry', SPEC['configs'] + SPEC['workloads']
                         + SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda entry: entry['name'])
def test_names_units_and_keys(entry):
    assert NAME.match(entry['name'])
    if 'unit' in entry:
        assert UNIT.match(entry['unit'])
        assert entry['better'] in ('lower', 'higher')
        assert entry['source'] in SOURCES


def test_every_config_is_used_and_its_file_holds_its_cuts():
    used = {cell['config'] for cell in SPEC['workloads']}
    for config in SPEC['configs']:
        assert config['name'] in used
        data = json.loads((harness.ROOT / config['file']).read_text())
        assert data['reduced'] == config['reduced']
        assert all(key in data for key in config['reduced'])
        assert config['file'] == f"portbench/configs/{config['name']}.json"


@pytest.mark.parametrize('name', [cell['name'] for cell in SPEC['workloads']])
def test_each_cell_resolves_with_its_metrics(name):
    chosen = run.cell(name)
    assert chosen.workload['chips'] == 1
    assert hasattr(chosen.driver, 'prepare') and hasattr(chosen.driver,
                                                         'window')
    assert chosen.limits and all(0 < limit < math.inf
                                 for limit in chosen.limits.values())
    reported = {metric['name'] for metric in chosen.end_to_end}
    assert 'setup_s' in reported and len(reported) >= 2
    assert chosen.per_layer
    for metric in chosen.end_to_end + chosen.per_layer:
        assert callable(harness.load_module('metrics', metric['name']).read)
    for metric in chosen.per_layer:
        assert metric['moves'] in reported


def test_end_to_end_bounds():
    for metric in SPEC['end_to_end']:
        assert 0.01 <= metric['bound'] <= 0.25
        assert metric['source'] in ('host_clock', 'device_trace')


def test_layer_names_are_in_perf_md():
    layers = {metric['layer'] for metric in SPEC['per_layer']}
    text = (harness.ROOT / 'PERF.md').read_text()
    for layer in layers:
        assert f'| {layer} |' in text, layer


def test_one_more_of_each_is_found_from_new_files_alone(tmp_path):
    """A new configuration, mix, driver, generator, metric and cell, each
    a file of its own; only BENCHMARK.json lists the cell."""
    bench = tmp_path / 'portbench'
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    before = {path.relative_to(bench): path.read_bytes()
              for path in bench.rglob('*') if path.is_file()}
    (bench / 'configs' / 'gpt2-other.json').write_text(json.dumps(
        dict(harness.data_file('configs', 'gpt2-small'), n_layer=2)))
    (bench / 'traffic' / 'other.json').write_text(json.dumps(
        dict(harness.data_file('traffic', 'lm-train'), driver='other',
             generator='other')))
    shutil.copy(bench / 'drivers' / 'lm_train.py',
                bench / 'drivers' / 'other.py')
    shutil.copy(bench / 'generators' / 'tokens.py',
                bench / 'generators' / 'other.py')
    (bench / 'metrics' / 'other.steps.py').write_text(
        'def read(run):\n    return run.counts["steps"]\n')
    (bench / 'limits' / 'gpt2-other.other.json').write_text(
        json.dumps({'loss_gap': 1.0}))
    spec = json.loads(json.dumps(SPEC))
    spec['workloads'].append(dict(name='gpt2-other.other',
                                  config='gpt2-other', traffic='other',
                                  chips=1, why='new files only'))
    spec['per_layer'].append(dict(
        name='other.steps', unit='steps', better='higher',
        source='host_clock', layer='train step',
        moves='train_tokens_per_s', workloads=['gpt2-other.other']))
    spec['end_to_end'][0]['workloads'].append('gpt2-other.other')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    chosen = run.cell('gpt2-other.other', bench, tmp_path)
    assert chosen.config['n_layer'] == 2
    assert chosen.traffic['driver'] == 'other'
    assert chosen.driver.__file__.endswith('drivers/other.py')
    assert harness.load_module('generators', 'other', bench).pool
    assert [m['name'] for m in chosen.per_layer] == ['other.steps']
    assert run.read_metrics(chosen.per_layer, _FakeRun(), bench) == {
        'other.steps': {'value': 7, 'unit': 'steps'}}
    assert chosen.limits == {'loss_gap': 1.0}
    after = {path.relative_to(bench): path.read_bytes()
             for path in bench.rglob('*') if path.is_file()}
    assert all(after[path] == data for path, data in before.items())


class _FakeRun:
    counts = {'steps': 7}


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        run.cell('no-such.cell')
    with pytest.raises(KeyError):
        harness.load_module('metrics', 'no.such.metric')
    assert math.isfinite(SPEC['run_seconds'])
