"""Package rules of the port: no JAX inside, the card by default."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import tpusystem_torch
from tpusystem_torch.models import gpt2_tiny, resnet_tiny
from tpusystem_torch.serve import Engine
from tpusystem_torch.train import generate

PACKAGE = pathlib.Path(tpusystem_torch.__file__).resolve().parent
EXAMPLES = PACKAGE.parent / 'examples'
# the port's example twins: scripts run by path, and tinysys_torch's inner
# package, imported by name with its example directory on the path
TWINS = ('verybasic_torch', 'tinysys_torch', 'lm_torch')
INNER = ('tinysys_torch', 'tinysys_torch.classifier', 'tinysys_torch.domain',
         'tinysys_torch.metrics', 'tinysys_torch.services',
         'tinysys_torch.services.compilation',
         'tinysys_torch.services.training')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpusystem')


def _modules():
    for path in sorted(PACKAGE.rglob('*.py')):
        relative = path.relative_to(PACKAGE.parent).with_suffix('')
        parts = relative.parts[:-1] if relative.name == '__init__' \
            else relative.parts
        yield path, '.'.join(parts)


# the serving control plane and its dependencies (scanned like every module)
CONTROL_PLANE = ('serve.disagg', 'serve.scheduler', 'serve.failover',
                 'serve.fleet', 'serve.service', 'serve.certify',
                 'parallel.chaos', 'checkpoint.memstore')
# the reference's serving names that exist only for meshes (ROADMAP queue 1
# item 9, tensor parallelism)
MESH_ONLY = ('pool_shardings',)
# the observability slice and the one-device mesh (scanned like every
# module)
OBSERVE = ('observe.trace', 'observe.flight', 'observe.metrics',
           'observe.logs', 'observe.tensorboard', 'observe.tracking',
           'observe.profile', 'parallel.mesh', 'parallel.sharding',
           'data.datasets')


# the multi-process control plane, elastic membership, the orchestrator
# and the ResNet (scanned like every module)
MULTI_PROCESS = ('parallel.multihost', 'parallel.chaos', 'parallel.elastic',
                 'parallel.supervisor', 'runtime', 'orchestrator',
                 'orchestrator.namespace', 'orchestrator.journal',
                 'orchestrator.gang', 'orchestrator.certify',
                 'models.resnet')


# collectives and data parallelism (ROADMAP 9b; scanned like every module)
DATA_PARALLEL = ('parallel.collectives', 'parallel.mesh', 'parallel.sharding',
                 'parallel.multihost', 'runtime', 'data.loader',
                 'checkpoint.memstore', 'train.step')
# the reference's parallel names of later sub-items (9c tensor parallelism:
# overlap and schedule; 9d pipelines) and its JAX-only virtual-device helper
LATER = {'force_host_platform', 'PipelineParallel', 'compose_stacked_rules',
         'pipeline_apply', 'pipeline_train', 'allgather_matmul',
         'matmul_reducescatter', 'allgather_plan', 'reducescatter_plan',
         'tp_ffn', 'tp_swiglu', 'OverlapSchedule', 'FsdpPlan', 'fsdp_plan',
         'resolve_schedule', 'PpPlan', 'pp_plan', 'MoePlan', 'moe_plan',
         'DecodeTpPlan', 'decode_tp_plan', 'schedule_applicable',
         'scheduled_ffn', 'scheduled_swiglu'}


def _examples():
    """Every Python file of the example twins."""
    return sorted(path for twin in TWINS
                  for path in (EXAMPLES / twin).rglob('*.py'))


def _scripts():
    """The twins' scripts (their top-level files), run by path."""
    return sorted(path for twin in TWINS
                  for path in (EXAMPLES / twin).glob('*.py'))


def _import_script(blocked: bool) -> str:
    """A script importing every module of the port, every inner module
    of the twins and every twin script, then printing the forbidden
    modules loaded; ``blocked`` makes every forbidden import fail first,
    as on a machine without JAX."""
    names = [name for _, name in _modules()]
    scripts = [str(path) for path in _scripts()]
    block = ('import importlib.abc\n'
             'class Absent(importlib.abc.MetaPathFinder):\n'
             '    def find_spec(self, name, path=None, target=None):\n'
             f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
             "            raise ImportError(f'{name} is absent')\n"
             'sys.meta_path.insert(0, Absent())\n') if blocked else ''
    return ('import importlib, importlib.util, sys\n' + block
            + f"sys.path.insert(0, {str(EXAMPLES / 'tinysys_torch')!r})\n"
            f'for name in {names + list(INNER)!r}:\n'
            '    importlib.import_module(name)\n'
            f'for index, path in enumerate({scripts!r}):\n'
            "    spec = importlib.util.spec_from_file_location("
            "f'example{index}', path)\n"
            '    spec.loader.exec_module('
            'importlib.util.module_from_spec(spec))\n'
            f'print(sorted(m for m in sys.modules '
            f"if m.split('.')[0] in {FORBIDDEN!r}))\n")


def test_importing_every_module_loads_no_jax():
    assert len(_scripts()) == 7          # 4 verybasic, 2 tinysys, 1 lm
    result = subprocess.run([sys.executable, '-c', _import_script(False)],
                            cwd=PACKAGE.parent, capture_output=True,
                            text=True, timeout=120, check=True)
    assert result.stdout.strip() == '[]', result.stdout


def test_every_module_imports_with_jax_absent():
    """With every JAX and reference import refused, the port, the
    observability slice, the one-device mesh and the example twins still
    import."""
    result = subprocess.run([sys.executable, '-c', _import_script(True)],
                            cwd=PACKAGE.parent, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.strip() == '[]', result.stdout


def _forbidden(path: pathlib.Path) -> list[str]:
    """The JAX or reference modules ``path`` imports, at any depth of the
    file (lazy imports inside functions too)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        found += [name for name in names if name.split('.')[0] in FORBIDDEN]
    return found


def test_no_module_imports_jax_or_the_reference():
    found = [(path.name, name)
             for path in [path for path, _ in _modules()] + _examples()
             for name in _forbidden(path)]
    assert found == []


@pytest.mark.parametrize('source', [
    'import jax\n', 'from tpusystem.parallel import elastic\n',
    'def lazy():\n    from tpusystem.orchestrator import gang\n',
    'import flax.linen as nn\n'])
def test_the_scan_catches_a_module_that_imports_jax_or_the_reference(
        tmp_path, source):
    path = tmp_path / 'planted.py'
    path.write_text('import torch\n' + source)
    assert _forbidden(path)


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bwd_phases.py',
                                    'grouped_ab.py', 'decode_lookup_ab.py',
                                    'serve_ab.py', 'resnet_layout_ab.py'])
def test_card_scripts_import_no_jax_or_the_reference(script):
    """The scripts run on the card's machine, which has no JAX: at the top
    of the repository, they import the port and nothing of JAX or the
    reference package, at any depth of the file."""
    assert _forbidden(PACKAGE.parent / script) == []


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    module = gpt2_tiny(dtype='float32', device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(module, None, rows=1, block_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(module, None, [[1, 2, 3]], steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet_tiny()
    assert Engine(module, None, rows=1, block_size=8,
                  device='cpu').device.type == 'cpu'


def test_auto_decode_impl_picks_the_module_path_off_the_card():
    module = gpt2_tiny(device='cpu')                         # bfloat16
    assert Engine(module, None, rows=1, block_size=8,
                  device='cpu').decode_impl == 'flax'
    assert Engine(module, None, rows=1, block_size=8, device='cpu',
                  decode_impl='fused').decode_impl == 'fused'


def test_the_scans_cover_the_control_plane():
    scanned = {name for _, name in _modules()}
    assert {f'tpusystem_torch.{name}' for name in CONTROL_PLANE} <= scanned


def test_the_scans_cover_the_multi_process_slice():
    """The multi-process control plane, elastic membership, the
    orchestrator and the ResNet are scanned and imported like every
    module."""
    scanned = {name for _, name in _modules()}
    assert {f'tpusystem_torch.{name}' for name in MULTI_PROCESS} <= scanned


def test_the_scans_cover_collectives_and_data_parallelism():
    """The collectives, the meshes over ranks, the sharding policies and
    the device plane are scanned and imported like every module, and
    ``tpusystem_torch.parallel`` offers every name of the reference's but
    those of later sub-items."""
    import tpusystem.parallel as reference

    import tpusystem_torch.parallel as port
    scanned = {name for _, name in _modules()}
    assert {f'tpusystem_torch.{name}' for name in DATA_PARALLEL} <= scanned
    missing = {name for name in reference.__all__ if not hasattr(port, name)}
    assert missing == LATER
    assert all(hasattr(port, name) for name in port.__all__)


def test_the_scans_cover_observability_and_the_example_twins():
    scanned = {name for _, name in _modules()}
    assert {f'tpusystem_torch.{name}' for name in OBSERVE} <= scanned
    files = {path.relative_to(EXAMPLES).as_posix() for path in _examples()}
    assert {'tinysys_torch/main.py', 'tinysys_torch/analysis.py',
            'tinysys_torch/tinysys_torch/classifier.py',
            'tinysys_torch/tinysys_torch/services/training.py',
            'lm_torch/main.py'} <= files


def test_serve_exports_the_references_names_but_the_mesh_ones():
    """``tpusystem_torch.serve`` offers the reference's names in its order,
    less the mesh-only ones."""
    import tpusystem.serve as reference

    import tpusystem_torch.serve as port
    assert port.__all__ == [name for name in reference.__all__
                            if name not in MESH_ONLY]
    assert all(hasattr(port, name) for name in port.__all__)
    assert all(hasattr(reference, name) for name in MESH_ONLY)
