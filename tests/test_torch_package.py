"""Package rules of the port: no JAX inside, the card by default."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import tpusystem_torch
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.serve import Engine
from tpusystem_torch.train import generate

PACKAGE = pathlib.Path(tpusystem_torch.__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpusystem')


def _modules():
    for path in sorted(PACKAGE.rglob('*.py')):
        relative = path.relative_to(PACKAGE.parent).with_suffix('')
        parts = relative.parts[:-1] if relative.name == '__init__' \
            else relative.parts
        yield path, '.'.join(parts)


def test_importing_every_module_loads_no_jax():
    names = [name for _, name in _modules()]
    script = ('import importlib, sys\n'
              f'for name in {names!r}:\n'
              '    importlib.import_module(name)\n'
              f'print(sorted(m for m in sys.modules '
              f"if m.split('.')[0] in {FORBIDDEN!r}))\n")
    result = subprocess.run([sys.executable, '-c', script],
                            cwd=PACKAGE.parent, capture_output=True,
                            text=True, timeout=120, check=True)
    assert result.stdout.strip() == '[]', result.stdout


def test_no_module_imports_jax_or_the_reference():
    found = []
    for path, _ in _modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            found += [(path.name, name) for name in names
                      if name.split('.')[0] in FORBIDDEN]
    assert found == []


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    module = gpt2_tiny(dtype='float32', device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(module, None, rows=1, block_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(module, None, [[1, 2, 3]], steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2_tiny()
    assert Engine(module, None, rows=1, block_size=8,
                  device='cpu').device.type == 'cpu'


def test_auto_decode_impl_picks_the_module_path_off_the_card():
    module = gpt2_tiny(device='cpu')                         # bfloat16
    assert Engine(module, None, rows=1, block_size=8,
                  device='cpu').decode_impl == 'flax'
    assert Engine(module, None, rows=1, block_size=8, device='cpu',
                  decode_impl='fused').decode_impl == 'fused'
