"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, which :mod:`ctypes` loads. No source includes PyTorch's
headers, so a build takes seconds, not minutes. The sources compile in
parallel, one ``nvcc`` each, at the first call that needs a kernel, once per
process. The libraries land in ``build/`` beside this file (ignored by git),
named by a digest of the sources and flags, so a stale library is never
loaded and a later process reuses a finished one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD = pathlib.Path(__file__).resolve().parent / 'build'
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    ``PATH``, else the toolkit's default location."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        home = pathlib.Path(os.environ['CUDA_HOME'])
        candidates.append(home / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path('/usr/local/cuda/bin/nvcc'))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the '
                       'CUDA toolkit is installed (set CUDA_HOME)')


def _digest(flags: tuple[str, ...]) -> str:
    digest = hashlib.sha256(' '.join(flags).encode())
    for path in sorted(CSRC.glob('*.cu*')):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


class KernelLibraries:
    """The compiled kernel libraries of one process, built on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._libraries: dict[str, ctypes.CDLL] = {}
        self.compiler_output: dict[str, str] = {}

    def build(self) -> dict[str, ctypes.CDLL]:
        """Compile every source (in parallel) and load the libraries. Each
        compiler's output (ptxas' registers, shared memory and spills per
        kernel) is kept in :attr:`compiler_output`. Raises ``RuntimeError``
        with the compiler's message when a source does not build."""
        with self._lock:
            if self._libraries:
                return self._libraries
            tag = _digest(FLAGS)
            BUILD.mkdir(parents=True, exist_ok=True)
            compiler = nvcc()
            jobs = {}
            for source in sorted(CSRC.glob('*.cu')):
                target = BUILD / f'{source.stem}-{tag}.so'
                if target.exists():
                    jobs[source.stem] = (target, None, None)
                    continue
                partial = target.with_suffix(f'.{os.getpid()}.tmp')
                process = subprocess.Popen(
                    [compiler, *FLAGS, '-o', str(partial), str(source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs[source.stem] = (target, partial, process)
            failures = []
            for name, (target, partial, process) in jobs.items():
                if process is None:
                    continue
                output, _ = process.communicate()
                self.compiler_output[name] = output
                if process.returncode != 0:
                    failures.append(f'{name}.cu:\n{output}')
                    continue
                os.replace(partial, target)
            if failures:
                raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
            self._libraries = {name: ctypes.CDLL(str(target))
                               for name, (target, _, _) in jobs.items()}
            return self._libraries

    def library(self, name: str) -> ctypes.CDLL:
        """The loaded library built from ``csrc/<name>.cu``."""
        return self.build()[name]


LIBRARIES = KernelLibraries()
