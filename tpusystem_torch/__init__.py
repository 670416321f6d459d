"""tpusystem_torch — the PyTorch/CUDA port of tpusystem for NVIDIA Hopper.

A second package beside the JAX reference: the same module paths, PyTorch
idiom inside, and every Pallas TPU kernel on a ported path rewritten by hand
for the H100 (``ops/cuda``). It imports neither JAX nor the reference. Entry
points run on the CUDA card unless the caller passes ``device='cpu'``.

The host layers are the reference's: aggregates (each an ``nn.Module``) with
domain events, ``Depends`` injection, the ``Compiler`` pipeline, services
and buses, and a one-process ``Runtime``.
"""

from tpusystem_torch.compiler import Compiler
from tpusystem_torch.depends import Depends, Provider
from tpusystem_torch.device import resolve_device
from tpusystem_torch.domain import Aggregate, Event, Events
from tpusystem_torch.runtime import Runtime

__version__ = '0.1.0'

__all__ = ['Aggregate', 'Compiler', 'Depends', 'Provider', 'Event', 'Events',
           'Runtime', 'resolve_device']
