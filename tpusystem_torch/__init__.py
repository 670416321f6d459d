"""tpusystem_torch — the PyTorch/CUDA port of tpusystem for NVIDIA Hopper.

A second package beside the JAX reference: the same module paths, PyTorch
idiom inside, and every Pallas TPU kernel on a ported path rewritten by hand
for the H100 (``ops/cuda``). It imports neither JAX nor the reference. Entry
points run on the CUDA card unless the caller passes ``device='cpu'``.
"""

from tpusystem_torch.device import resolve_device

__version__ = '0.1.0'

__all__ = ['resolve_device']
