"""Where the port runs: an NVIDIA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'float16': torch.float16}


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card.

    Raises ``RuntimeError`` for ``None`` where no CUDA device exists, so a
    run meant for the card never drifts onto the CPU unnoticed."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: tpusystem_torch runs on an NVIDIA card by '
                "default; pass device='cpu' to run on the CPU")
        return torch.device('cuda')
    return torch.device(device)


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a model's ``dtype`` field ('bfloat16', ...)."""
    if name not in DTYPES:
        raise ValueError(f'unknown dtype {name!r}; expected one of '
                         f'{tuple(DTYPES)}')
    return DTYPES[name]
