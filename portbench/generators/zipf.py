"""Truncated Zipf draws on a device: id ``k`` (from 0) with probability
proportional to ``(k + 1) ** -alpha`` over ``[0, count)``, the distribution
of ``SyntheticClicks`` in the program's data module, drawn by inverting the
float64 distribution function."""

from __future__ import annotations

import torch


def cdf(count: int, alpha: float, device) -> torch.Tensor:
    ranks = torch.arange(1, count + 1, dtype=torch.float64, device=device)
    weights = ranks.pow_(-alpha)
    total = weights.cumsum_(0)
    return total.div_(total[-1].clone())


def draw(count: int, alpha: float, size, generator) -> torch.Tensor:
    """int64 ids of shape ``size``."""
    device = generator.device
    table = cdf(count, alpha, device)
    uniform = torch.rand(size, dtype=torch.float64, generator=generator,
                         device=device)
    return torch.searchsorted(table, uniform).clamp_(max=count - 1)
