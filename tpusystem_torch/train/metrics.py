"""Metric accumulators: the port of :mod:`tpusystem.train.metrics`.

``update`` adds a batch's values on their own device without waiting for
it; ``compute`` reads the sums back once per phase. The sums are float32
(``Mean``) or integer counts, and ``compute`` divides as the reference does
on the host, so equal inputs give equal results.
"""

from __future__ import annotations

import math
from typing import Protocol

import torch


class Metric(Protocol):
    def update(self, *args, **kwargs) -> None: ...
    def compute(self) -> float: ...
    def reset(self) -> None: ...


def _on(value: torch.Tensor, device) -> torch.Tensor:
    return value if value.device == device else value.to(device)


class Mean:
    """Weighted running mean of scalar or array values (loss, grad-norm...)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._total = torch.zeros((), dtype=torch.float32)
        self._count = torch.zeros((), dtype=torch.float32)

    def update(self, values, weight: float = 1.0) -> None:
        values = torch.as_tensor(values, dtype=torch.float32)
        total, count = (_on(t, values.device)
                        for t in (self._total, self._count))
        self._total = total + values.sum() * weight
        self._count = count + values.numel() * weight

    def compute(self) -> float:
        total, count = self._total.cpu(), self._count.cpu()
        return float(total / count) if count else 0.0


class Accuracy:
    """Multiclass accuracy from integer predictions vs targets."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._correct = torch.zeros((), dtype=torch.int64)
        self._count = 0

    def update(self, predictions, targets) -> None:
        correct = _on(self._correct, targets.device)
        self._correct = correct + (predictions == targets).sum()
        self._count += targets.numel()

    def compute(self) -> float:
        correct = int(self._correct)
        return correct / self._count if self._count else 0.0


def _top_k_indices(logits, k: int):
    """The k largest logits' indices per row, ties to the lower index
    (``jax.lax.top_k``'s order): a stable descending sort."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]


class TopKAccuracy:
    """Top-k accuracy from logits vs integer targets."""

    def __init__(self, k: int = 5) -> None:
        self.k = k
        self.reset()

    def reset(self) -> None:
        self._hits = torch.zeros((), dtype=torch.int64)
        self._count = 0

    def update(self, logits, targets) -> None:
        top = _top_k_indices(logits, self.k)
        match = (top == targets[..., None]).any(-1)
        self._hits = _on(self._hits, targets.device) + match.sum()
        self._count += targets.numel()

    def compute(self) -> float:
        hits = int(self._hits)
        return hits / self._count if self._count else 0.0


class Perplexity:
    """exp(mean token cross-entropy) for language models."""

    def __init__(self) -> None:
        self._mean = Mean()

    def reset(self) -> None:
        self._mean.reset()

    def update(self, token_losses, weight: float = 1.0) -> None:
        self._mean.update(token_losses, weight)

    def compute(self) -> float:
        return math.exp(min(self._mean.compute(), 80.0))
