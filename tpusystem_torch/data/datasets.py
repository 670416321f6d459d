"""Built-in datasets: the port of :mod:`tpusystem.data.datasets`.

:class:`SyntheticClicks` is copied as it is (numpy only), so its arrays are
bitwise the reference's for any arguments. The other datasets of the
reference (``SyntheticDigits``, ``SyntheticTokens``, ``MemmapTokens``,
``TorchDataset``) belong to the verybasic/tinysys slice (ROADMAP queue 1
item 4) and are not ported yet.
"""

from __future__ import annotations

import numpy as np

from tpusystem_torch.registry import register


@register
class SyntheticClicks:
    """Synthetic click log for the recommender workload.

    Every example carries a **pytree** of features plus a label:
    ``({'dense': [d] float32, 'ids': [features, hot] int32}, label)`` —
    multi-hot sparse ids padded with ``-1`` (per-row hotness is drawn
    uniformly in ``[1, hot]``, so the padding pattern is ragged), ids drawn
    from a **truncated Zipf** distribution per feature (exponent ``alpha``;
    rank-1 ids dominate, the tail is long — the duplicate-id regime
    embedding dedup and the gradient scatter-add exist for). Labels come
    from a planted logistic model over per-id weights and the dense slice
    (weights shared across splits), so AUC is learnable and a
    ``train=False`` holdout is meaningful.
    """

    def __init__(self, samples: int = 4096, vocabs: tuple = (64, 32),
                 hot: int = 4, dense: int = 4, seed: int = 0,
                 alpha: float = 1.3, train: bool = True):
        planted_rng = np.random.default_rng(seed)     # shared across splits
        rng = np.random.default_rng(seed + (0 if train else 1))
        features = len(vocabs)
        # planted logistic model: per-id weights + dense weights
        id_weights = [planted_rng.normal(size=vocab).astype(np.float32)
                      / np.sqrt(hot * features)
                      for vocab in vocabs]
        dense_weights = (planted_rng.normal(size=dense).astype(np.float32)
                         / np.sqrt(dense))
        # truncated Zipf pmf per feature (exact, vocab-bounded)
        ids = np.empty((samples, features, hot), np.int32)
        for feature, vocab in enumerate(vocabs):
            pmf = 1.0 / np.arange(1, vocab + 1) ** alpha
            pmf /= pmf.sum()
            ids[:, feature] = rng.choice(vocab, size=(samples, hot), p=pmf)
        hotness = rng.integers(1, hot + 1, size=(samples, features))
        ids[np.arange(hot)[None, None, :] >= hotness[..., None]] = -1
        dense_slice = rng.normal(size=(samples, dense)).astype(np.float32)
        logits = dense_slice @ dense_weights
        for feature in range(features):
            weights = id_weights[feature]
            hot_ids = ids[:, feature]
            logits = logits + np.where(hot_ids >= 0,
                                       weights[np.maximum(hot_ids, 0)],
                                       0.0).sum(axis=-1)
        labels = (rng.uniform(size=samples)
                  < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
        self._dense = dense_slice
        self._ids = ids
        self._labels = labels

    def __len__(self) -> int:
        return len(self._labels)

    def __getitem__(self, index) -> tuple:
        """Pytree batch: ``({'dense': ..., 'ids': ...}, labels)`` — the
        shape :class:`tpusystem_torch.models.DLRM` consumes and the
        :class:`~tpusystem_torch.data.Loader` prefetch thread places leaf by
        leaf."""
        return ({'dense': self._dense[index], 'ids': self._ids[index]},
                self._labels[index])
