"""Built-in datasets: the port of :mod:`tpusystem.data.datasets`.

:class:`SyntheticDigits`, :class:`SyntheticTokens` and
:class:`SyntheticClicks` are copied as they are (numpy only), so their
arrays are bitwise the reference's for any arguments. :class:`MemmapTokens`
gathers a batch's windows through the native window gather
(:mod:`tpusystem_torch.data.native`), as the reference's does;
:class:`TorchDataset` is copied.
"""

from __future__ import annotations

import numpy as np

from tpusystem_torch.data.loader import ArrayDataset
from tpusystem_torch.registry import register


@register
class SyntheticDigits(ArrayDataset):
    """MNIST-shaped 28x28 classification set: each class is a Gaussian blob
    around a fixed random prototype, so a small MLP separates it quickly."""

    def __init__(self, samples: int = 4096, classes: int = 10, seed: int = 0,
                 noise: float = 0.35, train: bool = True):
        rng = np.random.default_rng(seed if train else seed + 1)
        prototype_rng = np.random.default_rng(seed)  # shared across splits
        prototypes = prototype_rng.normal(
            size=(classes, 28 * 28)).astype(np.float32)
        labels = rng.integers(0, classes, size=samples)
        images = prototypes[labels] + noise * rng.normal(
            size=(samples, 28 * 28)).astype(np.float32)
        super().__init__(images.reshape(samples, 28, 28).astype(np.float32),
                         labels.astype(np.int32))


@register
class SyntheticTokens(ArrayDataset):
    """Language-model token streams with learnable bigram structure.

    The sparse bigram transition table derives from ``seed`` alone and is
    shared across splits (like :class:`SyntheticDigits` prototypes), so a
    ``train=False`` holdout draws *different sequences from the same
    distribution* — held-out perplexity is meaningful."""

    def __init__(self, samples: int = 1024, sequence_length: int = 128,
                 vocab_size: int = 256, seed: int = 0, train: bool = True):
        table_rng = np.random.default_rng(seed)      # shared across splits
        table = table_rng.integers(0, vocab_size, size=(vocab_size, 4))
        # train continues the table stream (a fresh default_rng(seed) would
        # replay the table draw bit-for-bit into tokens[:, 0]); the holdout
        # seeds off-stream for independent draws from the same table
        rng = table_rng if train else np.random.default_rng(seed + 1)
        tokens = np.empty((samples, sequence_length), dtype=np.int32)
        tokens[:, 0] = rng.integers(0, vocab_size, size=samples)
        choices = rng.integers(0, 4, size=(samples, sequence_length))
        for position in range(1, sequence_length):
            tokens[:, position] = table[tokens[:, position - 1],
                                        choices[:, position]]
        super().__init__(tokens)


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


@register
class MemmapTokens:
    """Pretraining corpus as a flat binary file of token ids.

    The standard LM data layout (one contiguous ``dtype`` array on disk, as
    produced by GPT-2/nanoGPT-style tokenizer scripts): the file is
    memory-mapped, and sample *i* is the ``sequence_length + 1`` window at
    ``i * stride`` (``+1`` so the loss can shift inputs/targets from one
    tensor). Batches gather directly from the page cache via vectorized
    window indexing — no materialized copy of the corpus in RAM.

    Args:
        path: binary file of token ids.
        sequence_length: tokens per sample (the model's ``max_seq``).
        dtype: on-disk integer dtype (``uint16`` fits 64k vocabs and is the
            common choice; tokens come back as int32).
        stride: window step; defaults to ``sequence_length`` (disjoint
            windows — set smaller for overlapping augmentation).
    """

    def __init__(self, path, sequence_length: int = 1024,
                 dtype: str = 'uint16', stride: int | None = None):
        self.path = str(path)
        self.sequence_length = sequence_length
        self.dtype = dtype
        self.stride = stride or sequence_length
        self._tokens = np.memmap(self.path, dtype=np.dtype(dtype), mode='r')
        window = sequence_length + 1
        if len(self._tokens) < window:
            raise ValueError(
                f'{self.path}: {len(self._tokens)} tokens < one window ({window})')
        self._count = (len(self._tokens) - window) // self.stride + 1

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, index) -> tuple:
        window = self.sequence_length + 1
        if isinstance(index, np.ndarray):
            # batched window gather: native per-window memcpy straight from
            # the page cache (multithreaded, GIL released) when the
            # toolchain built batcher.cpp, numpy fancy indexing otherwise —
            # bit-identical either way
            from tpusystem_torch.data import native
            starts = index.astype(np.int64) * self.stride
            rows = native.gather_windows(self._tokens, starts, window)
            return (rows.astype(np.int32),)
        start = int(index) * self.stride
        return (self._tokens[start:start + window].astype(np.int32),)


class TorchDataset(ArrayDataset):
    """Adapter: materialize a (map-style) torch dataset into arrays once,
    so batches feed the device without per-batch torch->numpy conversion."""

    def __init__(self, dataset):
        first = dataset[0]
        columns = len(first) if isinstance(first, (tuple, list)) else 1
        stacked = [[] for _ in range(columns)]
        for item in dataset:
            parts = item if isinstance(item, (tuple, list)) else (item,)
            for column, part in enumerate(parts):
                stacked[column].append(np.asarray(part))
        super().__init__(*[np.stack(column) for column in stacked])
