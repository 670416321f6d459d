"""Data pipeline of the port: the prefetching :class:`Loader` and the
datasets it feeds from."""

from tpusystem_torch.data.datasets import SyntheticClicks
from tpusystem_torch.data.loader import ArrayDataset, Loader

__all__ = ['ArrayDataset', 'Loader', 'SyntheticClicks']
