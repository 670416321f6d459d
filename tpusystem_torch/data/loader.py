"""Device-feeding data pipeline: the port of :mod:`tpusystem.data.loader`.

The :class:`Loader` prepares batches on a background prefetch thread: the
``dataset[span]`` gather and the host-to-device copy both run off the
training thread, keeping up to ``prefetch`` batches in flight, so batch
*N+1*'s host work and transfer overlap batch *N*'s compute. On the card each
leaf is copied from pinned host memory with ``non_blocking=True`` on the
thread's current stream, which the training thread's kernels follow in
order.

The batch order of an epoch and the ``state()``/``seek()`` cursors are the
reference's, bitwise. The reference's native gather (``data/native``) is
bit-identical to numpy fancy indexing by its own contract; the port uses
numpy. A ``sharding`` (a mesh placement,
:func:`~tpusystem_torch.parallel.batch_sharding`) keeps this rank's rows of
each global batch: every rank draws the same global permutation, so its
rows are bit for bit those the reference's device at the same mesh
coordinate holds.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator

import numpy as np
import torch

from tpusystem_torch.device import resolve_device
from tpusystem_torch.parallel.mesh import Placement
from tpusystem_torch.registry import register


class ArrayDataset:
    """In-memory dataset over parallel arrays (inputs, targets, ...)."""

    def __init__(self, *arrays: np.ndarray):
        lengths = {len(array) for array in arrays}
        if len(lengths) != 1:
            raise ValueError('all arrays must share the leading dimension')
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, index) -> tuple:
        return tuple(array[index] for array in self.arrays)


class _PrefetchError:
    """Carries a prefetch-thread exception across the queue so it re-raises
    on the consuming thread."""

    def __init__(self, error: BaseException):
        self.error = error


def _tree_map(fn, tree):
    """``fn`` over the leaves of a pytree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return fn(tree)


class Loader:
    """Batched, shuffled, prefetching iterator over an array dataset.

    Args:
        dataset: :class:`ArrayDataset` or any object with ``__len__`` and a
            numpy fancy-indexing ``__getitem__``. Batches may be any pytree
            of arrays sharing the leading batch dimension (tuples, dicts of
            arrays with ragged multi-hot sparse fields, nested mixes): the
            prefetch thread and the cursors are structure-agnostic.
        batch_size: per-iteration batch size.
        shuffle: reshuffle each epoch with a per-epoch derived seed.
        seed: base shuffle seed (captured in identity).
        drop_remainder: drop the trailing partial batch.
        sharding: a mesh placement
            (:class:`~tpusystem_torch.parallel.mesh.Placement`, e.g.
            ``batch_sharding(mesh)``): each batch leaf becomes this rank's
            piece of it (its rows), on the mesh's device.
        prefetch: number of batches kept in flight ahead of consumption.
        device: where batches land, the card unless ``'cpu'`` is asked for.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = True,
                 sharding=None, prefetch: int = 2, device=None):
        if sharding is not None and not isinstance(sharding, Placement):
            raise TypeError(f'Loader(sharding=) takes a mesh Placement '
                            f'(batch_sharding(mesh)), not {sharding!r}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.sharding = sharding
        self.prefetch = prefetch
        self.device = (sharding.device if sharding is not None
                       and device is None else resolve_device(device))
        self._epoch = 0
        self._skip = 0
        self._position = {'epoch': 0, 'batch': 0}

    def __len__(self) -> int:
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_remainder else (n + b - 1) // b

    def state(self) -> dict:
        """Resume cursor: the position of the **next batch to be yielded**.

        ``{'epoch': e, 'batch': b}`` means batch ``b`` of epoch ``e`` has not
        been consumed yet. The cursor advances as batches are yielded (not
        as the prefetch thread produces them), so a checkpoint taken after
        step N records exactly the data step N+1 should start from."""
        return dict(self._position)

    def seek(self, cursor: dict) -> 'Loader':
        """Position the next ``__iter__`` at ``cursor`` (from :meth:`state`).

        The batch order of an epoch is a pure function of ``(seed, epoch)``,
        so a fresh process seeking a saved cursor regenerates the identical
        permutation and skips the consumed batches. A cursor at or past the
        epoch end normalizes to the next epoch."""
        epoch, batch = int(cursor['epoch']), int(cursor['batch'])
        if batch < 0:
            raise ValueError(f'cursor batch must be >= 0, got {batch}')
        batches = len(self)
        if batches and batch >= batches:
            epoch, batch = epoch + batch // batches, batch % batches
        self._epoch = epoch
        self._skip = batch
        self._position = {'epoch': epoch, 'batch': batch}
        return self

    def _order(self, epoch: int | None = None) -> np.ndarray:
        """Epoch's batch order, a pure function of ``(seed, epoch)``."""
        epoch = self._epoch if epoch is None else epoch
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(indices)
        return indices

    def _leaf(self, array) -> torch.Tensor:
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == 'cpu':
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _place(self, batch):
        """Device-place a batch pytree leaf by leaf: pinned host memory and
        an asynchronous copy on the card, the arrays as tensors on the
        CPU; with a ``sharding``, each leaf cut to this rank's piece
        first."""
        if self.sharding is not None:
            slices = self.sharding.slices
            batch = _tree_map(lambda array: array[slices(array.shape)],
                              batch)
        return _tree_map(self._leaf, batch)

    def __iter__(self) -> Iterator:
        """Yield device-placed batch pytrees, prepared by a background
        thread that keeps at most ``prefetch`` batches queued and shuts down
        cleanly when the generator is closed early."""
        epoch = self._epoch
        skip = self._skip
        self._skip = 0
        self._epoch += 1
        order = self._order(epoch)
        spans = [order[start:start + self.batch_size]
                 for start in range(0, len(order), self.batch_size)]
        if self.drop_remainder and spans and len(spans[-1]) < self.batch_size:
            spans.pop()
        self._position = {'epoch': epoch, 'batch': skip}
        spans = spans[skip:]          # seek(): already-consumed batches
        if not spans:
            self._position = {'epoch': epoch + 1, 'batch': 0}
            return
        buffer: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        done = object()          # sentinel: producer finished cleanly

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    buffer.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for span in spans:
                    if stop.is_set():
                        return
                    if not offer(self._place(self.dataset[span])):
                        return
                offer(done)
            except BaseException as error:    # re-raised on the consumer
                offer(_PrefetchError(error))

        thread = threading.Thread(target=produce, daemon=True,
                                  name='loader-prefetch')
        thread.start()
        try:
            consumed = skip
            while True:
                item = buffer.get()
                if item is done:
                    self._position = {'epoch': epoch + 1, 'batch': 0}
                    break
                if isinstance(item, _PrefetchError):
                    raise item.error
                # advance BEFORE yielding: state() must already name the
                # batch after this one while the consumer holds it
                consumed += 1
                self._position = {'epoch': epoch, 'batch': consumed}
                yield item
        finally:
            stop.set()
            # drain so a producer blocked on a full queue sees the flag
            while thread.is_alive():
                try:
                    buffer.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)


register(Loader, excluded_args=[0], excluded_kwargs={'dataset', 'device'})
