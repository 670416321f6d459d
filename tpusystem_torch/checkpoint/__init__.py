"""Checkpoints: the port of :mod:`tpusystem.checkpoint`, as far as the
in-process :class:`MemStore` goes. The ``Checkpointer``, the ``Repository``
and the rest of the memstore are ROADMAP queue 1 item 8."""

from tpusystem_torch.checkpoint.memstore import (HotState, MemStore,
                                                 blob_digest, pack_hot,
                                                 unpack_hot)

__all__ = ['MemStore', 'HotState', 'blob_digest', 'pack_hot', 'unpack_hot']
