"""Checkpoints: the port of :mod:`tpusystem.checkpoint`. The
:class:`Checkpointer` keeps the reference's commit contract on a torch
store (async commits, verify and the torn-step fallback, the fence, the
extras sidecar, GC), restoring into the target's tensors in place; the
:class:`Repository` stores an aggregate's state by identity; the memstore
keeps hot state in the supervisor's RAM (:func:`hot_resume`)."""

from tpusystem_torch.checkpoint.checkpointer import Checkpointer, abstract_like
from tpusystem_torch.checkpoint.memstore import (HotState, MemStore,
                                                 MemStoreClient,
                                                 MemStoreServer, ShardedLeaf,
                                                 blob_digest,
                                                 deserialize_state,
                                                 hot_resume, merge_hot,
                                                 pack_hot, serialize_state,
                                                 supervisor_client,
                                                 unpack_hot)
from tpusystem_torch.checkpoint.repository import Repository

__all__ = ['Checkpointer', 'Repository', 'abstract_like',
           'MemStore', 'MemStoreServer', 'MemStoreClient', 'HotState',
           'ShardedLeaf', 'serialize_state', 'deserialize_state',
           'hot_resume', 'merge_hot', 'supervisor_client', 'blob_digest',
           'pack_hot', 'unpack_hot']
