"""Sharding policies in one-device form: the port of
:mod:`tpusystem.parallel.sharding`'s :func:`FullyShardedDataParallel`.

On one device a policy has nothing to split: :meth:`ShardingPolicy.place`
puts a tree (a :class:`~tpusystem_torch.train.TrainState` included) on the
mesh's device. Meshes over more than one device, and with them scattered
parameters and tensor-parallel rules, are ROADMAP queue 1, 9. Multi-GPU
parallelism (:class:`~tpusystem_torch.parallel.MeshSpec` refuses them).
"""

from __future__ import annotations

from typing import Any

from tpusystem_torch.parallel.mesh import Mesh, Placement

__all__ = ['ShardingPolicy', 'FullyShardedDataParallel']


class ShardingPolicy:
    """A sharding strategy; on one device, a placement on the mesh's
    device. ``fsdp`` and ``fsdp_min_size`` are the reference's fields (the
    ``fsdp`` axis has size 1 here)."""

    def __init__(self, fsdp: bool = False, fsdp_min_size: int = 4096):
        self.fsdp = fsdp
        self.fsdp_min_size = fsdp_min_size

    def place(self, tree: Any, mesh: Mesh) -> Any:
        """``tree`` on the mesh's device (:class:`~tpusystem_torch.parallel.
        mesh.Placement`: a ``TrainState`` moves in place)."""
        return Placement(mesh)(tree)


def FullyShardedDataParallel(min_size: int = 4096) -> ShardingPolicy:
    """ZeRO-3 equivalent: parameters and optimizer slots scattered over the
    ``fsdp`` axis (of size 1 on one device)."""
    return ShardingPolicy(fsdp=True, fsdp_min_size=min_size)
