"""Device meshes: the port of :mod:`tpusystem.parallel.mesh`.

The reference's injected runtime fact is a :class:`jax.sharding.Mesh`
over the chip topology, with every parallelism expressed as a named axis.
The port runs one process a device. Where ``torch.distributed`` has a
default process group (:func:`tpusystem_torch.parallel.multihost.initialize`
starts it: NCCL on the card, gloo on the CPU), :meth:`MeshSpec.build`
lays the group's ranks out row-major over the reference's six axes, in the
reference's order, as a :class:`torch.distributed.device_mesh.DeviceMesh`;
rank ``r`` sits at the coordinate the reference's ``r``-th device takes.
Without a process group a :class:`Mesh` is one device carrying the six
axes at size 1, and a placement is "move to that device".

:class:`MeshSpec` keeps the reference's arithmetic (``resolved_sizes``,
``resized``) and its identity. A mesh whose ``model``, ``seq``,
``expert`` or ``stage`` axis is larger than 1 builds; placing a leaf
sharded over such an axis raises
(:mod:`tpusystem_torch.parallel.sharding`).

======== ========================================================
``data``   pure data parallelism (gradient all-reduce)
``fsdp``   fully-sharded data parallelism (params/opt-state scatter)
``model``  tensor parallelism (weight-matrix column/row split)
``seq``    sequence/context parallelism (ring attention)
``expert`` expert parallelism (MoE all-to-all dispatch)
``stage``  pipeline parallelism (collective-permute between stages)
======== ========================================================
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from tpusystem_torch.device import resolve_device
from tpusystem_torch.registry import register

DATA, FSDP, MODEL, SEQ, EXPERT, STAGE = ('data', 'fsdp', 'model', 'seq',
                                         'expert', 'stage')
AXES = (DATA, FSDP, MODEL, SEQ, EXPERT, STAGE)

__all__ = ['AXES', 'DATA', 'FSDP', 'MODEL', 'SEQ', 'EXPERT', 'STAGE', 'Mesh',
           'MeshSpec', 'PartitionSpec', 'Placement', 'single_device_mesh',
           'batch_sharding', 'stacked_batch_sharding', 'replicated',
           'scan_carry_constraint']


class PartitionSpec(tuple):
    """A leaf's layout, copied from ``jax.sharding.PartitionSpec``: one
    entry per leading dimension, each ``None`` (whole), an axis name or a
    tuple of axis names (split over their product, the first major);
    trailing dimensions left out are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f'PartitionSpec{tuple.__repr__(self)}'


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry (``None`` → none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Mesh:
    """The reference's six named axes over this job's devices: ``shape``
    maps each axis to its size, as a jax mesh's does.

    Over a process group (``device_mesh`` given) each rank holds one
    device; ``ranks`` is the ``[data, fsdp, model, seq, expert, stage]``
    array of global ranks (the reference's ``mesh.devices``),
    ``coordinate`` this rank's place in it (None on a rank outside the
    mesh), and :meth:`group` the process group along some axes; the groups
    the step and the checksums use are made when the mesh is. Without one,
    the mesh is one device and every axis has size 1.
    """

    def __init__(self, device: torch.device, device_mesh: Any = None,
                 sizes: dict | None = None, ranks=None) -> None:
        self.device = torch.device(device)
        self.axis_names = AXES
        self.device_mesh = device_mesh
        self.shape = {axis: (sizes or {}).get(axis, 1) for axis in AXES}
        layout = tuple(self.shape.values())
        self.ranks = (np.arange(math.prod(layout)) if ranks is None
                      else np.asarray(ranks)).reshape(layout)
        self.rank = (torch.distributed.get_rank()
                     if device_mesh is not None else 0)
        where = np.argwhere(self.ranks == self.rank)
        self.coordinate = (dict(zip(AXES, (int(index) for index in where[0])))
                           if len(where) else None)
        self._groups: dict = {}
        if device_mesh is not None:     # made now, while every rank is here
            self.group((DATA, FSDP))
            self.group(AXES[1:])

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def distributed(self) -> bool:
        """Whether the mesh runs over a process group."""
        return self.device_mesh is not None

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or names)."""
        return math.prod(self.shape[axis] for axis in spec_axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, the first one major."""
        index = 0
        for axis in spec_axes(axes):
            index = index * self.shape[axis] + self.coordinate[axis]
        return index

    def group(self, axes):
        """The process group of the ranks that share this rank's coordinate
        on every axis but ``axes`` (a name or a tuple of names), whose
        group rank is :meth:`axis_index`. Every rank must ask for the same
        axes in the same order (a new group is collective); ``None`` on a
        one-device mesh."""
        if self.device_mesh is None:
            return None
        axes = spec_axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            order = [AXES.index(axis) for axis in axes]
            others = [index for index in range(len(AXES))
                      if index not in order]
            blocks = self.ranks.transpose(others + order).reshape(
                -1, self.axis_size(axes))
            mine = None
            for block in blocks:      # every rank makes every group
                group = torch.distributed.new_group(
                    sorted(int(rank) for rank in block))
                if self.rank in block:
                    mine = group
            self._groups[axes] = mine
        return self._groups[axes]

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coordinate is not None

    def __repr__(self) -> str:
        if self.device_mesh is None:
            return f'Mesh({self.device})'
        return f'Mesh({self.shape}, rank {self.rank} on {self.device})'


def local_slices(shape: Sequence[int], spec: Sequence, mesh: Mesh) -> tuple:
    """The slice of a ``shape`` array that ``mesh``'s rank holds under
    ``spec``: each dimension splits evenly over the product of its axes,
    the first axis major (``ValueError`` when a size does not divide)."""
    slices = []
    for dim, size in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        parts = mesh.axis_size(axes)
        if size % parts:
            raise ValueError(f'dimension {dim} of size {size} does not '
                             f'split over {axes} ({parts} parts)')
        chunk = size // parts
        start = mesh.axis_index(axes) * chunk
        slices.append(slice(start, start + chunk))
    return tuple(slices)


def _tensor(leaf, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf)).to(device)
    return leaf.to(device)


class Placement:
    """Where a tree of tensors goes on a :class:`Mesh` (the counterpart of
    a ``NamedSharding``). Calling it takes every tensor (or numpy array) of
    a tree of dicts, tuples and lists to this rank's piece under ``spec``,
    as a plain tensor on the mesh's device: a global batch becomes this
    rank's rows. A tensor already whole on the device is returned as it
    is. A :class:`~tpusystem_torch.train.TrainState` is placed in place and
    returned: moved to the device on a one-device mesh (parameters already
    there stay the module's own), replicated over a mesh of ranks
    (:class:`~tpusystem_torch.parallel.sharding.ShardingPolicy` with no
    rules)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec | None = None) -> None:
        self.mesh = mesh
        self.device = mesh.device
        self.spec = PartitionSpec() if spec is None else spec

    def slices(self, shape: Sequence[int]) -> tuple:
        """The slice of a ``shape`` leaf this rank holds."""
        return local_slices(shape, self.spec, self.mesh)

    def __call__(self, tree: Any) -> Any:
        if hasattr(tree, 'params') and hasattr(tree, 'opt_state'):
            if self.mesh.distributed:
                from tpusystem_torch.parallel.sharding import ShardingPolicy
                return ShardingPolicy().place(tree, self.mesh)
            tree.params = self(tree.params)
            tree.opt_state = self(tree.opt_state)
            tree.step = self(tree.step)
            if tree.health is not None:
                for name, value in tree.health.tensors().items():
                    setattr(tree.health, name, self(value))
            return tree
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            slices = self.slices(tree.shape)
            piece = tree[slices] if any(
                part.stop - part.start != size
                for part, size in zip(slices, tree.shape)) else tree
            return _tensor(piece, self.device)
        if isinstance(tree, dict):
            return {key: self(value) for key, value in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self(value) for value in tree)
        return tree


@register
class MeshSpec:
    """Declarative mesh layout: axis name -> size.

    Size ``-1`` on exactly one axis means "fill with all remaining devices".
    Axes of size 1 are kept (they cost nothing and keep the layout uniform
    across configurations).

    Example::

        initialize(...)                                # the process group
        MeshSpec(data=-1).build()                      # data over every rank
        MeshSpec().build([torch.device('cpu')])        # one device, no group
    """

    def __init__(self, data: int = 1, fsdp: int = 1, model: int = 1,
                 seq: int = 1, expert: int = 1, stage: int = 1):
        self.sizes = {DATA: data, FSDP: fsdp, MODEL: model,
                      SEQ: seq, EXPERT: expert, STAGE: stage}

    def resolved_sizes(self, device_count: int) -> dict[str, int]:
        sizes = dict(self.sizes)
        wildcards = [axis for axis, size in sizes.items() if size == -1]
        if len(wildcards) > 1:
            raise ValueError(f'only one axis may be -1, got {wildcards}')
        fixed = math.prod(size for size in sizes.values() if size != -1)
        if wildcards:
            if device_count % fixed:
                raise ValueError(
                    f'{device_count} devices not divisible by fixed axes {fixed}')
            sizes[wildcards[0]] = device_count // fixed
        elif fixed != device_count:
            raise ValueError(
                f'mesh wants {fixed} devices but {device_count} are available')
        return sizes

    def build(self, devices: Sequence[torch.device] | None = None, *,
              ranks: Sequence[int] | None = None) -> Mesh:
        """The mesh over the default process group's ranks, one device each
        (the device :func:`~tpusystem_torch.parallel.multihost.initialize`
        joined the group for), when ``torch.distributed`` has one and
        ``devices`` is not given; ``ranks`` (ascending) builds it over those
        ranks of the group only (every rank of the group calls ``build``,
        which makes process groups; one outside ``ranks`` gets a mesh it is
        not a :attr:`~Mesh.member` of). Otherwise the one-device mesh over
        ``devices`` (default: this process's card,
        :func:`~tpusystem_torch.device.resolve_device`, which raises where
        there is none). ``ValueError`` when the sizes do not fit the
        ranks, or when ``devices`` names more than one device (a mesh of
        many devices runs one process a device, over a process group)."""
        dist = torch.distributed
        if devices is None and dist.is_available() and dist.is_initialized():
            return self._over_group(ranks)
        devices = list(devices) if devices is not None else [
            resolve_device()]
        if len(devices) > 1:
            raise ValueError(
                f'a mesh over {len(devices)} devices runs one process a '
                f'device over a torch.distributed process group: start it '
                f'with tpusystem_torch.parallel.multihost.initialize and '
                f'build without devices')
        self.resolved_sizes(len(devices))
        return Mesh(devices[0])

    def _over_group(self, ranks: Sequence[int] | None) -> Mesh:
        from torch.distributed.device_mesh import DeviceMesh

        from tpusystem_torch.parallel.multihost import device_plane
        dist = torch.distributed
        ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
        if ranks != sorted(set(ranks)):
            raise ValueError(f'mesh ranks must ascend, got {ranks}')
        sizes = self.resolved_sizes(len(ranks))
        device = device_plane()
        if device is None:
            raise ValueError('a mesh of ranks runs over the device plane '
                             'that tpusystem_torch.parallel.multihost.'
                             'initialize joined (it names the device)')
        layout = torch.tensor(ranks).reshape(
            tuple(sizes[axis] for axis in AXES))
        return Mesh(device, DeviceMesh(device.type, layout,
                                       mesh_dim_names=AXES), sizes, ranks)

    def resized(self, device_count: int) -> 'MeshSpec':
        """The same layout policy scaled to a new device count (the mesh
        derivation of an elastic resize): a wildcard spec re-fills; a
        pinned one scales ``data``, else ``fsdp``. Raises ``ValueError``
        when neither divides the new count."""
        sizes = dict(self.sizes)
        if any(size == -1 for size in sizes.values()):
            spec = MeshSpec(**sizes)
            spec.resolved_sizes(device_count)     # validate divisibility now
            return spec
        for axis in (DATA, FSDP):
            fixed = math.prod(size for name, size in sizes.items()
                              if name != axis)
            if device_count % fixed == 0:
                return MeshSpec(**{**sizes, axis: device_count // fixed})
        raise ValueError(
            f'cannot rescale mesh {sizes} to {device_count} devices: '
            f'neither the data nor the fsdp axis divides the new count')


def single_device_mesh(device: torch.device | str | None = None) -> Mesh:
    """A 1x1x1x1x1x1 mesh over one device (default: the card)."""
    return MeshSpec().build([resolve_device(device)])


def batch_sharding(mesh: Mesh) -> Placement:
    """Canonical global-batch placement: the batch dimension splits over
    the combined ``(data, fsdp)`` axes, so each rank keeps its rows."""
    return Placement(mesh, PartitionSpec((DATA, FSDP)))


def scan_carry_constraint(mesh: Mesh | None):
    """The reference's pin of a scan-over-layers carry in the TP x FSDP
    composition (``mesh.py:260``): the identity unless the mesh has both an
    ``fsdp`` and a ``model`` axis larger than 1, which is tensor
    parallelism (ROADMAP queue 1: 9c. Tensor parallelism)."""
    if mesh is None or mesh.shape.get(FSDP, 1) < 2 or \
            mesh.shape.get(MODEL, 1) < 2:
        return lambda hidden: hidden
    raise NotImplementedError(
        'the scan carry over an fsdp x model mesh is not ported to '
        'tpusystem_torch yet (ROADMAP queue 1: 9c. Tensor parallelism)')


def stacked_batch_sharding(mesh: Mesh) -> Placement:
    """Placement of ``[steps, batch, ...]`` stacks (the
    :func:`tpusystem_torch.train.build_multi_step` input): the steps axis
    stays whole, the batch axis (dim 1) splits as :func:`batch_sharding`'s."""
    return Placement(mesh, PartitionSpec(None, (DATA, FSDP)))


def replicated(mesh: Mesh) -> Placement:
    """Every rank holds the whole tree."""
    return Placement(mesh, PartitionSpec())
