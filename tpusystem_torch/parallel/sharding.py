"""Sharding policies: the port of :mod:`tpusystem.parallel.sharding`.

A policy maps every leaf of a state tree to a
:class:`~tpusystem_torch.parallel.mesh.PartitionSpec`, by the reference's
logic, copied:

1. **regex rules** (tensor parallelism): the first pattern that matches
   the leaf's ``/``-joined path wins; a model ships its own
   (``GPT2.partition_rules``). Optimizer slots (``opt_state/mu/...``) end
   with their parameter's path, so one rule set covers both.
2. **FSDP inference** (shape-based): a leaf still owning an unsharded
   dimension that the ``fsdp`` axis divides gets its largest such dimension
   sharded (ties: the lowest index, :func:`fsdp_shard_dim`).

:meth:`ShardingPolicy.place` turns each leaf into a
:class:`torch.distributed.tensor.DTensor` over the mesh's
``DeviceMesh``, ``Shard(d)`` on each mesh axis the spec splits dimension
``d`` over and ``Replicate()`` on the others; each rank holds its slice,
cut from the whole leaf it was given. The port's step
(:func:`tpusystem_torch.train.build_train_step`) runs on such a state by
gathering the FSDP-sharded leaves before the forward. Placing a leaf split
over a ``model``, ``seq``, ``expert`` or ``stage`` axis of size > 1 raises
with the ROADMAP sub-item that ports it (9c–9f). On a one-device mesh
(no process group) a placement moves the tree to the mesh's device, as
before.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np
import torch

from tpusystem_torch.parallel.mesh import (AXES, EXPERT, FSDP, MODEL, SEQ,
                                           STAGE, Mesh, PartitionSpec,
                                           Placement, local_slices, spec_axes)
from tpusystem_torch.registry import register

__all__ = ['Rules', 'TABLE_AXES', 'PartitionSpec', 'table_row_spec',
           'constrain_table_rows', 'expert_major_spec',
           'constrain_expert_major', 'leaf_path', 'fsdp_shard_dim',
           'ShardingPolicy', 'DataParallel', 'FullyShardedDataParallel',
           'TensorParallel', 'local', 'local_tree', 'gather_leaf',
           'is_placed', 'shard_axes', 'held_slices', 'is_distributed']

Rules = Sequence[tuple[str, PartitionSpec]]

# The embedding-table sharding axes: recommender tables row-shard their
# vocab dimension over the combined (expert, model) axes.
TABLE_AXES = (EXPERT, MODEL)

# the ROADMAP sub-item that ports a placement over each non-data axis
NOT_PORTED = {MODEL: '9c. Tensor parallelism', SEQ: '9e. Sequence '
              'parallelism', EXPERT: '9f. Expert and table parallelism',
              STAGE: '9d. Pipelines'}


def _not_ported(what: str, axis: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} is not ported to tpusystem_torch yet (ROADMAP queue 1: '
        f'{NOT_PORTED[axis]})')


def table_row_spec(rank: int) -> PartitionSpec:
    """Spec for a row-sharded embedding table: the leading (vocab)
    dimension splits over the combined ``expert``/``model`` axes, every
    other dim stays unsharded."""
    return PartitionSpec(TABLE_AXES, *([None] * (rank - 1)))


def constrain_table_rows(value, mesh):
    """Pin a row-sharded table to the ``expert``/``model`` axes: the
    identity off-mesh or when both have size 1; a table split over them is
    ROADMAP 9f."""
    if mesh is None or all(mesh.shape[axis] == 1 for axis in TABLE_AXES):
        return value
    raise _not_ported('constrain_table_rows over a table-sharded mesh',
                      EXPERT)


def expert_major_spec(rank: int) -> PartitionSpec:
    """Spec for expert-major activation buffers: the leading dim carries the
    expert id and shards over the ``expert`` axis."""
    return PartitionSpec(EXPERT, *([None] * (rank - 1)))


def constrain_expert_major(value, mesh):
    """Pin an expert-major buffer to the ``expert`` axis: the identity
    off-mesh or when the axis has size 1; expert parallelism is ROADMAP
    9f."""
    if mesh is None or mesh.shape.get(EXPERT, 1) == 1:
        return value
    raise _not_ported('constrain_expert_major over an expert-sharded mesh',
                      EXPERT)


def leaf_path(key_path) -> str:
    """Render a key path (names, indices, or a state dict's dotted name) as
    ``a/b/0/c`` for regex matching."""
    if isinstance(key_path, str):
        return key_path.replace('.', '/')
    return '/'.join(str(entry).replace('.', '/') for entry in key_path)


def _mesh_axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for name in axis:
            size *= mesh.shape[name]
        return size
    return mesh.shape[axis]


def fsdp_shard_dim(shape: tuple[int, ...], fsdp_size: int,
                   taken: Sequence[int] = ()) -> int | None:
    """Which dimension FSDP inference shards: the **largest** dimension not
    in ``taken`` whose size ``fsdp_size`` divides, ties broken by the
    **lowest index** (the reference pins this: another choice would
    reshard every checkpoint); ``None`` when none qualifies."""
    candidates = [index for index in range(len(shape))
                  if index not in taken and shape[index] % fsdp_size == 0]
    if not candidates:
        return None
    return min(candidates, key=lambda index: (-shape[index], index))


def _leaf_elements(shape: tuple[int, ...]) -> int:
    total = 1
    for size in shape:
        total *= size
    return total


def _with_fsdp(spec: PartitionSpec, shape: tuple[int, ...], mesh: Mesh,
               min_size: int) -> PartitionSpec:
    """Add the fsdp axis to the largest unsharded, divisible dimension
    (ties: lowest index — see :func:`fsdp_shard_dim`)."""
    fsdp_size = mesh.shape[FSDP]
    if fsdp_size == 1:
        return spec
    if _leaf_elements(shape) < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(axis == FSDP or (isinstance(axis, tuple) and FSDP in axis)
           for axis in entries):
        return spec
    taken = [index for index, axis in enumerate(entries) if axis is not None]
    best = fsdp_shard_dim(tuple(shape), fsdp_size, taken)
    if best is None:
        return spec
    entries[best] = FSDP
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def _is_state(tree) -> bool:
    return hasattr(tree, 'params') and hasattr(tree, 'opt_state')


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the tensor (and array) leaves of a tree of
    dicts, tuples and lists; other leaves pass through."""
    if isinstance(tree, dict):
        return {key: _map_with_path(fn, value, path + (str(key),))
                for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, value, path + (str(index),))
                          for index, value in enumerate(tree))
    if isinstance(tree, (torch.Tensor, np.ndarray)) or hasattr(tree, 'shape'):
        return fn(path, tree)
    return tree


def shard_axes(leaf) -> dict[int, tuple]:
    """``{tensor dim: (mesh axes, major first)}`` of a placed leaf's
    ``Shard`` placements (empty for a plain tensor or a replicated one)."""
    placements = getattr(leaf, 'placements', None)
    if placements is None:
        return {}
    out: dict[int, tuple] = {}
    for axis, placement in zip(AXES, placements):
        if placement.is_shard():
            out[placement.dim] = out.get(placement.dim, ()) + (axis,)
    return out


def held_slices(leaf) -> tuple:
    """The slice of the whole leaf that this rank's piece of a placed leaf
    (a ``DTensor``) is: each ``Shard(d)`` mesh dimension splits ``d``
    evenly, the earlier mesh dimension major."""
    shape = list(leaf.shape)
    starts = [0] * len(shape)
    coordinate = leaf.device_mesh.get_coordinate()
    for index, placement in enumerate(leaf.placements):
        if placement.is_shard():
            dim = placement.dim
            shape[dim] //= leaf.device_mesh.size(index)
            starts[dim] += coordinate[index] * shape[dim]
    return tuple(slice(start, start + size)
                 for start, size in zip(starts, shape))


def is_distributed(leaf) -> bool:
    """Whether ``leaf`` is a placed leaf (a ``DTensor``)."""
    return hasattr(leaf, 'to_local') and hasattr(leaf, 'placements')


def local(leaf):
    """This rank's piece of a placed leaf (the tensor it holds; updating it
    in place updates the leaf), or the leaf itself."""
    if hasattr(leaf, 'to_local'):
        with torch.no_grad():
            return leaf.to_local()
    return leaf


def local_tree(tree):
    """:func:`local` over a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {key: local_tree(value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local_tree(value) for value in tree)
    return local(tree)


def is_placed(state) -> bool:
    """Whether a train state's parameters lie on a mesh of ranks."""
    mesh = getattr(state, 'mesh', None)
    return mesh is not None and mesh.distributed


def gather_leaf(piece: torch.Tensor, leaf, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from this rank's ``piece``: all-gathered over each
    mesh axis that splits it (the minor axis first), differentiably (the
    gather's backward reduce-scatters, summing over the axis). A
    replicated leaf's piece is the whole leaf."""
    from tpusystem_torch.parallel.collectives import all_gather
    for dim, axes in shard_axes(leaf).items():
        for axis in reversed(axes):
            piece = all_gather(piece, mesh, axis, dimension=dim)
    return piece


@register
class ShardingPolicy:
    """Composable sharding strategy.

    Args:
        rules: ``(regex, PartitionSpec)`` pairs, first match wins. Patterns
            are ``re.search`` against the leaf path.
        fsdp: infer fsdp-axis sharding for leaves the rules left unsharded.
        fsdp_min_size: leaves with fewer elements stay replicated (tiny
            tensors cost more to gather than they save).
    """

    def __init__(self, rules: Rules = (), fsdp: bool = False,
                 fsdp_min_size: int = 4096):
        self.rules = [(re.compile(pattern), spec) for pattern, spec in rules]
        self.fsdp = fsdp
        self.fsdp_min_size = fsdp_min_size

    def spec(self, path: str, shape: tuple[int, ...], mesh: Mesh
             ) -> PartitionSpec:
        chosen = PartitionSpec()
        for pattern, spec in self.rules:
            if pattern.search(path):
                chosen = spec
                break
        # drop rule axes that don't divide the dimension (e.g. the model
        # axis on an odd head count)
        entries = list(chosen) + [None] * (len(shape) - len(chosen))
        entries = [axis if axis is None
                   or shape[index] % _mesh_axis_size(mesh, axis) == 0
                   else None
                   for index, axis in enumerate(entries)]
        while entries and entries[-1] is None:
            entries.pop()
        chosen = PartitionSpec(*entries)
        if self.fsdp:
            chosen = _with_fsdp(chosen, shape, mesh, self.fsdp_min_size)
        return chosen

    def tree_specs(self, tree: Any, mesh: Mesh) -> Any:
        """A :class:`PartitionSpec` tree matching ``tree``'s structure; for
        a train state, a namespace with ``params``, ``opt_state`` and
        ``step``."""
        def assign(path, leaf):
            return self.spec(leaf_path(path), tuple(leaf.shape), mesh)
        if _is_state(tree):
            from types import SimpleNamespace
            return SimpleNamespace(
                params=_map_with_path(assign, tree.params, ('params',)),
                opt_state=_map_with_path(assign, tree.opt_state,
                                         ('opt_state',)),
                step=PartitionSpec())
        return _map_with_path(assign, tree)

    def tree_shardings(self, tree: Any, mesh: Mesh) -> Any:
        """The :class:`~tpusystem_torch.parallel.mesh.Placement` of each
        leaf."""
        specs = self.tree_specs(tree, mesh)
        tree = (specs.__dict__ if _is_state(tree) else specs)

        def wrap(node):
            if isinstance(node, PartitionSpec):
                return Placement(mesh, node)
            if isinstance(node, dict):
                return {key: wrap(value) for key, value in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(wrap(value) for value in node)
            return node
        return wrap(tree)

    def _placed(self, path, leaf, mesh: Mesh):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if isinstance(leaf, DTensor):
            raise ValueError(f'{leaf_path(path)} is placed already')
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        spec = self.spec(leaf_path(path), tuple(leaf.shape), mesh)
        placements = [Replicate()] * len(AXES)
        for dim, entry in enumerate(spec):
            for axis in spec_axes(entry):
                if axis in NOT_PORTED and mesh.shape[axis] > 1:
                    raise _not_ported(
                        f'placing {leaf_path(path)} split over the {axis!r} '
                        f'axis (size {mesh.shape[axis]})', axis)
                placements[AXES.index(axis)] = Shard(dim)
        piece = leaf.detach()[local_slices(leaf.shape, spec, mesh)]
        piece = piece.to(mesh.device, copy=True).contiguous()
        with torch.no_grad():
            placed = DTensor.from_local(
                piece, mesh.device_mesh, placements, run_check=False,
                shape=leaf.shape,
                stride=torch.empty(leaf.shape, device='meta').stride())
        held = local(placed)
        if getattr(leaf, 'stacked', False):
            held.stacked = True
        partial = [axis for entry in spec for axis in spec_axes(entry)
                   if mesh.shape[axis] > 1]
        if partial:     # a piece, not the whole leaf: norms sum over these
            held.shard_group = mesh.group(tuple(sorted(partial,
                                                       key=AXES.index)))
        return placed

    def place(self, tree: Any, mesh: Mesh) -> Any:
        """The tree on the mesh under this policy's specs: each tensor leaf
        a ``DTensor`` holding this rank's piece. A train state is placed in
        place (``params`` and ``opt_state``; the step counter and the
        guard's statistics are moved whole) and remembers its mesh. On a
        one-device mesh, the tree moved to the mesh's device."""
        if not mesh.distributed:
            return Placement(mesh)(tree)
        if _is_state(tree):
            tree.params = _map_with_path(
                lambda path, leaf: self._placed(path, leaf, mesh),
                tree.params, ('params',))
            tree.opt_state = _map_with_path(
                lambda path, leaf: self._placed(path, leaf, mesh),
                tree.opt_state, ('opt_state',))
            tree.step = tree.step.to(mesh.device)
            if tree.health is not None:
                for name, value in tree.health.tensors().items():
                    setattr(tree.health, name, value.to(mesh.device))
            tree.mesh = mesh
            return tree
        return _map_with_path(lambda path, leaf: self._placed(path, leaf,
                                                              mesh), tree)


def DataParallel() -> ShardingPolicy:
    """Replicate parameters everywhere; shard only the batch: the step
    all-reduces the gradients over ``(data, fsdp)``."""
    return ShardingPolicy(rules=(), fsdp=False)


def FullyShardedDataParallel(min_size: int = 4096) -> ShardingPolicy:
    """Parameters and optimizer slots scattered over the ``fsdp`` axis. The
    step gathers every split parameter whole before its forward and keeps
    the gathered set until the backward ends, so a rank's peak holds every
    parameter: this shards storage and slots, not the compute's working
    set (gathering one unit at a time is ROADMAP 9b's remainder). On an
    ``fsdp`` axis of size 1 the specs are :func:`DataParallel`'s."""
    return ShardingPolicy(rules=(), fsdp=True, fsdp_min_size=min_size)


def TensorParallel(rules: Rules, fsdp: bool = False,
                   fsdp_min_size: int = 4096) -> ShardingPolicy:
    """Megatron-style weight splitting from model-supplied rules, optionally
    combined with FSDP on the remaining dimensions. The specs are the
    reference's; placing a leaf over a ``model`` axis of size > 1 is
    ROADMAP 9c."""
    return ShardingPolicy(rules=rules, fsdp=fsdp, fsdp_min_size=fsdp_min_size)
