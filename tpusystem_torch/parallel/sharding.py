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
gathering the FSDP-sharded leaves one unit at a time (:func:`defer_leaf`,
:func:`gathered`, :func:`unit_gathering`); a leaf split over
``model`` (tensor parallelism, alone or with ``fsdp``) reaches the forward
as this rank's piece, which the models' tensor-parallel products take as
it is; a pipelined model's layer stack split over ``stage`` reaches it as
this rank's layers (:mod:`tpusystem_torch.parallel.pipeline`); an expert
stack split over ``expert`` reaches it as this rank's experts, and a table
split over ``expert``/``model`` as this rank's rows (expert-major, the
reference's order: a dimension split over several axes is cut in
:data:`SPLIT_ORDER`, which :func:`shard_axes`, :func:`held_slices` and
:func:`whole_leaf` follow, where a ``DTensor``'s own order would put
``model`` first). On a one-device mesh (no process group) a placement
moves the tree to the mesh's device, as before.
"""

from __future__ import annotations

import contextvars
import re
import weakref
from typing import Any, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from tpusystem_torch.parallel.mesh import (AXES, DATA, EXPERT, FSDP, MODEL,
                                           SEQ, STAGE, Mesh, PartitionSpec,
                                           Placement, local_slices,
                                           spec_axes)
from tpusystem_torch.registry import register

__all__ = ['Rules', 'TABLE_AXES', 'PartitionSpec', 'table_row_spec',
           'constrain_table_rows', 'expert_major_spec',
           'constrain_expert_major', 'leaf_path', 'fsdp_shard_dim',
           'ShardingPolicy', 'DataParallel', 'FullyShardedDataParallel',
           'TensorParallel', 'local', 'local_tree', 'gather_leaf',
           'is_placed', 'shard_axes', 'held_slices', 'is_distributed',
           'held_axes', 'with_held', 'tp_pieces', 'whole_leaf',
           'SPLIT_ORDER', 'defer_leaf', 'gathered', 'is_deferred',
           'deferred_layers', 'unit_gathering', 'guard_stand_ins',
           'whole_bytes', 'LazyLeaf']

Rules = Sequence[tuple[str, PartitionSpec]]

# The embedding-table sharding axes: recommender tables row-shard their
# vocab dimension over the combined (expert, model) axes.
TABLE_AXES = (EXPERT, MODEL)

# the order in which the axes splitting one dimension nest, the first
# major: the mesh's, but for ``expert`` before ``model`` (a table's rows,
# TABLE_AXES)
SPLIT_ORDER = (DATA, FSDP, EXPERT, MODEL, SEQ, STAGE)


def _split_order(axes) -> tuple:
    return tuple(sorted(spec_axes(axes), key=SPLIT_ORDER.index))


def table_row_spec(rank: int) -> PartitionSpec:
    """Spec for a row-sharded embedding table: the leading (vocab)
    dimension splits over the combined ``expert``/``model`` axes, every
    other dim stays unsharded. The expert-major shard order is the
    contract the routed lookup of :mod:`tpusystem_torch.recsys.embedding`
    derives its offsets from."""
    return PartitionSpec(TABLE_AXES, *([None] * (rank - 1)))


def _pinned(value, mesh, axes: tuple, what: str):
    """``value`` itself: eager PyTorch has no sharding annotation, so the
    pin checks and never moves a tensor. Where ``axes`` (those the mesh
    has) split anything, a value marked held (:func:`held_axes`) must be
    held over exactly them at its leading dimension (``ValueError``
    otherwise)."""
    present = tuple(axis for axis in axes if axis in mesh.shape)
    parts = 1
    for axis in present:
        parts *= mesh.shape[axis]
    if parts == 1:
        return value
    held = held_axes(value).get(0)
    if held is not None and tuple(held) != present:
        raise ValueError(f'{what} is held split over {held}, not over '
                         f'{present}')
    return value


def constrain_table_rows(value, mesh):
    """The reference's pin of a row-sharded table (or table-shaped
    activation) to the ``expert``/``model`` axes (``sharding.py:51``): the
    identity off-mesh or when both have size 1; an axis a hand-built mesh
    lacks drops out. On a mesh of ranks the table reaches the routed
    lookup as this rank's rows already (the step keeps it split), so the
    pin checks that a piece marked held is held over these axes and
    returns the value untouched."""
    if mesh is None:
        return value
    return _pinned(value, mesh, TABLE_AXES, 'a table')


def expert_major_spec(rank: int) -> PartitionSpec:
    """Spec for expert-major activation buffers: the leading dim carries the
    expert id and shards over the ``expert`` axis."""
    return PartitionSpec(EXPERT, *([None] * (rank - 1)))


def constrain_expert_major(value, mesh):
    """The reference's pin of an expert-major buffer to the ``expert``
    axis (``sharding.py:82``): the identity off-mesh or when the axis has
    size 1. On an expert mesh a rank computes on its own experts' rows,
    so the pin checks that a piece marked held is held over ``expert``
    and returns the value untouched."""
    if mesh is None or mesh.shape.get(EXPERT, 1) == 1:
        return value
    return _pinned(value, mesh, (EXPERT,), 'an expert buffer')


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
    ``Shard`` placements (empty for a plain tensor or a replicated one),
    the axes of one dimension in :data:`SPLIT_ORDER`."""
    placements = getattr(leaf, 'placements', None)
    if placements is None:
        return {}
    out: dict[int, tuple] = {}
    for axis, placement in zip(AXES, placements):
        if placement.is_shard():
            out[placement.dim] = out.get(placement.dim, ()) + (axis,)
    return {dim: _split_order(axes) for dim, axes in out.items()}


def held_slices(leaf) -> tuple:
    """The slice of the whole leaf that this rank's piece of a placed leaf
    (a ``DTensor``) is: each dimension splits evenly over its
    :func:`shard_axes`, the first major."""
    mesh = leaf.device_mesh
    coordinate = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    slices = [slice(0, size) for size in leaf.shape]
    for dim, axes in shard_axes(leaf).items():
        index, parts = 0, 1
        for axis in axes:
            size = mesh.size(mesh.mesh_dim_names.index(axis))
            index, parts = index * size + coordinate[axis], parts * size
        chunk = leaf.shape[dim] // parts
        slices[dim] = slice(index * chunk, (index + 1) * chunk)
    return tuple(slices)


@torch.no_grad()
def whole_leaf(leaf) -> torch.Tensor:
    """The whole of a placed leaf, all-gathered from every rank's piece in
    :func:`shard_axes` order (a collective every rank of its mesh joins;
    the counterpart of ``DTensor.full_tensor``, whose order puts ``model``
    before ``expert``)."""
    from tpusystem_torch.parallel.collectives import _raw_all_gather
    mesh, piece = leaf.device_mesh, local(leaf)
    for dim, axes in shard_axes(leaf).items():
        for axis in reversed(axes):
            if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
                piece = _raw_all_gather(piece, mesh.get_group(axis), dim)
    return piece


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


def _kept_axes(leaf, keep: Sequence[str]) -> dict:
    """``{dim: (axes, kept)}`` of a placed leaf: the axes splitting each
    dimension and the major ones of them ``keep`` leaves split."""
    out = {}
    for dim, axes in shard_axes(leaf).items():
        kept = tuple(axis for axis in axes if axis in keep)
        if kept and kept != axes[:len(kept)]:
            raise ValueError(f'dimension {dim} splits over {axes}: the '
                             f'kept axes {kept} must be its major ones')
        out[dim] = (axes, kept)
    return out


def gather_leaf(piece: torch.Tensor, leaf, mesh: Mesh,
                keep: Sequence[str] = ()) -> torch.Tensor:
    """The whole leaf from this rank's ``piece``: all-gathered over each
    mesh axis that splits it (the minor axis first), differentiably. Over a
    batch axis (``data``, ``fsdp``) the gather's backward reduce-scatters,
    summing the ranks' gradients of their own rows; over ``model``, whose
    ranks compute alike on the same rows, it keeps this rank's block. A
    replicated leaf's piece is the whole leaf. Axes in ``keep`` stay split:
    the result is then the piece over them, and carries ``held``, the
    ``{dim: axes}`` it is still split over (:func:`held_axes`). A tensor
    it gathers counts in :data:`whole_bytes`."""
    from tpusystem_torch.parallel.collectives import all_gather, gather_from
    held, source = {}, piece
    for dim, (axes, kept) in _kept_axes(leaf, keep).items():
        if kept:
            held[dim] = kept
        for axis in reversed(axes[len(kept):]):
            gather = gather_from if axis == MODEL else all_gather
            piece = gather(piece, mesh, axis, dimension=dim)
    if piece is not source:
        whole_bytes.add(piece)
    if held:
        piece = piece.view_as(piece)   # a tensor of its own to mark
        piece.held = held
    return piece


# Per-unit gathering. A placed step hands a unit-aware forward each leaf it
# must gather as a stand-in (:func:`defer_leaf`: the whole leaf's shape, one
# NaN element of memory) that knows this rank's piece; a unit (a block, a
# layer slice of a scanned stack, the embeddings, the final norm and head)
# gathers its leaves when it is entered (:func:`gathered`), and drops them
# when it returns; a stand-in that reaches any other operation than a read
# of its metadata raises. Under :func:`unit_gathering` a tensor that autograd saves
# and that is a gathered leaf, one of its casts or a view of either is
# packed as a recipe (gather the piece again, cast again) and rebuilt when
# the backward reaches it, so between units autograd keeps only pieces.
# Every use of a leaf in one forward goes through one root node, whose
# backward reduce-scatters the sum of the uses' gradients once: the tied
# embedding's two uses sum before the scatter, as a whole gather's do.


class WholeBytes:
    """The bytes of whole gathered leaves and of their casts alive now
    (``live``) and at most since :meth:`reset` (``peak``), each storage
    counted from its gather or cast until it is freed, kept like the kernel
    wrappers' ``launches`` counters."""

    def __init__(self) -> None:
        self.live = self.peak = 0
        self._storages: set = set()

    def reset(self) -> None:
        self.peak = self.live

    def add(self, tensor: torch.Tensor) -> None:
        storage = tensor.untyped_storage()
        key = storage.data_ptr()
        if key in self._storages or storage.nbytes() == 0:
            return
        self._storages.add(key)
        self.live += storage.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._freed, key, storage.nbytes())

    def _freed(self, key: int, size: int) -> None:
        self._storages.discard(key)
        self.live -= size


whole_bytes = WholeBytes()


def _geometry(tensor: torch.Tensor) -> tuple:
    """``(size, stride, storage offset)``: a view of a storage."""
    return (tuple(tensor.size()), tuple(tensor.stride()),
            tensor.storage_offset())


class _Recipe:
    """How to make a storage again: ``make()`` returns a tensor laid out as
    ``geometry`` (size, stride, offset) on a storage of its own of
    ``nbytes``."""

    __slots__ = ('make', 'geometry', 'nbytes')

    def __init__(self, make, tensor: torch.Tensor) -> None:
        self.make = make
        self.geometry = _geometry(tensor)
        self.nbytes = tensor.untyped_storage().nbytes()

    def rebuild(self) -> torch.Tensor:
        made = self.make()
        got = _geometry(made)
        if got != self.geometry:
            raise RuntimeError(f'a rebuilt gathered tensor is laid out as '
                               f'{got}, not {self.geometry}')
        whole_bytes.add(made)
        return made


class _Packed:
    """A saved tensor on a gathered storage: its recipe and its view."""

    __slots__ = ('recipe', 'geometry')

    def __init__(self, recipe: _Recipe, tensor: torch.Tensor) -> None:
        self.recipe = recipe
        self.geometry = _geometry(tensor)

    def unpack(self) -> torch.Tensor:
        return self.recipe.rebuild().as_strided(*self.geometry)


# the tensor methods that copy a tensor into a storage of its own
_COPIES = frozenset((torch.Tensor.to, torch.Tensor.type,
                     torch.Tensor.float, torch.Tensor.double,
                     torch.Tensor.half, torch.Tensor.bfloat16,
                     torch.Tensor.contiguous, torch.Tensor.clone))

# what may be asked of a stand-in: its metadata (besides property reads
# that give no tensor)
_METADATA = frozenset((torch.Tensor.dim, torch.Tensor.ndimension,
                       torch.Tensor.size, torch.Tensor.numel,
                       torch.Tensor.nelement, torch.Tensor.element_size,
                       torch.Tensor.is_floating_point,
                       torch.Tensor.is_complex, torch.Tensor.get_device,
                       torch.Tensor.__len__))

# the unit_gathering context a forward runs in, if any
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar('unit_gathering',
                                                         default=None)


def _stand_in_among(args: tuple, kwargs: dict) -> bool:
    """Whether a stand-in is among the arguments (or in a list of them)."""
    for value in (*args, *kwargs.values()):
        if isinstance(value, (list, tuple)):
            if any(map(is_deferred, value)):
                return True
        elif is_deferred(value):
            return True
    return False


class _StandIns(TorchFunctionMode):
    """Raises where a stand-in reaches an operation that is more than a
    read of its metadata: a leaf used outside the units that gather it,
    which would otherwise compute on the stand-in's NaN. Under
    :class:`unit_gathering` (``gathering``), records each copy of a
    gathered storage (a method in :data:`_COPIES`) with the recipe that
    makes it again."""

    def __init__(self, gathering: 'unit_gathering | None' = None) -> None:
        super().__init__()
        self.gathering = gathering

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        getter = getattr(func, '__name__', None) == '__get__'
        if func not in _METADATA and _stand_in_among(args, kwargs):
            out = func(*args, **kwargs) if getter else None
            if not getter or isinstance(out, torch.Tensor):
                raise RuntimeError(
                    f'{getattr(func, "__qualname__", func)} on the stand-in '
                    f'of a leaf still to gather: a unit gathers its leaves '
                    f'on entry (parallel/sharding.py gathered)')
            return out
        out = func(*args, **kwargs)
        if self.gathering is not None and func in _COPIES \
                and isinstance(out, torch.Tensor) and out is not args[0]:
            self.gathering.record_copy(func, args[0], args[1:], kwargs, out)
        return out


def guard_stand_ins() -> _StandIns:
    """A context in which a stand-in used outside its unit raises
    (:class:`unit_gathering` guards so too)."""
    return _StandIns()


class unit_gathering:
    """The context a forward gathers its units in: a saved tensor on a
    storage gathered inside it (or copied from one) is packed as its
    recipe and rebuilt, gathered again, when the backward needs it, and a
    stand-in used outside its unit raises. Leaves gathered outside it are
    saved as they are."""

    def __init__(self) -> None:
        # storage pointer -> recipe, for the storages still alive
        self.recipes: dict = {}

    def record(self, tensor: torch.Tensor, make) -> None:
        """Let a saved tensor on ``tensor``'s storage be packed as
        ``make``."""
        storage = tensor.untyped_storage()
        key = storage.data_ptr()
        if key not in self.recipes:
            self.recipes[key] = _Recipe(make, tensor)
            weakref.finalize(storage, self.recipes.pop, key, None)

    def record_copy(self, func, source, rest: tuple, kwargs: dict,
                    out: torch.Tensor) -> None:
        """Record ``out = func(source, *rest, **kwargs)`` where ``source``
        lies on a recorded storage and ``out`` on a new one."""
        if not self.recipes:
            return
        recipe = self.recipes.get(source.untyped_storage().data_ptr())
        if recipe is None or (out.untyped_storage().data_ptr()
                              == source.untyped_storage().data_ptr()):
            return
        view = _geometry(source)

        def make():
            return func(recipe.rebuild().as_strided(*view), *rest, **kwargs)
        whole_bytes.add(out)
        self.record(out, make)

    def _pack(self, tensor):
        # a stand-in is saved as it is (a remat checkpoint's inputs), and
        # its storage, one element, is never a gathered one
        if not self.recipes or is_deferred(tensor):
            return tensor
        storage = tensor.untyped_storage()
        recipe = self.recipes.get(storage.data_ptr())
        if recipe is None or recipe.nbytes != storage.nbytes():
            return tensor
        return _Packed(recipe, tensor)

    @staticmethod
    def _unpack(packed):
        return packed.unpack() if isinstance(packed, _Packed) else packed

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                              self._unpack)
        self._mode = _StandIns(self)
        self._hooks.__enter__()
        self._mode.__enter__()
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        self._mode.__exit__(*exc)
        self._hooks.__exit__(*exc)
        return False


def _gather_steps(leaf, mesh: Mesh, keep: Sequence[str]):
    """``(steps, held)``: the gathers :func:`gather_leaf` runs on a piece of
    ``leaf``, in its order, as ``(dim, group, over_model)`` (axes of one
    rank left out), and the ``{dim: axes}`` left split."""
    from tpusystem_torch.parallel.collectives import _split_group
    steps, held = [], {}
    for dim, (axes, kept) in _kept_axes(leaf, keep).items():
        if kept:
            held[dim] = kept
        for axis in reversed(axes[len(kept):]):
            group = _split_group(mesh, axis)
            if group is not None:
                steps.append((dim, group, axis == MODEL))
    return steps, held


def _scatter(grad: torch.Tensor, steps: list) -> torch.Tensor:
    """The backward of :func:`gather_leaf`'s gathers, in reverse: a
    reduce-scatter over a batch axis, this rank's block over ``model``."""
    from tpusystem_torch.parallel.collectives import (_block,
                                                      _raw_reduce_scatter)
    for dim, group, over_model in reversed(steps):
        grad = (_block(grad, group, dim).contiguous() if over_model
                else _raw_reduce_scatter(grad, group, dim))
    return grad


def _scatter_layout(grad: torch.Tensor, steps: list) -> torch.Tensor:
    """``grad`` laid out in memory as :func:`_scatter` lays out its result
    (its last reduce-scatter's dimension outermost; contiguous after a
    block over ``model``): the optimizer's norms reduce in memory order."""
    if not steps:
        return grad
    dim, _, over_model = steps[0]
    if over_model:
        return grad.contiguous()
    return grad.movedim(dim, 0).contiguous().movedim(0, dim)


class _Layers(torch.autograd.Function):
    """A stacked piece's layer slices (one ``unbind``), whose backward
    stacks their gradients in the layout :func:`_scatter` gives the whole
    stack's gradient, so a step gathered per layer slice hands the
    optimizer what a whole gather hands it, layout included."""

    @staticmethod
    def forward(ctx, piece, steps):
        ctx.steps = steps
        return piece.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        return _scatter_layout(torch.stack(grads), ctx.steps), None


class _Root(torch.autograd.Function):
    """The one node every use of a deferred leaf in a forward feeds: its
    gradient is the uses' gradients summed, scattered to the piece once."""

    @staticmethod
    def forward(ctx, piece, lazy):
        ctx.steps = lazy.steps
        return lazy.stand_in()

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.steps), None


class _Use(torch.autograd.Function):
    """One use of a deferred leaf: the piece gathered whole, its gradient
    passed to the leaf's root whole."""

    @staticmethod
    def forward(ctx, root, lazy):
        return lazy.gather()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class LazyLeaf:
    """A leaf a unit gathers when it is entered: ``source``, this rank's
    piece (differentiable, or not), and the gathers that make it whole."""

    def __init__(self, source: torch.Tensor, steps: list, held: dict,
                 shape: tuple) -> None:
        self.source, self.steps, self.held = source, steps, held
        self.shape = shape
        self.root = None

    def stand_in(self) -> torch.Tensor:
        """The leaf's shape on one NaN element (which a use outside a
        unit, under :func:`guard_stand_ins` or :class:`unit_gathering`,
        never reaches: it raises)."""
        dtype = self.source.dtype
        return torch.full((), float('nan') if dtype.is_floating_point else 0,
                          dtype=dtype, device=self.source.device).expand(
            self.shape)

    def _gather(self) -> torch.Tensor:
        from tpusystem_torch.parallel.collectives import _raw_all_gather
        piece = self.source.detach()
        for dim, group, _ in self.steps:
            piece = _raw_all_gather(piece, group, dim)
        return piece

    def gather(self) -> torch.Tensor:
        """The whole leaf, gathered now (no autograd), marked ``held``
        over the axes it stays split over; counted, and recorded in the
        :class:`unit_gathering` context it is gathered in."""
        whole = self._gather()
        whole_bytes.add(whole)
        gathering = _ACTIVE.get()
        if gathering is not None:
            gathering.record(whole, self._gather)
        if self.held:
            whole.held = self.held
        return whole

    def whole(self) -> torch.Tensor:
        """The whole leaf for one use: under autograd through the leaf's
        root (made at its first use), else :meth:`gather`."""
        if not (torch.is_grad_enabled() and self.source.requires_grad):
            return self.gather()
        if self.root is None:
            self.root = _Root.apply(self.source, self)
        return self.through(self.root)

    def anchor(self) -> torch.Tensor:
        """A leaf of its own in the whole leaf's shape, on one element,
        requiring grad: its gradient is the whole leaf's, summed over the
        uses hung on it by :meth:`through`."""
        return self.stand_in().requires_grad_(
            self.source.is_floating_point())

    def through(self, root: torch.Tensor) -> torch.Tensor:
        """The whole leaf for one use, gathered now, its gradient passed
        whole to ``root`` (the leaf's :class:`_Root`, or an
        :meth:`anchor`)."""
        whole = _Use.apply(root, self)
        if self.held:
            whole.held = self.held
        return whole

    def layers(self, lead_held: bool = False) -> list['LazyLeaf']:
        """One lazy leaf per index of the leading dimension (a stacked
        leaf's layer slices, each a root of its own), which no gather may
        split. With ``lead_held`` the piece may be held split there (a
        pipeline stage's layers of the stack): its slices are this rank's
        layers, held over nothing at that dimension."""
        if any(dim == 0 for dim, _, _ in self.steps) or (
                0 in self.held and not lead_held):
            raise ValueError('a deferred leaf split at its leading '
                             'dimension has no layer slices')
        steps = [(dim - 1, group, over_model)
                 for dim, group, over_model in self.steps]
        held = {dim - 1: axes for dim, axes in self.held.items() if dim}
        pieces = (_Layers.apply(self.source, self.steps)
                  if torch.is_grad_enabled() and self.source.requires_grad
                  else self.source.unbind(0))
        return [LazyLeaf(piece, steps, held, self.shape[1:])
                for piece in pieces]


def _deferred(lazy: LazyLeaf) -> torch.Tensor:
    stand_in = lazy.stand_in()
    stand_in.lazy = lazy
    if lazy.held:
        stand_in.held = lazy.held
    return stand_in


def defer_leaf(piece: torch.Tensor, leaf, mesh: Mesh,
               keep: Sequence[str] = ()) -> torch.Tensor:
    """:func:`gather_leaf` put off until a unit needs it: where the leaf
    must be gathered over some axis of more than one rank, a stand-in of
    the gathered shape that :func:`gathered` turns into the whole leaf,
    gathered then (under autograd, differentiable back to ``piece``);
    otherwise :func:`gather_leaf` itself."""
    steps, held = _gather_steps(leaf, mesh, keep)
    if not steps:
        return gather_leaf(piece, leaf, mesh, keep)
    shape = list(piece.shape)
    for dim, group, _ in steps:
        shape[dim] *= torch.distributed.get_world_size(group)
    return _deferred(LazyLeaf(piece, steps, held, tuple(shape)))


def is_deferred(tensor) -> bool:
    """Whether ``tensor`` is a stand-in of :func:`defer_leaf`."""
    return getattr(tensor, 'lazy', None) is not None


def gathered(tensor):
    """The whole leaf a :func:`defer_leaf` stand-in stands for, gathered
    for this use; any other value as it is."""
    lazy = getattr(tensor, 'lazy', None)
    return tensor if lazy is None else lazy.whole()


def deferred_layers(tensor) -> list:
    """A stacked stand-in's layer slices, each a stand-in gathered on its
    own (one ``unbind`` of the piece)."""
    return [_deferred(lazy) for lazy in tensor.lazy.layers()]


@torch.no_grad()
def tp_pieces(weights: dict, rules: Rules, mesh: Mesh) -> dict:
    """This rank's pieces of a dict of whole tensors under
    ``TensorParallel(rules)`` on ``mesh``, each split over ``model`` marked
    with :func:`held_axes` (the serving engine's streamed weights)."""
    placed = TensorParallel(rules).place(weights, mesh)
    return {name: gather_leaf(local(leaf), leaf, mesh, keep=(MODEL,))
            for name, leaf in placed.items()}


def with_held(tensor: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``tensor`` (a cast or a view of ``source``) marked with the axes
    ``source`` is held split over."""
    held = held_axes(source)
    if held and tensor is not source:
        tensor.held = held
    return tensor


def held_axes(tensor) -> dict:
    """``{dim: mesh axes}`` a tensor reaching a forward is still split over
    (set by :func:`gather_leaf`'s ``keep``); empty for a whole tensor."""
    return getattr(tensor, 'held', None) or {}


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
        spec = PartitionSpec(*(entry if entry is None
                               or isinstance(entry, str)
                               else _split_order(entry) for entry in spec))
        placements = [Replicate()] * len(AXES)
        for dim, entry in enumerate(spec):
            for axis in spec_axes(entry):
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
    """Parameters and optimizer slots scattered over the ``fsdp`` axis,
    gathered just in time, one unit at a time (the reference's "gathered
    just-in-time per layer by GSPMD"). The placed steps hand a unit-aware
    forward (GPT-2, Llama) each split parameter as a stand-in
    (:func:`defer_leaf`); each unit (the embeddings, a block or a layer
    slice of a scanned stack, the final norm with the head) gathers its
    leaves when it is entered and drops them when it returns; the backward
    gathers them again when it reaches the unit (:func:`unit_gathering`)
    and reduce-scatters each leaf's gradient once, summed over its uses. A
    rank so holds its pieces, its slots and at most one unit whole; the
    1F1B step gathers a stage's chunk or its replicated leaves at a time
    (:mod:`tpusystem_torch.parallel.pipeline`), and any other module is one
    unit. On an ``fsdp`` axis of size 1 the specs are
    :func:`DataParallel`'s."""
    return ShardingPolicy(rules=(), fsdp=True, fsdp_min_size=min_size)


def TensorParallel(rules: Rules, fsdp: bool = False,
                   fsdp_min_size: int = 4096) -> ShardingPolicy:
    """Megatron-style weight splitting from model-supplied rules, optionally
    combined with FSDP on the remaining dimensions. The specs are the
    reference's; each rank holds its ``Shard`` pieces over ``model`` (and
    ``fsdp``), which the step hands to the forward over ``model`` unsplit
    (:func:`gather_leaf`'s ``keep``)."""
    return ShardingPolicy(rules=rules, fsdp=fsdp, fsdp_min_size=fsdp_min_size)
