"""Named collectives over a mesh axis: the port of
:mod:`tpusystem.parallel.collectives`.

The reference's wrappers take a named axis inside ``shard_map``. The
port's take the :class:`~tpusystem_torch.parallel.mesh.Mesh` and the axis
name (or a tuple of names) and run over that axis's process group
(``torch.distributed``: NCCL on the card, gloo on the CPU), on the tensor
this rank holds. Each is differentiable where the reference's is: the
all-gather's backward is a reduce-scatter and the reverse, the all-to-all's
backward is the swapped all-to-all, a ring shift's backward the reverse
shift. On a one-device mesh every collective is the identity.

Ring-neighbour convention, fixed here once: rank ``i`` sends to
``(i + 1) % n`` when forward, so after ``s`` forward shifts rank ``i``
holds the shard of rank ``(i - s) % n``.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from tpusystem_torch.parallel.mesh import AXES, Mesh, spec_axes

__all__ = ['all_reduce_sum', 'all_reduce_mean', 'all_gather',
           'reduce_scatter', 'all_to_all', 'ring_shift', 'ring_shift_chunked',
           'pp_hop', 'ring_allgather', 'ring_reducescatter', 'axis_index',
           'axis_size', 'replica_checksums']


def _group(mesh: Mesh, axis):
    axes = spec_axes(axis)
    if list(axes) != sorted(axes, key=AXES.index):
        raise ValueError(f'axes {axes} must come in the mesh order {AXES}')
    return mesh.group(axes)


def _into(call, output, value, group) -> None:
    # torch 2.13 keeps these names as deprecated aliases of its *_single
    # collectives; 2.11 has only these
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', FutureWarning)
        call(output, value, group=group)


def _raw_all_reduce(value, group):
    out = value.contiguous().clone()
    torch.distributed.all_reduce(out, group=group)
    return out


def _raw_all_gather(value, group, dim):
    n = torch.distributed.get_world_size(group)
    moved = value.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    _into(torch.distributed.all_gather_into_tensor, out, moved, group)
    return out.movedim(0, dim)


def _raw_reduce_scatter(value, group, dim):
    n = torch.distributed.get_world_size(group)
    if value.shape[dim] % n:
        raise ValueError(f'cannot scatter {value.shape[dim]} rows over '
                         f'{n} ranks')
    moved = value.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    _into(torch.distributed.reduce_scatter_tensor, out, moved, group)
    return out.movedim(0, dim)


def _raw_all_to_all(value, group, split, concat):
    n = torch.distributed.get_world_size(group)
    if value.shape[split] % n:
        raise ValueError(f'cannot split {value.shape[split]} over {n} ranks')
    # [n, ...]: the n-th block of the split dimension goes to rank n
    blocks = torch.stack(value.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(blocks)
    torch.distributed.all_to_all_single(out, blocks, group=group)
    return torch.cat(out.unbind(0), dim=concat)


def _raw_shift(value, group, reverse):
    dist = torch.distributed
    n = dist.get_world_size(group)
    if n == 1:
        return value.clone()
    rank = dist.get_rank(group)
    step = -1 if reverse else 1
    send = value.contiguous()
    out = torch.empty_like(send)
    global_rank = dist.get_global_rank
    ops = [dist.P2POp(dist.isend, send, global_rank(group, (rank + step) % n),
                      group),
           dist.P2POp(dist.irecv, out, global_rank(group, (rank - step) % n),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group):
        ctx.group = group
        return _raw_all_reduce(value, group)

    @staticmethod
    def backward(ctx, grad):
        return _raw_all_reduce(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_all_gather(value, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _raw_reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_reduce_scatter(value, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _raw_all_gather(grad, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _raw_all_to_all(value, group, split, concat)

    @staticmethod
    def backward(ctx, grad):
        return (_raw_all_to_all(grad, ctx.group, ctx.concat, ctx.split),
                None, None, None)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, reverse):
        ctx.group, ctx.reverse = group, reverse
        return _raw_shift(value, group, reverse)

    @staticmethod
    def backward(ctx, grad):
        return _raw_shift(grad, ctx.group, not ctx.reverse), None, None


def all_reduce_sum(value: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Sum over every shard on ``axis`` (gradient reduction)."""
    group = _group(mesh, axis)
    return value if group is None else _AllReduce.apply(value, group)


def all_reduce_mean(value: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    return all_reduce_sum(value, mesh, axis) / axis_size(mesh, axis)


def all_gather(value: torch.Tensor, mesh: Mesh, axis, *, dimension: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Concatenate shards along ``dimension`` (FSDP weight gather); with
    ``tiled=False`` stack them on a new ``dimension``."""
    group = _group(mesh, axis)
    if not tiled:
        value = value.unsqueeze(dimension)
    if group is None:
        return value
    return _AllGather.apply(value, group, dimension % value.dim())


def reduce_scatter(value: torch.Tensor, mesh: Mesh, axis, *,
                   dimension: int = 0) -> torch.Tensor:
    """Sum then scatter along ``dimension`` (ZeRO gradient scatter)."""
    group = _group(mesh, axis)
    if group is None:
        return value
    return _ReduceScatter.apply(value, group, dimension % value.dim())


def all_to_all(value: torch.Tensor, mesh: Mesh, axis, *,
               split_dimension: int, concat_dimension: int) -> torch.Tensor:
    """Shard-transpose (MoE token dispatch, Ulysses head/seq swap): block
    ``j`` of ``split_dimension`` goes to rank ``j``, and the blocks that
    arrive concatenate along ``concat_dimension`` in rank order."""
    group = _group(mesh, axis)
    if group is None:
        return value
    return _AllToAll.apply(value, group, split_dimension % value.dim(),
                           concat_dimension % value.dim())


def ring_shift(value: torch.Tensor, mesh: Mesh, axis, *,
               reverse: bool = False) -> torch.Tensor:
    """Send this shard to the next (or previous) rank on the ring: rank
    ``i`` sends to ``(i + 1) % n`` when forward."""
    group = _group(mesh, axis)
    return value if group is None else _Shift.apply(value, group, reverse)


def ring_shift_chunked(value: torch.Tensor, mesh: Mesh, axis, *,
                       chunks: int = 1, reverse: bool = False
                       ) -> torch.Tensor:
    """:func:`ring_shift` with the payload split into ``chunks``
    independent shifts along dimension 0: the same result, in finer
    transfers. Requires ``value.shape[0] % chunks == 0``."""
    if chunks <= 1:
        return ring_shift(value, mesh, axis, reverse=reverse)
    if value.shape[0] % chunks:
        raise ValueError(f'cannot split {value.shape[0]} rows into '
                         f'{chunks} ppermute chunks')
    return torch.cat([ring_shift(piece, mesh, axis, reverse=reverse)
                      for piece in value.chunk(chunks, dim=0)], dim=0)


def pp_hop(*args, **kwargs):
    """One pipeline stage-to-stage hop: ROADMAP queue 1, 9d. Pipelines."""
    raise NotImplementedError(
        'pp_hop (the pipeline hop) is not ported to tpusystem_torch yet '
        '(ROADMAP queue 1: 9d. Pipelines)')


def ring_allgather(value: torch.Tensor, mesh: Mesh, axis, *,
                   dimension: int = 0, chunks: int = 1) -> torch.Tensor:
    """:func:`all_gather` decomposed into ``axis_size`` ring steps: each
    shard rotates forward one hop a step and lands in its row block of the
    ``[..., n * shard, ...]`` result; the next hop is issued before the
    current block's copy."""
    ring = axis_size(mesh, axis)
    rank = axis_index(mesh, axis)
    blocks: list = [None] * ring
    held = value
    incoming = ring_shift_chunked(held, mesh, axis, chunks=chunks)
    for step in range(ring):
        if step:
            held = incoming
            if step + 1 < ring:
                incoming = ring_shift_chunked(held, mesh, axis, chunks=chunks)
        blocks[(rank - step) % ring] = held
    return torch.cat(blocks, dim=dimension)


def ring_reducescatter(value: torch.Tensor, mesh: Mesh, axis, *,
                       dimension: int = 0, chunks: int = 1) -> torch.Tensor:
    """:func:`reduce_scatter` decomposed into ``axis_size`` ring steps: at
    step ``t`` each rank folds block ``(rank - 1 - t) % n`` of ``value``
    into the float32 sum arriving from its predecessor, so block ``rank``
    lands home with all ``n`` contributions; cast back to
    ``value.dtype``."""
    ring = axis_size(mesh, axis)
    rank = axis_index(mesh, axis)
    if value.shape[dimension] % ring:
        raise ValueError(f'cannot scatter {value.shape[dimension]} rows '
                         f'over {ring} ranks')
    blocks = value.chunk(ring, dim=dimension)
    total = blocks[(rank - 1) % ring].float()
    for step in range(1, ring):
        inflight = ring_shift_chunked(total, mesh, axis, chunks=chunks)
        total = inflight + blocks[(rank - 1 - step) % ring]
    return total.to(value.dtype)


def axis_index(mesh: Mesh, axis) -> int:
    """This rank's index along ``axis`` (a name or names, first major)."""
    return mesh.axis_index(axis)


def axis_size(mesh: Mesh, axis) -> int:
    return mesh.axis_size(axis)


# ---------------------------------------------------------------------------
# cross-replica parity (SDC detection)

MASK32 = 0xFFFFFFFF


def _bit_checksum(leaf: torch.Tensor) -> torch.Tensor:
    """Order-independent uint32 checksum of a tensor's raw bits, as an
    int64 tensor in ``[0, 2**32)``: each element's bits read as an unsigned
    integer (a 64-bit element as its two 32-bit words), widened to int64,
    summed and taken mod 2**32 — the reference's wrapping ``uint32`` sum,
    which torch lacks. Integer addition is commutative, so two replicas
    holding the same bits always agree and one flipped bit changes the
    sum."""
    size = leaf.element_size()
    flat = leaf.detach().contiguous().reshape(-1)
    if size > 4:
        words = flat.view(torch.int32).to(torch.int64) & MASK32
    else:
        kind = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[size]
        words = flat.view(kind).to(torch.int64) & ((1 << (8 * size)) - 1)
    return words.sum() & MASK32


def _tree_leaves(tree: Any, prefix: str = '') -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts, tuples and lists, in its
    own order; a state dict's dotted names become ``/``-joined paths."""
    if isinstance(tree, dict):
        out = []
        for key, value in tree.items():
            name = str(key).replace('.', '/')
            out += _tree_leaves(value, f'{prefix}/{name}' if prefix else name)
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for index, value in enumerate(tree):
            out += _tree_leaves(value, f'{prefix}/{index}' if prefix
                               else str(index))
        return out
    return [(prefix, tree)]


def _local(leaf: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return leaf.to_local() if hasattr(leaf, 'to_local') else leaf


def replica_checksums(tree: Any, mesh: Mesh, *, axis: str = 'data'
                      ) -> tuple[np.ndarray, list[str]]:
    """Per-replica bit checksums of every leaf of ``tree``.

    The device half of the sentinel's SDC parity check
    (:meth:`tpusystem_torch.train.Sentinel.check_parity`): each rank
    checksums its local piece of every leaf, the checksums are summed
    (mod 2**32) over the mesh's other axes (one scalar per leaf per
    replica: a leaf replicated over ``model`` counts once per ``model``
    rank, as the reference's does) and all-gathered over ``axis``.

    Returns ``(matrix, paths)``: a ``[axis_size, leaves]`` uint32 numpy
    matrix (row ``r`` = replica ``r``) and the leaves' ``/``-joined
    paths, in the tree's order.
    """
    pairs = _tree_leaves(tree)
    paths = [path for path, _ in pairs]
    vector = torch.stack([_bit_checksum(_local(leaf)) for _, leaf in pairs]
                         ).to(mesh.device)
    if mesh.distributed:
        others = tuple(name for name in AXES if name != axis)
        vector = _raw_all_reduce(vector, mesh.group(others)) & MASK32
        vector = _raw_all_gather(vector.unsqueeze(0), mesh.group(axis), 0)
    else:
        vector = vector.unsqueeze(0)
    return vector.cpu().numpy().astype(np.uint32), paths
