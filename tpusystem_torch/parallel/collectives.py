"""Named collectives over a mesh axis: the port of
:mod:`tpusystem.parallel.collectives`.

The reference's wrappers take a named axis inside ``shard_map``. The
port's take the :class:`~tpusystem_torch.parallel.mesh.Mesh` and the axis
name (or a tuple of names) and run over that axis's process group
(``torch.distributed``: NCCL on the card, gloo on the CPU), on the tensor
this rank holds. Each is differentiable where the reference's is: the
all-gather's backward is a reduce-scatter and the reverse, the all-to-all's
backward is the swapped all-to-all, a permutation's backward the inverse
permutation (a ring shift is the permutation ``i -> i + 1``, its backward
the reverse shift). On a one-device mesh every collective is the
identity.

Ring-neighbour convention, fixed here once: rank ``i`` sends to
``(i + 1) % n`` when forward, so after ``s`` forward shifts rank ``i``
holds the shard of rank ``(i - s) % n``.

A permutation takes the route its mesh picked when it built its groups
(:attr:`~tpusystem_torch.parallel.mesh.Mesh.route`): ``'p2p'``, one
``isend``/``irecv`` pair a hop, over NCCL and over gloo on the CPU; and
``'gather'`` over gloo on CUDA tensors, where a point-to-point send aborts
the process: every rank all-gathers the shards and keeps its source's
(the same bytes as the pair at two ranks, ``n`` times them at ``n``).

The ragged exchange (:func:`ragged_all_to_all`, the reference's
``_ragged_exchange`` in ``ops/moe.py``) moves a different number of rows to
each rank: transport ``'ragged'`` is one ``all_to_all_single`` whose split
sizes are Python ints read from the device (one host sync an exchange),
``'gathered'`` the all-gather emulation with the same seating and no host
sync. Its backward is the reverse exchange, the roles swapped.

The Megatron conjugates run tensor parallelism over activations that every
``model`` rank holds whole (replicated): :func:`copy_to` (identity forward,
sum of the gradients backward) enters a column-parallel product,
:func:`reduce_from` (sum forward, identity backward) leaves a row-parallel
one, :func:`scatter_to` keeps this rank's block of a dimension (its
backward gathers the blocks) and :func:`gather_from` gathers the blocks
(its backward keeps this rank's block of the gradient, which every rank
holds whole).
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from tpusystem_torch.parallel.mesh import AXES, Mesh, spec_axes

__all__ = ['all_reduce_sum', 'all_reduce_mean', 'all_gather',
           'reduce_scatter', 'all_to_all', 'ppermute', 'ring_shift',
           'ring_shift_chunked', 'pp_hop', 'ring_allgather', 'ring_reducescatter', 'axis_index',
           'axis_size', 'replica_checksums', 'copy_to', 'reduce_from',
           'scatter_to', 'gather_from', 'ragged_all_to_all', 'live_axes']


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


def _sum32(value, group):
    """The all-reduce of ``value`` in float32, cast back once."""
    return _raw_all_reduce(value.float(), group).to(value.dtype)


def _raw_all_gather(value, group, dim):
    n = torch.distributed.get_world_size(group)
    moved = value.movedim(dim, 0).contiguous()
    # a copy: 16-bit floats travel as their bytes, which every backend takes
    wire = (moved.view(torch.uint8) if moved.dtype in (torch.bfloat16,
                                                       torch.float16)
            else moved)
    out = wire.new_empty((n * wire.shape[0],) + tuple(wire.shape[1:]))
    _into(torch.distributed.all_gather_into_tensor, out, wire, group)
    return out.view(moved.dtype).movedim(0, dim)


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


def _wire(value):
    """``value`` as bytes every backend takes: 16-bit floats as uint8
    (twice the columns), other dtypes as they are."""
    if value.dtype in (torch.bfloat16, torch.float16):
        return value.contiguous().view(torch.uint8)
    return value.contiguous()


def _raw_ragged(operand, out_init, in_off, send_sz, out_off, recv_sz,
                group, transport):
    """Chunk ``d`` of ``operand`` (rows ``[in_off[d], in_off[d] +
    send_sz[d])``) lands on group rank ``d`` at row ``out_off[d]`` of its
    copy of ``out_init``; rows nothing lands on keep ``out_init``'s."""
    out = out_init.clone()
    if transport == 'ragged':
        # the split sizes of all_to_all_single are host ints: one sync.
        # Offsets are the packed prefix sums the callers build, so the
        # chunks leave from rows [0, sum(send)) in rank order and arrive
        # packed at rows [0, sum(recv)) in sender order.
        sizes = torch.cat([send_sz, recv_sz]).tolist()
        count = len(sizes) // 2
        send, recv = sizes[:count], sizes[count:]
        wire = _wire(operand[:sum(send)])
        arrived = wire.new_empty((sum(recv),) + tuple(wire.shape[1:]))
        torch.distributed.all_to_all_single(arrived, wire, recv, send,
                                            group=group)
        out[:sum(recv)] = arrived.view(out.dtype)
        return out
    if transport != 'gathered':
        raise ValueError(f'unknown ragged transport {transport!r}')
    me = torch.distributed.get_rank(group)
    senders = torch.distributed.get_world_size(group)
    every = _raw_all_gather(operand.unsqueeze(0), group, 0)   # [n, S, ...]
    meta = _raw_all_gather(torch.stack([in_off, send_sz, out_off]).to(
        torch.int64).unsqueeze(0), group, 0)                 # [n, 3, n]
    rows = torch.arange(out.shape[0], device=out.device)
    for sender in range(senders):
        source, size, target = meta[sender, :, me]
        take = (rows - target + source).clamp(0, operand.shape[0] - 1)
        inside = (rows >= target) & (rows < target + size)
        mask = inside.reshape((-1,) + (1,) * (out.dim() - 1))
        out = torch.where(mask, every[sender][take], out)
    return out


class _Ragged(torch.autograd.Function):
    @staticmethod
    def forward(ctx, operand, out_init, in_off, send_sz, out_off, recv_off,
                recv_sz, rev_out_off, group, transport):
        ctx.save_for_backward(in_off, send_sz, recv_off, recv_sz,
                              rev_out_off)
        ctx.group, ctx.transport = group, transport
        ctx.operand_shape = operand.shape
        return _raw_ragged(operand, out_init, in_off, send_sz, out_off,
                           recv_sz, group, transport)

    @staticmethod
    def backward(ctx, grad):
        in_off, send_sz, recv_off, recv_sz, rev_out_off = ctx.saved_tensors
        # my arrivals carry their gradient home, to the rows they left from
        d_operand = _raw_ragged(grad, grad.new_zeros(ctx.operand_shape),
                                recv_off, recv_sz, rev_out_off, send_sz,
                                ctx.group, ctx.transport)
        rows = torch.arange(grad.shape[0], device=grad.device)[:, None]
        arrived = ((rows >= recv_off) & (rows < recv_off + recv_sz)).any(1)
        mask = arrived.reshape((-1,) + (1,) * (grad.dim() - 1))
        d_init = torch.where(mask, torch.zeros((), dtype=grad.dtype,
                                               device=grad.device), grad)
        return (d_operand, d_init) + (None,) * 8


def ragged_all_to_all(operand, out_init, in_off, send_sz, out_off,
                      recv_off, recv_sz, rev_out_off, mesh: Mesh, axis, *,
                      transport: str = 'ragged'):
    """The reference's differentiable ragged exchange over ``axis``
    (``ops/moe.py:88``): chunk ``d`` of ``operand`` (rows ``[in_off[d],
    in_off[d] + send_sz[d])``) lands on rank ``d`` at row ``out_off[d]`` of
    its ``out_init``-shaped buffer, which keeps ``out_init`` elsewhere.
    ``recv_off``/``recv_sz`` are where this rank's arrivals sit and
    ``rev_out_off[d]`` the offset rank ``d`` sent from: the backward
    sends each arrival's gradient home. ``transport`` is ``'ragged'``
    (``all_to_all_single``, the actual rows on the wire; the offsets must
    be the packed prefix sums of the sizes) or ``'gathered'`` (every rank
    all-gathers every buffer and keeps what lands on it). Integer
    operands pass through the same transport undifferentiated."""
    group = _group(mesh, axis)
    args = (in_off, send_sz, out_off, recv_off, recv_sz, rev_out_off, group,
            transport)
    if not operand.is_floating_point():
        return _raw_ragged(operand, out_init, in_off, send_sz, out_off,
                           recv_sz, group, transport)
    return _Ragged.apply(operand, out_init, *args)


def live_axes(mesh: Mesh, axes) -> tuple:
    """Those of ``axes`` that have more than one rank, in the mesh
    order."""
    return tuple(axis for axis in AXES
                 if axis in spec_axes(axes) and mesh.shape[axis] > 1)


def _raw_permute(value, group, sources, route='p2p'):
    """This rank's arrival when group rank ``sources[r]`` sends to rank
    ``r``: over ``'gather'`` every rank all-gathers the shards and keeps
    its source's (a collective: every rank takes part), over ``'p2p'`` one
    ``isend``/``irecv`` pair (a fixed point sends nothing)."""
    dist = torch.distributed
    if len(sources) == 1:
        return value.clone()
    rank = dist.get_rank(group)
    source = sources[rank]
    if route == 'gather':
        gathered = _raw_all_gather(value.unsqueeze(0), group, 0)
        return gathered[source].clone()
    if source == rank:
        return value.clone()
    send = value.contiguous()
    out = torch.empty_like(send)
    global_rank = dist.get_global_rank
    ops = [dist.P2POp(dist.isend, send,
                      global_rank(group, sources.index(rank)), group),
           dist.P2POp(dist.irecv, out, global_rank(group, source), group)]
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


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, destinations, route):
        ctx.group, ctx.destinations, ctx.route = group, destinations, route
        sources = [destinations.index(rank)
                   for rank in range(len(destinations))]
        return _raw_permute(value, group, sources, route)

    @staticmethod
    def backward(ctx, grad):
        # the inverse permutation: each gradient goes back to its source
        return (_raw_permute(grad, ctx.group, ctx.destinations, ctx.route),
                None, None, None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group):
        ctx.group = group
        return value.view_as(value)

    @staticmethod
    def backward(ctx, grad):
        return _sum32(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group):
        return _sum32(value, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _block(value, group, dim):
    n = torch.distributed.get_world_size(group)
    if value.shape[dim] % n:
        raise ValueError(f'cannot split {value.shape[dim]} over {n} ranks')
    return value.chunk(n, dim=dim)[torch.distributed.get_rank(group)]


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(value, group, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _raw_all_gather(grad, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_all_gather(value, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.group, ctx.dim).contiguous(), None, None


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


def ppermute(value: torch.Tensor, mesh: Mesh, axis, destinations
             ) -> torch.Tensor:
    """A permutation of the shards over ``axis`` (``lax.ppermute``): rank
    ``i`` sends ``value`` to rank ``destinations[i]``; backward, the
    inverse permutation of the gradient. A pure copy, bit for bit, on
    either :attr:`~tpusystem_torch.parallel.mesh.Mesh.route`."""
    group = _group(mesh, axis)
    if group is None:
        return value
    return _Permute.apply(value, group, tuple(destinations), mesh.route)


def ring_shift(value: torch.Tensor, mesh: Mesh, axis, *,
               reverse: bool = False) -> torch.Tensor:
    """Send this shard to the next (or previous) rank on the ring: rank
    ``i`` sends to ``(i + 1) % n`` when forward (:func:`ppermute`)."""
    ring = axis_size(mesh, axis)
    step = -1 if reverse else 1
    return ppermute(value, mesh, axis,
                    [(rank + step) % ring for rank in range(ring)])


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


def _split_group(mesh: Mesh, axis):
    """The group of ``axis``, or ``None`` where it has one rank."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return None
    return _group(mesh, axis)


def copy_to(value: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Identity forward; the gradients summed over ``axis`` backward (the
    input of a column-parallel product, each rank's part of its gradient
    coming from its own columns)."""
    group = _split_group(mesh, axis)
    return value if group is None else _CopyTo.apply(value, group)


def reduce_from(value: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum over ``axis`` forward; identity backward (the partial
    products of a row-parallel product, whose sum every rank goes on
    with)."""
    group = _split_group(mesh, axis)
    return value if group is None else _ReduceFrom.apply(value, group)


def scatter_to(value: torch.Tensor, mesh: Mesh, axis, *,
               dimension: int) -> torch.Tensor:
    """This rank's block of ``dimension`` of a tensor every rank holds
    whole; backward, the blocks' gradients gathered whole."""
    group = _split_group(mesh, axis)
    if group is None:
        return value
    return _ScatterTo.apply(value, group, dimension % value.dim())


def gather_from(value: torch.Tensor, mesh: Mesh, axis, *,
                dimension: int) -> torch.Tensor:
    """The ranks' blocks of ``dimension`` gathered whole; backward, this
    rank's block of the gradient every rank holds whole."""
    group = _split_group(mesh, axis)
    if group is None:
        return value
    return _GatherFrom.apply(value, group, dimension % value.dim())


def pp_hop(value: torch.Tensor, mesh: Mesh, axis, chunks: int = 1
           ) -> torch.Tensor:
    """One pipeline stage-to-stage hop: the forward chunked ring shift
    (rank ``i`` sends to ``(i + 1) % n``, :func:`ring_shift_chunked`), whose
    backward is the reverse chunked shift of the cotangent (rank ``i`` sends
    to ``(i - 1) % n``)."""
    return ring_shift_chunked(value, mesh, axis, chunks=chunks)


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
