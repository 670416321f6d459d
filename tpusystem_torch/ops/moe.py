"""Mixture-of-experts FFN and expert parallelism: the port of
:mod:`tpusystem.ops.moe`.

Experts live as stacked float32 master weights with a leading ``experts``
dimension, cast to the compute dtype per use. A float32 router picks each
token's top-k experts; the chosen gates renormalize to sum to 1. Capacity
model: each expert takes at most ``capacity = int(tokens * k *
capacity_factor / experts)`` tokens (at least 1, at most all); overflow
tokens fall through the block's residual connection.

Routing is integer work and matches the reference bitwise for the same
gates: top-k takes k rounds of ``argmax`` (the first maximum wins, as
``jax.lax.top_k`` breaks ties toward the lower index), slots are granted
choice-major (every first choice before any second choice, token order
within a choice) through one stable integer sort.

Two dispatch formulations behind :class:`MoEMLP`:

* ``'sparse'`` (what ``'auto'`` picks on one device) moves only the
  O(tokens * k) routed rows, with three implementations of the row movement
  (``sparse_impl``): ``'gather'`` (the gathers-only autograd pair
  :class:`_GatherDispatch` / :class:`_GatherCombine`), ``'scatter'`` (row
  scatter and scatter-add, the A/B reference) and ``'fused'``
  (:class:`_FusedMoE`: the dispatch rides the up-projection's loads in K6,
  the weighted combine follows the down-projection in K7; the backward
  reuses both kernels with swapped operands).
* ``'dense'``: one-hot dispatch/combine einsums.

On a mesh of ranks (:mod:`tpusystem_torch.parallel`) the layer's rows are
this rank's rows of the batch, whole over ``expert`` (the step splits the
batch over ``data``/``fsdp`` only), and its expert stacks this rank's
experts (the step keeps them split over ``expert``; a whole stack is cut
here, its gradient summed over ``expert``). The sharded sparse path takes
the rank's chunk of the rows over ``(data, fsdp, seq, expert)`` on the
way in and gathers the chunks back on the way out (the conjugate pair
``scatter_to``/``gather_from``), routes the chunk with the router summed
over ``expert`` backward (``copy_to``), and moves the routed rows to their
experts' owners by one of three exchanges (``exchange``):

* ``'quota'``: each sender seats its assignments choice-major into a fixed
  per-expert quota, one even ``all_to_all`` over ``expert`` each way;
  ``schedule=OverlapSchedule(moe='overlap')`` splits the rows into pieces
  (:func:`~tpusystem_torch.parallel.schedule.moe_plan`) and issues piece
  ``k+1``'s dispatch before piece ``k``'s expert products.
* ``'ragged'``: the actual routed rows (``all_to_all_single`` with split
  sizes from the gathered count matrix), seated at the receiver in global
  ``(choice, token)`` order within the expert group;
  ``'ragged-emulated'`` the same seating over an all-gather.

The router losses are means over every row shard. ``'auto'`` falls back
to the dense path where the reference's blocker names a reason: every rank
routes the whole batch, computes its own experts and sums the partial
outputs over ``expert``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.ops.cuda.grouped_matmul import (gather_rows_matmul,
                                                     matmul_scatter_rows)
from tpusystem_torch.parallel.collectives import (_raw_all_gather,
                                                  all_gather, all_reduce_sum,
                                                  all_to_all, copy_to,
                                                  gather_from, live_axes,
                                                  ragged_all_to_all,
                                                  reduce_from, scatter_to)
from tpusystem_torch.parallel.mesh import DATA, EXPERT, FSDP, MODEL, SEQ
from tpusystem_torch.parallel.schedule import MoePlan, moe_plan
from tpusystem_torch.parallel.sharding import constrain_expert_major

DISPATCHES = ('auto', 'sparse', 'dense')
SPARSE_IMPLS = ('gather', 'scatter', 'fused')
EXCHANGES = ('quota', 'ragged', 'ragged-emulated')
ROW_AXES = (DATA, FSDP, SEQ, EXPERT)


def moe_partition_rules():
    """Sharding rules for stacked expert weights (``moe.py:1038``): experts
    over the ``expert`` axis, FFN hidden over ``model``."""
    from tpusystem_torch.parallel.mesh import EXPERT
    from tpusystem_torch.parallel.mesh import PartitionSpec as P
    return (
        (r'moe/w1$', P(EXPERT, None, 'model')),
        (r'moe/b1$', P(EXPERT, 'model')),
        (r'moe/w2$', P(EXPERT, 'model', None)),
        (r'moe/b2$', P(EXPERT, None)),
        (r'moe/router$', P()),
    )


def expert_capacity(tokens: int, experts: int, k: int,
                    capacity_factor: float) -> int:
    """Per-expert token budget (at least 1, at most all tokens)."""
    return max(1, min(tokens, int(tokens * k * capacity_factor / experts)))


def _top_k(gates, k: int):
    """``(values, indices)`` of the k largest gates per row, in descending
    order, ties to the lower index: k rounds of ``argmax`` (which returns the
    first maximum) with each winner masked."""
    remaining = gates.detach().clone()
    indices = []
    for _ in range(k):
        index = remaining.argmax(-1)
        indices.append(index)
        remaining.scatter_(-1, index[:, None], float('-inf'))
    indices = torch.stack(indices, -1)
    return gates.gather(-1, indices), indices


def _renormalized_top_k(gates, k: int):
    top_gates, top_experts = _top_k(gates, k)
    total = top_gates[:, 0]
    for choice in range(1, k):
        total = total + top_gates[:, choice]
    return top_gates / (total[:, None] + 1e-9), top_experts


def _one_hot(index, classes: int):
    """``jax.nn.one_hot``: float32, all zeros for an index out of range."""
    return (index[..., None] == torch.arange(classes, device=index.device)
            ).float()


def _mean(x):
    """Mean over dim 0 as XLA computes it: the sum times the float32
    reciprocal of the count (bitwise equal to ``jnp.mean``'s result)."""
    return x.sum(0) * (1.0 / x.shape[0])


def route_top_k(gates, k: int, capacity: int):
    """Dense routing: ``(dispatch, combine, fraction)``.

    ``dispatch`` is the ``[tokens, experts, capacity]`` 0/1 routing tensor,
    ``combine`` the same weighted by the renormalized gate, ``fraction`` the
    ``[experts]`` share of tokens whose first choice was the expert (the
    load-balance term). Slots are granted choice-major."""
    tokens, experts = gates.shape
    top_gates, top_experts = _renormalized_top_k(gates, k)
    dispatch = gates.new_zeros((tokens, experts, capacity))
    combine = gates.new_zeros((tokens, experts, capacity))
    seated = gates.new_zeros((experts,))
    for choice in range(k):
        onehot = _one_hot(top_experts[:, choice], experts)       # [N, E]
        position = torch.cumsum(onehot, 0) - 1 + seated
        seated = seated + onehot.sum(0)
        fits = (position < capacity) * onehot
        slot = _one_hot(position.to(torch.int32), capacity)      # [N, E, C]
        placed = fits[:, :, None] * slot
        dispatch = dispatch + placed
        combine = combine + placed * top_gates[:, choice][:, None, None]
    fraction = _mean(_one_hot(top_experts[:, 0], experts))
    return dispatch, combine, fraction


def _seating_positions(keys, length: int):
    """Each element's 0-based position among the elements sharing its key
    (``keys`` are small non-negative integers below ``length``), in input
    order: one stable sort and its inverted permutation. Returns
    ``(positions, counts)``."""
    order = torch.sort(keys, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.numel(), device=keys.device)
    counts = torch.bincount(keys, minlength=length)[:length]
    starts = torch.cumsum(counts, 0) - counts
    return ranks - starts[keys], counts


def route_top_k_sparse(gates, k: int, capacity: int):
    """Sort-based routing: ``(token_ids, slots, weights, fraction)`` flat
    per-assignment arrays (length ``tokens * k``, choice-major). Assignment
    ``i`` sends token ``token_ids[i]`` to buffer row ``slots[i]``
    (``experts * capacity`` when dropped) with combine weight
    ``weights[i]``. Seating matches :func:`route_top_k` exactly."""
    tokens, experts = gates.shape
    top_gates, top_experts = _renormalized_top_k(gates, k)
    expert_ids = top_experts.t().reshape(-1)                   # [k*N]
    weights = top_gates.t().reshape(-1)
    token_ids = torch.arange(tokens, device=gates.device).repeat(k)
    position, _ = _seating_positions(expert_ids, experts)
    slots = torch.where(position < capacity, expert_ids * capacity + position,
                        torch.full_like(position, experts * capacity))
    fraction = _mean(_one_hot(top_experts[:, 0], experts))
    return token_ids, slots, weights, fraction


def _invert_seating(slots, k: int, tokens: int, buffer_rows: int):
    """Buffer row -> assignment (``slot_asg``, ``k * tokens`` for an empty
    slot), buffer row -> token (``slot_token``, ``tokens`` for empty), and
    the ``[k, tokens]`` view of ``slots``."""
    assignments = k * tokens
    slot_asg = torch.full((buffer_rows,), assignments, dtype=slots.dtype,
                          device=slots.device)
    kept = slots < buffer_rows
    slot_asg[slots[kept]] = torch.arange(assignments,
                                         device=slots.device)[kept]
    slot_token = torch.where(slot_asg < assignments, slot_asg % tokens,
                             torch.full_like(slot_asg, tokens))
    return slot_asg, slot_token, slots.reshape(k, tokens)


def _take(rows, index):
    """``rows[index]`` with out-of-range indices reading zeros
    (``.at[index].get(mode='fill', fill_value=0)``)."""
    inside = index < rows.shape[0]
    taken = rows[index.clamp(max=rows.shape[0] - 1)]
    mask = inside.reshape(inside.shape + (1,) * (rows.dim() - 1))
    return torch.where(mask, taken, torch.zeros((), dtype=rows.dtype,
                                                device=rows.device))


class _GatherDispatch(torch.autograd.Function):
    """``buffer[j] = flat[slot_token[j]]`` (empty slots 0). Backward:
    ``d_flat[t]`` sums d_buffer at t's k slots — k gathers and a k-way sum,
    no scatter in either direction."""

    @staticmethod
    def forward(ctx, flat, slot_token, slots_by_choice):
        ctx.save_for_backward(slots_by_choice)
        return _take(flat, slot_token)

    @staticmethod
    def backward(ctx, d_buffer):
        (slots_by_choice,) = ctx.saved_tensors
        d_flat = sum(_take(d_buffer, slots_by_choice[choice])
                     for choice in range(slots_by_choice.shape[0]))
        return d_flat, None, None


def _combine_bwd_terms(buffer, weights, slots_by_choice, slot_token,
                       slot_asg, d_out, compute):
    """The weighted-combine backward, shared by the gather and fused impls:
    ``d_buffer`` gathers ``d_out`` by ``slot_token`` scaled by the per-slot
    gate (in ``compute``, empty slots 0); ``d_weights`` is the choice-major
    concatenation of float32 rowwise dots of the re-gathered buffer rows
    with ``d_out``."""
    w_slot = _take(weights, slot_asg)
    d_buffer = w_slot[:, None].to(compute) * _take(d_out, slot_token)
    d_weights = [(_take(buffer, slots_by_choice[choice]).float()
                  * d_out.float()).sum(-1)
                 for choice in range(slots_by_choice.shape[0])]
    return d_buffer, torch.cat(d_weights).to(weights.dtype)


class _GatherCombine(torch.autograd.Function):
    """``out[t] = sum_c weights[c, t] * buffer[slot(c, t)]`` in the buffer's
    dtype; gathers only in both directions."""

    @staticmethod
    def forward(ctx, buffer, weights, slots_by_choice, slot_token, slot_asg):
        ctx.save_for_backward(buffer, weights, slots_by_choice, slot_token,
                              slot_asg)
        k = slots_by_choice.shape[0]
        per_choice = weights.reshape(k, -1)
        out = None
        for choice in range(k):
            weighted = (_take(buffer, slots_by_choice[choice])
                        * per_choice[choice][:, None].to(buffer.dtype))
            out = weighted if out is None else out + weighted
        return out

    @staticmethod
    def backward(ctx, d_out):
        buffer, weights, slots_by_choice, slot_token, slot_asg = \
            ctx.saved_tensors
        d_buffer, d_weights = _combine_bwd_terms(
            buffer, weights, slots_by_choice, slot_token, slot_asg, d_out,
            buffer.dtype)
        return d_buffer, d_weights, None, None, None


def _gelu(x):
    # flax's nn.gelu default: the tanh approximation
    return F.gelu(x, approximate='tanh')


class _FusedMoE(torch.autograd.Function):
    """Fused sparse MoE (the reference's ``_fused_moe`` custom VJP).

    Forward: K6 gathers the token rows into the up-projection (the dispatch
    buffer never forms), bias and tanh GELU, then K7 multiplies by the
    down-projection, adds its bias, saves the rows and combines each token's
    weighted rows. Backward: the combine terms of the gather impl against
    the saved rows; ``d_w2`` and ``d_w1`` as plain products (the reference
    leaves them to XLA too); ``d_grown`` through K6 with ``transpose_rhs``
    (w2, the per-slot gate as the row scale); the GELU backward from the
    saved pre-activation; ``d_flat`` through K7 with ``transpose_rhs`` (w1,
    no bias, rows not saved). Float operands arrive in the compute dtype;
    integer seating arrays get no gradient."""

    @staticmethod
    def forward(ctx, flat, w1, b1, w2, b2, weights, slot_token, slot_asg,
                slots_by_choice, capacity):
        tokens, experts = flat.shape[0], w1.shape[0]
        clamped = slot_token.clamp(max=tokens - 1)
        valid = (slot_token < tokens).float()
        w_slot = _take(weights, slot_asg)
        up = gather_rows_matmul(flat, w1, clamped, valid,
                                rows_per_group=capacity)
        pre = up.reshape(experts, capacity, -1) + b1[:, None]
        grown = _gelu(pre).reshape(experts * capacity, -1)
        out, shrunk = matmul_scatter_rows(grown, w2, b2, slot_token, w_slot,
                                          tokens, rows_per_group=capacity)
        ctx.save_for_backward(flat, w1, b1, w2, b2, weights, slot_token,
                              slot_asg, slots_by_choice, clamped, w_slot,
                              pre, shrunk)
        ctx.capacity = capacity
        return out

    @staticmethod
    def backward(ctx, d_out):
        (flat, w1, b1, w2, b2, weights, slot_token, slot_asg,
         slots_by_choice, clamped, w_slot, pre, shrunk) = ctx.saved_tensors
        capacity = ctx.capacity
        tokens, compute = flat.shape[0], flat.dtype
        experts = w1.shape[0]
        valid = (slot_token < tokens).float()
        grown = _gelu(pre)                               # recomputed

        d_shrunk, d_weights = _combine_bwd_terms(
            shrunk, weights, slots_by_choice, slot_token, slot_asg, d_out,
            compute)
        d_shrunk3 = d_shrunk.reshape(experts, capacity, -1)
        d_w2 = torch.matmul(grown.transpose(1, 2), d_shrunk3).to(w2.dtype)
        d_b2 = d_shrunk3.float().sum(1).to(b2.dtype)

        d_grown = gather_rows_matmul(d_out, w2, clamped, w_slot,
                                     rows_per_group=capacity,
                                     transpose_rhs=True)
        d_pre = torch.ops.aten.gelu_backward(
            d_grown.reshape(experts, capacity, -1).to(pre.dtype), pre,
            approximate='tanh')
        d_b1 = d_pre.float().sum(1).to(b1.dtype)

        d_flat, _ = matmul_scatter_rows(
            d_pre.reshape(experts * capacity, -1), w1, None, slot_token,
            valid, tokens, rows_per_group=capacity, transpose_rhs=True,
            save_rows=False)
        # d_w1 needs the gathered rows the forward never formed: one gather
        expert_in = _take(flat, slot_token).reshape(experts, capacity, -1)
        d_w1 = torch.matmul(expert_in.transpose(1, 2), d_pre).to(w1.dtype)
        return (d_flat.to(flat.dtype), d_w1, d_b1, d_w2, d_b2, d_weights,
                None, None, None, None)


def init_parameter(name: str, param, generator) -> None:
    """Draw one MoE parameter in place as the reference initializes it:
    ``router`` normal(0.02); ``w1``/``w2`` flax's ``lecun_normal`` (a
    truncated normal at +-2 scaled to variance ``1 / fan_in``, fan_in the
    product of all dims but the last: experts x input width); biases 0."""
    if name == 'router':
        param.copy_(torch.randn(param.shape, generator=generator,
                                device=generator.device) * 0.02)
    elif name in ('w1', 'w2'):
        fan_in = param[..., 0].numel()
        # flax divides by the std of the unit normal truncated at +-2
        std = fan_in ** -0.5 / 0.87962566103423978
        values = torch.empty(param.shape, device=generator.device)
        nn.init.trunc_normal_(values, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        param.copy_(values * std)
    else:
        param.zero_()


def _sparse_combine(buffer, slots, token_ids, weights, tokens: int,
                    compute):
    """``out[t] = sum of weights[i] * buffer[slots[i]]`` over the
    assignments ``i`` of token ``t``, in assignment order (a dropped slot
    reads zeros), in ``compute``: the scatter impl's combine."""
    gathered = _take(buffer, slots)
    return buffer.new_zeros((tokens, buffer.shape[1]), dtype=compute).index_add(
        0, token_ids, gathered * weights[:, None].to(compute))


def _seat_rows(rows, token_ids, slots, buffer_rows: int, compute):
    """The ``[buffer_rows, dim]`` send buffer: row ``slots[i]`` holds token
    ``token_ids[i]``'s row (an assignment whose slot is out of range is
    dropped), the rest zeros; differentiable in ``rows``."""
    kept = slots < buffer_rows
    return rows.new_zeros((buffer_rows, rows.shape[1]), dtype=compute
                          ).index_put((slots[kept],),
                                      rows.to(compute)[token_ids[kept]])


def _exclusive_cumsum(counts, dim: int = 0):
    return torch.cumsum(counts, dim) - counts


class MoEMLP(nn.Module):
    """Expert FFN, the drop-in for the dense fc -> gelu -> proj block.

    ``forward(hidden)`` returns ``(output, aux_loss)``, ``aux_loss`` already
    carrying the coefficients (Switch load balance plus router z-loss).
    Parameters keep the reference's names and shapes: ``router`` ``[dim,
    experts]``, ``w1`` ``[experts, dim, mlp_ratio * dim]``, ``b1``, ``w2``,
    ``b2``, float32. ``full_capacity`` seats every assignment (capacity =
    tokens).

    ``mesh`` (a mesh of ranks) runs the expert-parallel paths of the module
    docstring, chosen as the reference chooses (``moe.py:560``): ``'auto'``
    takes the sharded sparse path unless :meth:`sharded_sparse_blocker`
    names a reason, and then the dense one; an explicit ``'sparse'`` raises
    with that reason; ``sparse_impl='fused'`` with an explicit ``'sparse'``
    raises (the grouped kernels are single-shard), under ``'auto'`` the
    exchange runs instead. ``exchange`` is ``'quota'``, ``'ragged'`` or
    ``'ragged-emulated'``; ``schedule`` an
    :class:`~tpusystem_torch.parallel.schedule.OverlapSchedule` whose
    ``moe=`` arm governs the quota exchange. After a sharded forward
    :attr:`seated` counts the assignments this rank's senders (quota) or
    experts (ragged) seated, on the device."""

    def __init__(self, dim: int, experts: int, k: int = 2,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 dtype: str = 'bfloat16', balance_coef: float = 1e-2,
                 z_coef: float = 1e-3, mesh=None, dispatch: str = 'auto',
                 exchange: str = 'quota', sparse_impl: str = 'gather',
                 full_capacity: bool = False, schedule=None, *,
                 device=None) -> None:
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f'unknown dispatch {dispatch!r}; expected '
                             "'sparse', 'dense' or 'auto'")
        if sparse_impl not in SPARSE_IMPLS:
            raise ValueError(f'unknown sparse_impl {sparse_impl!r}; '
                             "expected 'gather', 'scatter' or 'fused'")
        compute_dtype(dtype)                                # validates
        device = resolve_device(device)
        self.experts, self.k, self.mlp_ratio = experts, k, mlp_ratio
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.balance_coef, self.z_coef = balance_coef, z_coef
        self.dispatch, self.sparse_impl = dispatch, sparse_impl
        self.full_capacity = full_capacity
        self.mesh, self.exchange, self.schedule = mesh, exchange, schedule
        self.seated = None
        hidden = mlp_ratio * dim
        self.router = nn.Parameter(torch.empty(dim, experts, device=device))
        self.w1 = nn.Parameter(torch.empty(experts, dim, hidden,
                                           device=device))
        self.b1 = nn.Parameter(torch.empty(experts, hidden, device=device))
        self.w2 = nn.Parameter(torch.empty(experts, hidden, dim,
                                           device=device))
        self.b2 = nn.Parameter(torch.empty(experts, dim, device=device))
        self.reset_parameters(torch.Generator(device).manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator) -> None:
        for name, param in self.named_parameters():
            init_parameter(name, param, generator)

    def _mode(self, tokens: int) -> str:
        """``'sparse'``, ``'dense'`` or ``'sparse_sharded'``, as the
        reference picks (``moe.py:560-577``); ``tokens`` are this rank's
        rows."""
        mesh = self.mesh
        sharded = mesh is not None and getattr(mesh, 'size', 1) > 1
        if self.dispatch == 'auto':
            if not sharded:
                return 'sparse'
            return ('dense' if self.sharded_sparse_blocker(tokens)
                    else 'sparse_sharded')
        if self.dispatch == 'sparse' and sharded:
            problem = self.sharded_sparse_blocker(tokens)
            if problem:
                raise ValueError(
                    f'dispatch=sparse on a multi-device mesh: {problem} '
                    f"(use dispatch='auto' to fall back to dense)")
            return 'sparse_sharded'
        return self.dispatch

    def sharded_sparse_blocker(self, tokens: int) -> str | None:
        """Why the sharded sparse path cannot run on this layer's mesh
        (``None``: it can), the reference's reasons (``moe.py:687``).
        ``tokens`` are this rank's rows, whole over ``expert`` and
        ``model``."""
        shape = dict(self.mesh.shape)
        missing = [axis for axis in ROW_AXES if axis not in shape]
        if missing:
            return (f'mesh lacks the standard row axes {missing} the '
                    'sparse dispatch shards over')
        batch = shape[DATA] * shape[FSDP] * shape[SEQ]
        shards = batch * shape[EXPERT]
        if shape.get(MODEL, 1) > 1:
            return 'model-axis TP inside experts is dense-only'
        if self.experts % shape[EXPERT]:
            return (f'{self.experts} experts not divisible by the expert '
                    f'axis ({shape[EXPERT]})')
        if (tokens * batch) % shards:
            return (f'{tokens * batch} token rows not divisible by '
                    f'data*fsdp*seq*expert = {shards}')
        return None

    def forward(self, hidden):
        batch_shape, dim = hidden.shape[:-1], hidden.shape[-1]
        flat = hidden.reshape(-1, dim)
        tokens = flat.shape[0]
        compute = compute_dtype(self.dtype)
        mode = self._mode(tokens)
        if mode == 'sparse_sharded':
            if self.sparse_impl == 'fused' and self.dispatch == 'sparse':
                raise ValueError(
                    "sparse_impl='fused' is single-shard only; on a "
                    'multi-device mesh the sharded sparse path uses its '
                    "exchange formulation (see exchange=). Use "
                    "sparse_impl='gather' there, or dispatch='auto' to "
                    'accept the sharded formulation.')
            if self.exchange not in EXCHANGES:
                raise ValueError(f'unknown exchange {self.exchange!r}; '
                                 "expected 'quota', 'ragged' or "
                                 "'ragged-emulated'")
            output, aux = self._sharded(hidden, compute)
            return output.to(hidden.dtype), aux
        if mode == 'dense' and self.mesh is not None and self.mesh.size > 1:
            return self._dense_on_mesh(hidden, compute)

        logits = flat.float() @ self.router
        gates = torch.softmax(logits, -1)
        capacity = (tokens if self.full_capacity
                    else expert_capacity(tokens, self.experts, self.k,
                                         self.capacity_factor))
        if mode == 'sparse':
            token_ids, slots, weights, fraction = route_top_k_sparse(
                gates, self.k, capacity)
        else:
            dispatch, combine, fraction = route_top_k(gates, self.k,
                                                      capacity)
        aux = self._aux(fraction, _mean(gates), _mean(
            torch.logsumexp(logits, -1).square()))

        w1, b1 = self.w1.to(compute), self.b1.to(compute)
        w2, b2 = self.w2.to(compute), self.b2.to(compute)
        if mode == 'sparse' and self.sparse_impl in ('gather', 'fused'):
            slot_asg, slot_token, slots_by_choice = _invert_seating(
                slots, self.k, tokens, self.experts * capacity)
        if mode == 'sparse' and self.sparse_impl == 'fused':
            output = _FusedMoE.apply(flat.to(compute), w1, b1, w2, b2,
                                     weights, slot_token, slot_asg,
                                     slots_by_choice, capacity)
            return output.reshape(*batch_shape, dim).to(hidden.dtype), aux

        if mode == 'sparse':
            if self.sparse_impl == 'gather':
                expert_in = _GatherDispatch.apply(flat.to(compute),
                                                  slot_token, slots_by_choice)
            else:
                expert_in = _seat_rows(flat, token_ids, slots,
                                       self.experts * capacity, compute)
            expert_in = expert_in.reshape(self.experts, capacity, dim)
        else:
            expert_in = torch.einsum('nec,nd->ecd', dispatch.to(compute),
                                     flat.to(compute))

        shrunk = _ffn(expert_in, w1, b1, w2, b2)

        if mode == 'sparse':
            buffer = shrunk.reshape(self.experts * capacity, dim)
            if self.sparse_impl == 'gather':
                output = _GatherCombine.apply(buffer, weights,
                                              slots_by_choice, slot_token,
                                              slot_asg)
            else:
                output = _sparse_combine(buffer, slots, token_ids, weights,
                                         tokens, compute)
        else:
            output = torch.einsum('nec,ecd->nd', combine.to(compute), shrunk)
        return output.reshape(*batch_shape, dim).to(hidden.dtype), aux

    def _aux(self, fraction, mean_gates, z_term):
        """Switch load balance plus router z-loss, with the coefficients."""
        balance = self.experts * (fraction * mean_gates).sum()
        return self.balance_coef * balance + self.z_coef * z_term

    # -- expert parallelism ------------------------------------------------

    def _local_experts(self, compute) -> list:
        """``w1, b1, w2, b2`` of this rank's experts in ``compute``: a
        stack the step hands over split over ``expert`` as it is, a whole
        one cut to this rank's block, its gradient summed over ``expert``
        (every rank computes only its own block's)."""
        mesh = self.mesh
        count = self.experts // mesh.shape[EXPERT]
        start = mesh.axis_index(EXPERT) * count
        pieces = []
        for leaf in (self.w1, self.b1, self.w2, self.b2):
            if leaf.shape[0] != count:
                leaf = copy_to(leaf, mesh, EXPERT).narrow(0, start, count)
            pieces.append(leaf.to(compute))
        return pieces

    def _chunk(self, hidden):
        """This rank's chunk of the rows over ``(data, fsdp, seq,
        expert)``, ``[rows, dim]``, as the reference's row sharding cuts the
        flat global batch: over a ``seq`` axis of more than one rank the
        positions are gathered first and the rows of the batch split over
        ``(seq, expert)``."""
        mesh, dim = self.mesh, hidden.shape[-1]
        spread = mesh.shape[SEQ] > 1 and hidden.dim() >= 3
        if spread:
            hidden = gather_from(hidden, mesh, SEQ, dimension=1)
        flat = hidden.reshape(-1, dim)
        if spread:
            flat = scatter_to(flat, mesh, SEQ, dimension=0)
        return scatter_to(flat, mesh, EXPERT, dimension=0)

    def _unchunk(self, chunk, hidden):
        """The inverse of :meth:`_chunk`: this rank's rows (and positions)
        of the layer's output, ``hidden``'s shape."""
        mesh = self.mesh
        out = gather_from(chunk, mesh, EXPERT, dimension=0)
        if mesh.shape[SEQ] > 1 and hidden.dim() >= 3:
            out = all_gather(out, mesh, SEQ, dimension=0)
            whole = out.reshape(hidden.shape[0], -1, *hidden.shape[2:])
            length = hidden.shape[1]
            out = whole.narrow(1, mesh.axis_index(SEQ) * length, length)
        return out.reshape(hidden.shape)

    def _row_mean(self, value):
        """The mean of ``value`` over every row shard ``(data, fsdp, seq,
        expert)`` (the reference's ``pmean``): the sum over ``expert``
        forward only (the ``expert`` ranks' losses are one replicated loss,
        so its gradient reaches each chunk once), then over the batch
        axes, whose gradient sums too."""
        mesh = self.mesh
        total = reduce_from(value, mesh, EXPERT)
        batch = live_axes(mesh, (DATA, FSDP, SEQ))
        if batch:
            total = all_reduce_sum(total, mesh, batch)
        return total / mesh.axis_size(ROW_AXES)

    def _routed(self, rows):
        """Router logits and gates of the rank's chunk (the router's
        gradient summed over ``expert``)."""
        router = copy_to(self.router, self.mesh, EXPERT)
        logits = rows.float() @ router
        return logits, torch.softmax(logits, -1)

    def _sharded_aux(self, top_first, logits, gates):
        fraction = _mean(_one_hot(top_first, self.experts))
        return self._aux(self._row_mean(fraction),
                         self._row_mean(_mean(gates)),
                         self._row_mean(_mean(torch.logsumexp(
                             logits, -1).square())))

    def _sharded(self, hidden, compute):
        rows = self._chunk(hidden)
        pieces = self._local_experts(compute)
        if self.exchange == 'quota':
            output, aux = self._sharded_sparse(rows, pieces, compute)
        else:
            output, aux = self._sharded_ragged(rows, pieces, compute)
        return self._unchunk(output, hidden), aux

    def _expert_pass(self, recv, quota: int, pieces):
        """Seated arrivals ``[experts * quota, dim]`` (sender-major) ->
        this rank's expert FFN -> the rows in the same order."""
        senders = self.mesh.shape[EXPERT]
        local, dim = self.experts // senders, recv.shape[-1]
        expert_in = (recv.reshape(senders, local, quota, dim).transpose(0, 1)
                     .reshape(local, senders * quota, dim))
        shrunk = _ffn(expert_in, *pieces)
        return (shrunk.reshape(local, senders, quota, dim).transpose(0, 1)
                .reshape(self.experts * quota, dim))

    def _sharded_sparse(self, rows, pieces, compute):
        """The quota exchange (``moe.py:711``): each sender seats its
        chunk's assignments choice-major into ``[experts, quota]`` (quota
        its share of the capacity), one even ``all_to_all`` over
        ``expert`` hands every expert's rows to its owner (chunk ``d`` to
        rank ``d``), the owner's FFN runs on ``[local experts, senders *
        quota]`` rows, and the same exchange brings the outputs home for the
        weighted combine. Drops are decided per sender; with ample
        capacity the output is the dense path's. Under
        ``schedule.moe='overlap'`` (:func:`~tpusystem_torch.parallel.
        schedule.moe_plan`) the chunk splits into pieces, each seated into
        its own quota, and piece ``k+1``'s dispatch is issued before piece
        ``k``'s expert products; routing runs on the whole chunk."""
        mesh, experts, k = self.mesh, self.experts, self.k
        local_rows = rows.shape[0]
        logits, gates = self._routed(rows)

        def exchange(buffer):
            return all_to_all(buffer, mesh, EXPERT, split_dimension=0,
                              concat_dimension=0)

        if getattr(self.schedule, 'moe', 'gspmd') == 'overlap':
            plan = moe_plan(local_rows, mesh.shape[EXPERT], self.exchange)
        else:
            plan = MoePlan('one-shot', 1, 'moe overlap inactive')
        pieces_count = plan.pieces if plan.path == 'overlap' else 1
        size = local_rows // pieces_count
        # a sender routes at most its rows to one expert
        quota = max(1, min(size, int(size * k * self.capacity_factor
                                     / experts)))
        routed = []
        for piece in range(pieces_count):
            token_ids, slots, weights, _ = route_top_k_sparse(
                gates[piece * size:(piece + 1) * size], k, quota)
            send = _seat_rows(rows[piece * size:(piece + 1) * size],
                              token_ids, slots, experts * quota, compute)
            routed.append((send, token_ids, slots, weights))
        # the pipeline: piece p + 1's dispatch is issued before piece p's
        # expert products, piece p's return after them
        arrived = [exchange(routed[0][0])]
        outputs = []
        for piece in range(pieces_count):
            if piece + 1 < pieces_count:
                arrived.append(exchange(routed[piece + 1][0]))
            back = exchange(self._expert_pass(arrived[piece], quota,
                                              pieces))
            _, token_ids, slots, weights = routed[piece]
            outputs.append(_sparse_combine(back, slots, token_ids, weights,
                                           size, compute))
        self.seated = sum((slots < experts * quota).sum()
                          for _, _, slots, _ in routed).detach()
        output = outputs[0] if len(outputs) == 1 else torch.cat(outputs)
        _, top = _top_k(gates, k)
        return output, self._sharded_aux(top[:, 0], logits, gates)

    def _sharded_ragged(self, rows, pieces, compute):
        """The ragged exchange (``moe.py:875``): each sender compacts its
        assignments by expert, keeping ``min(rows, capacity)`` per expert
        (no more can seat), and ships the actual rows with a ``(expert,
        key)`` pair each, the key the assignment's global ``(choice,
        token)`` order in the expert group; each owner seats its
        arrivals in key order up to ``capacity`` and returns the outputs
        by the reverse exchange. ``send_bound``/``recv_bound`` are the
        reference's static buffer sizes."""
        mesh, experts, k = self.mesh, self.experts, self.k
        senders = mesh.shape[EXPERT]
        local = experts // senders
        local_rows, dim = rows.shape
        device = rows.device
        capacity = expert_capacity(local_rows * senders, experts, k,
                                   self.capacity_factor)
        send_cap = min(local_rows, capacity)
        send_bound = min(local_rows * k, experts * send_cap)
        recv_bound = senders * local * send_cap
        key_span = k * senders * local_rows
        transport = 'ragged' if self.exchange == 'ragged' else 'gathered'
        me = mesh.axis_index(EXPERT)

        logits, gates = self._routed(rows)
        top_gates, top_experts = _renormalized_top_k(gates, k)
        expert_ids = top_experts.t().reshape(-1)        # [k * rows]
        weights = top_gates.t().reshape(-1)
        token_ids = torch.arange(local_rows, device=device).repeat(k)
        choice_ids = torch.arange(k * local_rows, device=device) // local_rows
        key = choice_ids * (senders * local_rows) + me * local_rows + token_ids

        # sender-side compaction in (expert, key) order
        position, counts = _seating_positions(expert_ids, experts)
        keep = position < send_cap
        kept_counts = counts.clamp(max=send_cap)
        send_slot = torch.where(
            keep, _exclusive_cumsum(kept_counts)[expert_ids] + position,
            torch.full_like(position, send_bound))
        send_rows = _seat_rows(rows, token_ids, send_slot, send_bound,
                               compute)
        sentinel = torch.tensor([experts, key_span], device=device)
        send_meta = sentinel.repeat(send_bound, 1)
        send_meta[send_slot[keep]] = torch.stack([expert_ids, key],
                                                 1)[keep]

        # the exchange's geometry from the gathered count matrix
        sizes = kept_counts.reshape(senders, local).sum(1)
        in_off = _exclusive_cumsum(sizes)
        table = _raw_all_gather(sizes[None], mesh.group(EXPERT), 0)
        recv_sz = table[:, me]
        recv_off = _exclusive_cumsum(recv_sz)
        out_off = _exclusive_cumsum(table, 0)[me]
        rev_out_off = _exclusive_cumsum(table, 1)[:, me]
        geometry = (in_off, sizes, out_off, recv_off, recv_sz, rev_out_off)
        recv_rows = ragged_all_to_all(
            send_rows, send_rows.new_zeros((recv_bound, dim)), *geometry,
            mesh, EXPERT, transport=transport)
        recv_meta = ragged_all_to_all(
            send_meta, sentinel.repeat(recv_bound, 1), *geometry, mesh,
            EXPERT, transport=transport)

        # receiver-side seating in global (choice, token) order
        arrived_expert, arrived_key = recv_meta[:, 0], recv_meta[:, 1]
        valid = arrived_expert < experts
        mine = (arrived_expert - me * local).clamp(0, local - 1)
        seat_key = torch.where(valid, mine * key_span + arrived_key,
                               torch.full_like(mine, local * key_span))
        order = torch.sort(seat_key, stable=True).indices
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(order.numel(), device=device)
        starts = _exclusive_cumsum(torch.bincount(
            torch.where(valid, mine, torch.full_like(mine, local)),
            minlength=local + 1)[:local])
        position = ranks - starts[mine]
        seat = valid & (position < capacity)
        slot = torch.where(seat, mine * capacity + position,
                           torch.full_like(mine, local * capacity))
        expert_in = send_rows.new_zeros((local * capacity, dim)).index_put(
            (slot[seat],), recv_rows[seat])
        shrunk = _ffn(expert_in.reshape(local, capacity, dim), *pieces)
        out_rows = _take(shrunk.reshape(local * capacity, dim), slot)
        returned = ragged_all_to_all(
            out_rows, out_rows.new_zeros((send_bound, dim)), recv_off,
            recv_sz, rev_out_off, in_off, sizes, out_off, mesh, EXPERT,
            transport=transport)
        self.seated = seat.sum().detach()
        output = _sparse_combine(returned, send_slot, token_ids, weights,
                                 local_rows, compute)
        return output, self._sharded_aux(top_experts[:, 0], logits, gates)

    def _dense_on_mesh(self, hidden, compute):
        """The dense path on a mesh of ranks, the reference's global
        routing (``moe.py:606-666`` with ``_constrain``): every rank
        gathers the whole batch's rows (over the batch axes, whose
        gradient reduce-scatters), routes them all, runs its own experts'
        slots (the expert-major buffer held over ``expert``) and sums the
        partial outputs over ``expert``; it keeps its own rows. The rows
        and the router enter with their gradients summed over ``expert``,
        and the router loss, a replica on every ``expert`` rank, is
        differentiated on the first only."""
        mesh, dim = self.mesh, hidden.shape[-1]
        whole = hidden
        spread = mesh.shape[SEQ] > 1 and hidden.dim() >= 3
        if spread:
            whole = all_gather(whole, mesh, SEQ, dimension=1)
        batch = live_axes(mesh, (DATA, FSDP))
        if batch:
            whole = all_gather(whole, mesh, batch, dimension=0)
        flat = copy_to(whole, mesh, EXPERT).reshape(-1, dim)
        tokens = flat.shape[0]
        logits = flat.float() @ copy_to(self.router, mesh, EXPERT)
        gates = torch.softmax(logits, -1)
        capacity = (tokens if self.full_capacity
                    else expert_capacity(tokens, self.experts, self.k,
                                         self.capacity_factor))
        dispatch, combine, fraction = route_top_k(gates, self.k, capacity)
        aux = self._aux(fraction, _mean(gates), _mean(
            torch.logsumexp(logits, -1).square()))
        if mesh.axis_index(EXPERT):
            aux = aux.detach()
        pieces = self._local_experts(compute)
        count = pieces[0].shape[0]
        mine = slice(mesh.axis_index(EXPERT) * count,
                     (mesh.axis_index(EXPERT) + 1) * count)
        expert_in = torch.einsum('nec,nd->ecd', dispatch[:, mine].to(compute),
                                 flat.to(compute))
        expert_in = constrain_expert_major(expert_in, mesh)
        shrunk = constrain_expert_major(_ffn(expert_in, *pieces), mesh)
        output = reduce_from(torch.einsum(
            'nec,ecd->nd', combine[:, mine].to(compute), shrunk), mesh, EXPERT)
        output = output.reshape(whole.shape)
        if batch:
            rows = hidden.shape[0]
            output = output.narrow(0, mesh.axis_index(batch) * rows, rows)
        if spread:
            length = hidden.shape[1]
            output = output.narrow(1, mesh.axis_index(SEQ) * length, length)
        return output.to(hidden.dtype), aux


def _ffn(expert_in, w1, b1, w2, b2):
    """The per-expert MLP of every dispatch path, on weights already in the
    compute dtype."""
    grown = _gelu(torch.matmul(expert_in, w1) + b1[:, None])
    return torch.matmul(grown, w2) + b2[:, None]
