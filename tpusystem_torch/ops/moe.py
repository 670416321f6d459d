"""Mixture-of-experts FFN: the port of :mod:`tpusystem.ops.moe`, one device.

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

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: a mesh of more than one device (the sharded quota and ragged
exchanges) and the overlap ``schedule``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.ops.cuda.grouped_matmul import (gather_rows_matmul,
                                                     matmul_scatter_rows)

DISPATCHES = ('auto', 'sparse', 'dense')
SPARSE_IMPLS = ('gather', 'scatter', 'fused')


def _not_ported(what: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               '(ROADMAP queue 1: 9. Multi-GPU parallelism, '
                               '9f. Expert and table parallelism)')


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


class MoEMLP(nn.Module):
    """Expert FFN, the drop-in for the dense fc -> gelu -> proj block.

    ``forward(hidden)`` returns ``(output, aux_loss)``, ``aux_loss`` already
    carrying the coefficients (Switch load balance plus router z-loss).
    Parameters keep the reference's names and shapes: ``router`` ``[dim,
    experts]``, ``w1`` ``[experts, dim, mlp_ratio * dim]``, ``b1``, ``w2``,
    ``b2``, float32. ``full_capacity`` seats every assignment (capacity =
    tokens). ``mesh`` (more than one device), ``exchange`` other than
    ``'quota'`` and ``schedule`` are the sharded paths, not ported yet."""

    def __init__(self, dim: int, experts: int, k: int = 2,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 dtype: str = 'bfloat16', balance_coef: float = 1e-2,
                 z_coef: float = 1e-3, mesh=None, dispatch: str = 'auto',
                 exchange: str = 'quota', sparse_impl: str = 'gather',
                 full_capacity: bool = False, schedule=None, *,
                 device=None) -> None:
        super().__init__()
        if mesh is not None and getattr(mesh, 'size', 1) > 1:
            raise _not_ported('MoE on a multi-device mesh')
        if exchange != 'quota':
            raise _not_ported(f'the {exchange!r} MoE exchange')
        if schedule is not None:
            raise _not_ported('the MoE overlap schedule')
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

    def forward(self, hidden):
        batch_shape, dim = hidden.shape[:-1], hidden.shape[-1]
        flat = hidden.reshape(-1, dim)
        tokens = flat.shape[0]
        compute = compute_dtype(self.dtype)
        mode = 'sparse' if self.dispatch == 'auto' else self.dispatch

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
        # Switch load balance: experts * <fraction dispatched * mean prob>
        balance = self.experts * (fraction * _mean(gates)).sum()
        z_term = _mean(torch.logsumexp(logits, -1).square())
        aux = self.balance_coef * balance + self.z_coef * z_term

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
                kept = slots < self.experts * capacity
                rows = flat.to(compute)[token_ids]
                expert_in = flat.new_zeros((self.experts * capacity, dim),
                                           dtype=compute).index_put(
                    (slots[kept],), rows[kept])
            expert_in = expert_in.reshape(self.experts, capacity, dim)
        else:
            expert_in = torch.einsum('nec,nd->ecd', dispatch.to(compute),
                                     flat.to(compute))

        grown = _gelu(torch.matmul(expert_in, w1) + b1[:, None])
        shrunk = torch.matmul(grown, w2) + b2[:, None]

        if mode == 'sparse':
            buffer = shrunk.reshape(self.experts * capacity, dim)
            if self.sparse_impl == 'gather':
                output = _GatherCombine.apply(buffer, weights,
                                              slots_by_choice, slot_token,
                                              slot_asg)
            else:
                gathered = _take(buffer, slots)
                output = flat.new_zeros((tokens, dim),
                                        dtype=compute).index_add(
                    0, token_ids, gathered * weights[:, None].to(compute))
        else:
            output = torch.einsum('nec,ecd->nd', combine.to(compute), shrunk)
        return output.reshape(*batch_shape, dim).to(hidden.dtype), aux
