"""The fused decode step: the port of :mod:`tpusystem.train.decode_fused`.

One hand-rolled GPT-2 token step whose three matrix products per layer run
through the decode kernels of :mod:`tpusystem_torch.ops.cuda.decode_matmul`:
``decode_matmul`` for qkv and for the attention output, ``decode_ffn`` for
the fc → GELU → proj chain. On a CUDA tensor those are the hand-written
kernels; on the CPU their plain versions. With ``stream_dtype='int8'`` or
``'fp8'`` the four matrices of a block are
:class:`~tpusystem_torch.ops.precision.QuantizedLeaf` s, which the kernels
read narrow (the reference's ``decode_fused.py:202-265``). The rest of the
step mirrors the module's decode mode op for op: float32 layernorms (flax's
fast-variance form, epsilon 1e-6), the bucketed cache read, the tied
float32-logit head.
Prefill runs through the module itself, on the dequantized weights, so the
cache layout and the prompt logits are the module path's own.

Contract: **the same greedy tokens as the module path** in
window-invariant arithmetic (float32 on the CPU).

Two steps: :func:`build_fused` is :func:`tpusystem_torch.train.generate`'s
contiguous-cache loop; :func:`build_fused_paged_step` the serving engine's
per-row step over the paged pool. Both write the step's keys and values
into the cache tensors in place and leave the cursor leaves as they were
(the caller advances them).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from tpusystem_torch.ops.attention import (NEG_INF, contiguous_window,
                                           paged_window)
from tpusystem_torch.ops.cuda.decode_matmul import decode_ffn, decode_matmul
from tpusystem_torch.ops.precision import dequantize_streamed, head_logits


def fused_unsupported_reason(decoder) -> str | None:
    """Why :func:`build_fused` cannot run this decode clone, or ``None``:
    the fused step is GPT-2's dense token step, unrolled, shared-cursor."""
    from tpusystem_torch.models.gpt2 import GPT2
    if not isinstance(decoder, GPT2):
        return ('the fused decode step implements the GPT2 family only '
                f'(got {type(decoder).__name__})')
    if decoder.scan_layers:
        return ('scan_layers stacks params under a leading layer dim the '
                'fused per-layer sweep does not walk')
    if decoder.moe_experts:
        return ('MoE blocks route through expert dispatch, not the FFN '
                "chain — the serving engine's flax paged step serves MoE; "
                'this fused chain does not')
    if decoder.per_row_decode:
        return ('per-row cache cursors need the scatter cache write — '
                "generate()'s fused loop is shared-cursor only; the "
                "serving engine's fused PAGED step (build_fused_paged_step) "
                'is the per-row implementation')
    return None


def fused_paged_reason(decoder) -> str | None:
    """Why :func:`build_fused_paged_step` cannot run this decode clone, or
    ``None``. The paged step owns per-row cursors and the block-table
    write; what it needs is the GPT-2 dense step (unrolled, no experts) and
    a paged layout, on one device: the TP mesh refuses (no ring arms)."""
    from tpusystem_torch.models.gpt2 import GPT2
    mesh = getattr(decoder, 'mesh', None)
    if mesh is not None and dict(getattr(mesh, 'shape', {})).get(
            'model', 1) > 1:
        return ('the fused paged step has no ring arms — its Pallas '
                'matmuls are single-device; under a TP mesh '
                "decode_impl='auto' serves through the sharded flax "
                'paged step (token-exact vs single-device)')
    if not isinstance(decoder, GPT2):
        return ('the fused paged step implements the GPT2 family only '
                f'(got {type(decoder).__name__})')
    if decoder.scan_layers:
        return ('scan_layers stacks params under a leading layer dim the '
                'fused per-layer sweep does not walk')
    if decoder.moe_experts:
        return ('MoE blocks route through expert dispatch, not the FFN '
                "chain — the engine's flax paged step serves MoE (full-"
                'capacity decode dispatch), this fused chain does not')
    if not decoder.decode_pages:
        return ('no decode_pages on this clone — the paged step needs the '
                "serving engine's block-pool cache layout")
    return None


def _layernorm(x, scale, bias):
    """flax ``nn.LayerNorm(dtype=float32)`` numerics: float32, fast
    variance (``E[x^2] - E[x]^2``), epsilon 1e-6."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + 1e-6) * scale + bias


def _softmax_read(query, keys, values, mask):
    """Masked float32 softmax attention of ``[B, H, hd]`` queries over
    ``[B, W, H, hd]`` keys and values; weights rounded to the query dtype."""
    dtype = query.dtype
    scale = query.shape[-1] ** -0.5
    scores = torch.einsum('bhd,bwhd->bhw', query.float(), keys.float())
    scores = (scores * scale).masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum('bhw,bwhd->bhd', weights.to(dtype).float(),
                        values.float()).to(dtype)


def _bucketed_attention(query, key_cache, value_cache, cursor, max_seq: int,
                        depth: int):
    """One-token read of contiguous ``[B, S, H, hd]`` caches at per-row
    depth ``cursor`` over the smallest window from 256 tokens covering the
    deepest row (``depth``, known to the host)."""
    width = contiguous_window(max_seq, depth + 1)
    mask = (torch.arange(width, device=query.device)[None, None, :]
            <= cursor[:, None, None])
    return _softmax_read(query, key_cache[:, :width], value_cache[:, :width],
                         mask)


def _paged_attention_fused(query, key_pool, value_pool, table, cursor,
                           max_seq: int, block: int, depth: int):
    """One-token read of the paged pool through ``[B, max_blocks]`` block
    tables: gather the smallest power-of-2 block window covering the
    deepest row, mask at each row's own depth. The step's own keys and
    values must already be written at their slots."""
    batch = query.shape[0]
    width = paged_window(max_seq, block, (depth + block) // block)
    tokens = (table[:, :width, None].long() * block
              + torch.arange(block, device=query.device)[None, None, :]
              ).reshape(batch, width * block)
    mask = (torch.arange(width * block, device=query.device)[None, None, :]
            <= cursor[:, None, None])
    return _softmax_read(query, key_pool[tokens], value_pool[tokens], mask)


def _block_step(params, index, hidden, attend, *, heads, compute):
    """One transformer block of the token step; ``attend(q, k, v)`` writes
    the keys and values and returns the context ``[rows, heads, hd]``."""
    rows, dim = hidden.shape
    name = f'h_{index}.'
    normed = _layernorm(hidden, params[name + 'ln_1.scale'],
                        params[name + 'ln_1.bias']).to(compute)
    qkv = decode_matmul(normed, params[name + 'attn.qkv.kernel'],
                        params[name + 'attn.qkv.bias'])
    shape = (rows, heads, dim // heads)
    query, key, value = (t.reshape(shape) for t in qkv.split(dim, -1))
    context = attend(query, key, value)
    hidden = hidden + decode_matmul(context.reshape(rows, dim),
                                    params[name + 'attn.out.kernel'],
                                    params[name + 'attn.out.bias'])
    normed = _layernorm(hidden, params[name + 'ln_2.scale'],
                        params[name + 'ln_2.bias']).to(compute)
    return hidden + decode_ffn(normed, params[name + 'fc.kernel'],
                               params[name + 'fc.bias'],
                               params[name + 'proj.kernel'],
                               params[name + 'proj.bias'], activation='gelu')


def _embed(params, tokens, positions, compute):
    # the reference sums the two rows in float32, then casts
    return (params['wte.embedding'][tokens].float()
            + params['wpe.embedding'][positions].float()).to(compute)


def _head(params, hidden, compute):
    final = _layernorm(hidden, params['ln_f.scale'], params['ln_f.bias'])
    return head_logits(final.to(compute),
                       params['wte.embedding'].to(compute), tied=True)


def build_fused_paged_step(decoder):
    """The serving engine's fused ``[rows, 1]`` token step over the paged
    pool. Returns ``step(params, cache, tokens, depth) -> (logits, cache)``:
    ``cache`` is the engine's paged cache dict, ``tokens`` ``[rows]``,
    ``depth`` the deepest row's cursor. Each row's keys and values land at
    its cursor's slot through its block table (past capacity they clamp
    onto the last, unmapped column: trash); cursors are left as they were —
    the engine advances them."""
    reason = fused_paged_reason(decoder)
    if reason is not None:
        raise ValueError(f'fused paged step unsupported: {reason}')
    heads, max_seq = decoder.heads, decoder.max_seq
    compute = decoder.compute_dtype
    _, block = decoder.decode_pages
    max_blocks = max_seq // block

    def step(params, cache, tokens, depth: int):
        cursor = cache['h_0/attn/index'].long()                  # [rows]
        hidden = _embed(params, tokens.long(), cache['position'].long(),
                        compute)
        logical = torch.clamp(cursor // block, max=max_blocks - 1)
        for index in range(decoder.layers):
            prefix = f'h_{index}/attn'
            table = cache[prefix + '/table']
            key_pool = cache[prefix + '/key']
            value_pool = cache[prefix + '/value']
            physical = torch.gather(table.long(), 1, logical[:, None])[:, 0]
            slots = physical * block + cursor % block

            def attend(query, key, value):     # called within this layer
                key_pool[slots] = key.to(key_pool.dtype)
                value_pool[slots] = value.to(value_pool.dtype)
                return _paged_attention_fused(query, key_pool, value_pool,
                                              table, cursor, max_seq, block,
                                              depth)

            hidden = _block_step(params, index, hidden, attend, heads=heads,
                                 compute=compute)
        return _head(params, hidden, compute), cache

    return step


def build_fused(decoder, steps: int, temperature: float = 0.0):
    """The fused decode runner of ``generate(decode_impl='fused')``:
    module-path prefill (flash routing included), then ``steps - 1`` fused
    token steps over the contiguous caches, each token greedy or sampled at
    ``temperature`` as ``generate``'s module path samples it. Returns
    ``run(params, prompt, rng) -> int32 [batch, prompt_len + steps]``
    (``rng`` a threefry key, split before each token)."""
    from tpusystem_torch.ops.threefry import split
    from tpusystem_torch.train.generate import _sample
    heads, max_seq = decoder.heads, decoder.max_seq
    compute = decoder.compute_dtype

    def token_step(params, cache, cursor, token, depth: int):
        hidden = _embed(params, token, cursor, compute)
        for index in range(decoder.layers):
            prefix = f'h_{index}/attn'
            key_cache = cache[prefix + '/key']
            value_cache = cache[prefix + '/value']

            def attend(query, key, value):     # called within this layer
                # uniform cursors: one slice write at the shared depth
                key_cache[:, depth] = key.to(key_cache.dtype)
                value_cache[:, depth] = value.to(value_cache.dtype)
                return _bucketed_attention(query, key_cache, value_cache,
                                           cursor, max_seq, depth)

            hidden = _block_step(params, index, hidden, attend, heads=heads,
                                 compute=compute)
        return _head(params, hidden, compute)

    @torch.no_grad()
    def run(params, prompt, rng):
        logits, cache = functional_call(
            decoder, dequantize_streamed(params, compute), (prompt,),
            {'cache': None})
        length = prompt.shape[1]
        cursor = cache['position'].long()                        # uniform
        rng, key = split(rng)
        token = _sample(logits[:, -1], temperature, key)
        emitted = [token]
        for step in range(steps - 1):
            logits = token_step(params, cache, cursor, token, length + step)
            rng, key = split(rng)
            token = _sample(logits, temperature, key)
            emitted.append(token)
            cursor = cursor + 1
        return torch.cat([prompt, torch.stack(emitted, 1)], 1).to(
            torch.int32)

    return run
