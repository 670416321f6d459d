"""Autoregressive generation with a KV cache: the port of
:func:`tpusystem.train.generate.generate`, and the sampler the serving
engine shares with it (:func:`sample_token`).

``generate`` clones the LM into decode mode, prefills the prompt in one
forward pass (prompts of 512 tokens or more through the flash kernel), then
decodes one token per step. ``decode_impl='flax'`` runs each step through the
module itself; ``'fused'`` through the hand-rolled token step of
:mod:`tpusystem_torch.train.decode_fused`, whose matrix products are the
decode kernels. PyTorch runs eagerly, so the loop is a Python loop and the
host picks each step's read window from the cursor it already knows.

``stream_dtype='int8'`` or ``'fp8'`` quantizes the streamed matrices per
output channel (:func:`tpusystem_torch.ops.precision.quantize_streamed`):
the fused step hands the narrow leaves to the decode kernels, which widen
them on chip; the prefill and the module path run on their dequantized view
(:func:`_dequant`), as the reference's do.

Parameters travel beside the module, as in the reference (``params`` is a
state dict such as :func:`tpusystem_torch.convert.params_from_jax` returns,
or ``None`` for the module's own), and are applied with
:func:`torch.func.functional_call`.

``temperature > 0`` samples with jax's threefry draws, bit for bit the
reference's: ``rng`` is split before the first token and before every step,
and each token is ``jax.random.categorical`` of the scaled logits
(:func:`tpusystem_torch.ops.threefry.categorical`). The draw's uniforms are
one kernel on the card
(:func:`tpusystem_torch.ops.cuda.threefry.row_uniforms`); the ``log`` s, the
sort and the argmax are PyTorch ops.

:func:`speculative_generate` decodes with a draft model: each round the
draft proposes ``speculate`` tokens, one target forward verifies the
window, and every row advances by its own accepted count plus one (exact
match at temperature 0, rejection sampling above it, or a token tree of
``tree_fanout`` branches). Rounds and draft steps are Python loops; the one
device-to-host copy a round makes is the accepted counts, from which the
host advances its cursor mirrors and picks the next read windows.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import functional_call

from tpusystem_torch.device import resolve_device
from tpusystem_torch.ops.moe import _top_k
from tpusystem_torch.ops.precision import (dequantize_streamed,
                                           quantize_streamed)
from tpusystem_torch.ops.threefry import (MASK, PRNGKey, as_key,
                                          categorical, categorical_rows,
                                          fold_in, key_tensor, split,
                                          threefry2x32, uniform)
from tpusystem_torch.train.cursors import gather_rows, rewind
from tpusystem_torch.train.decode_fused import (build_fused,
                                                fused_unsupported_reason)

STREAM_DTYPES = ('auto', 'float32', 'bfloat16', 'int8', 'fp8')


def _decoder(module, per_row: bool = False):
    """The module's decode-mode clone: xla attention, no dropout, logits
    output, contiguous cache (the serving engine sets ``decode_pages`` on
    its own clone). Each field is set only where the module has it, as the
    reference does (``generate.py:36-46``), so one clone serves GPT-2 and
    Llama; the mesh is dropped (the serving engine sets its own); an MoE
    GPT-2's expert layers dispatch at full capacity in it and its router
    loss is dropped. ``per_row`` switches the cache writes to
    per-row (the speculative paths and the serving engine)."""
    updates = {'decode': True}
    for field, value in (('attention', 'xla'), ('dropout', 0.0),
                         ('return_features', False), ('remat', False),
                         ('mesh', None), ('per_row_decode', per_row),
                         ('decode_pages', None)):
        if hasattr(module, field):
            updates[field] = value
    return module.replace(**updates)


def param_dict(module, params, device) -> dict:
    """``params`` (a state dict, or ``None`` for the module's own weights)
    as plain tensors on ``device``."""
    if params is None:
        params = dict(module.named_parameters())
    return {name: tensor.detach().to(device)
            for name, tensor in params.items()}


def _cast(params: dict, dtype: torch.dtype) -> dict:
    # leaves consumed in float32 stay float32: embedding tables (the embed
    # step sums wte + wpe rows in float32), MoE routers (float32 gate
    # logits) and vectors (biases, norms)
    return {name: (tensor.to(dtype) if 'embedding' not in name
                   and 'router' not in name and tensor.dim() >= 2
                   and tensor.dtype == torch.float32 else tensor)
            for name, tensor in params.items()}


def _stream_params(decoder, params: dict, stream_dtype: str) -> dict:
    """The param dict a decode loop streams (``generate.py:52-77``): float32
    matrices pre-cast to the compute dtype (``'auto'`` when that is
    narrower, or ``'bfloat16'``), quantized to per-channel-scaled
    :class:`~tpusystem_torch.ops.precision.QuantizedLeaf` s (``'int8'``,
    ``'fp8'``), or the masters untouched (``'float32'``)."""
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f'unknown stream_dtype {stream_dtype!r}; '
                         f'expected one of {STREAM_DTYPES}')
    if stream_dtype == 'float32':
        return params
    if stream_dtype in ('int8', 'fp8'):
        return quantize_streamed(params, stream_dtype)
    if stream_dtype == 'auto':
        dtype = decoder.compute_dtype
        if dtype.itemsize >= torch.float32.itemsize:
            return params
        return _cast(params, dtype)
    return _cast(params, torch.bfloat16)


def streamed_bytes(module, params, stream_dtype: str) -> int:
    """Bytes of :func:`generate`'s streamed param dict under one
    ``stream_dtype`` (``generate.py:117``): what a decode step reads of the
    weights, narrow values and their scales counted for the quantized
    modes, embeddings and vectors as they stay."""
    streamed = _stream_params(_decoder(module),
                              param_dict(module, params, module.device),
                              stream_dtype)
    return sum(leaf.nbytes for leaf in streamed.values())


def _dequant(params: dict, decoder) -> dict:
    """The dequantized view of a streamed dict in the module's compute
    dtype, for the prefill and the module path (``generate.py:128``); the
    same dict when nothing is quantized."""
    return dequantize_streamed(params, decoder.compute_dtype)


def _sample(logits, temperature: float, key):
    """One token a row of ``logits [batch, vocab]`` (``generate.py:138``):
    the argmax at temperature 0, else ``jax.random.categorical(key,
    logits / temperature)``, one draw of ``[batch, vocab]`` under ``key``."""
    if temperature == 0.0:
        return logits.argmax(-1)
    # a one-element tensor, not a Python scalar: PyTorch's CUDA division by
    # a scalar multiplies by its reciprocal, an ulp off the quotient
    scaled = logits.float() / torch.tensor([temperature], device=logits.device)
    return categorical(key, scaled)


def sampling_key(seed: int, position: int):
    """The threefry key of one token slot (``generate.py:145``),
    ``fold_in(PRNGKey(seed), position)``: a pure function of ``(seed,
    position)``, derived on the host."""
    return fold_in(PRNGKey(seed), position)


def sampling_keys(seeds, positions) -> np.ndarray:
    """:func:`sampling_key` of many ``(seed, position)`` pairs in one
    vectorised hash on the host: int64 ``[n, 2]`` words."""
    seeds = np.asarray(seeds, np.int64) & MASK
    words = threefry2x32((np.zeros_like(seeds), seeds), 0,
                         np.asarray(positions, np.int64) & MASK)
    return np.stack(words, -1)


def _nucleus(scaled, top_k, top_p):
    """The top-k / top-p filter of :func:`sample_rows` on scaled logits
    ``[rows, vocab]``: ``(filtered, order, keep, mass_before)``, the last
    three in each row's stable descending order (ties by id)."""
    order = torch.sort(-scaled, dim=-1, stable=True).indices
    ranked = torch.gather(scaled, -1, order)
    rank = torch.arange(scaled.shape[-1], device=scaled.device)[None]
    keep = torch.where(top_k[:, None] > 0, rank < top_k[:, None], True)
    # jax.nn.softmax's arithmetic: exp(x - max) / sum
    unnormalized = torch.exp(ranked - ranked[:, :1])
    probs = unnormalized / unnormalized.sum(-1, keepdim=True)
    mass_before = torch.cumsum(probs, -1) - probs
    keep = keep & (mass_before < top_p.float()[:, None])
    filtered = torch.empty_like(scaled).scatter_(
        -1, order, torch.where(keep, ranked, torch.full_like(ranked,
                                                             -math.inf)))
    return filtered, order, keep, mass_before


def sample_rows(logits, keys, temperature, top_k, top_p, mask):
    """:func:`sample_token` for every row of ``logits [rows, vocab]`` at
    once, each row at its own key (``keys``, int64 ``[rows, 2]``) and its own
    ``temperature``, ``top_k``, ``top_p`` (``[rows]`` tensors) and ``mask``
    (bool ``[rows, vocab]``), all on the logits' device."""
    logits = torch.where(mask, logits.float(), -math.inf)
    greedy = logits.argmax(-1)
    # the 1e-6 floor keeps the temperature 0 branch finite (its value is
    # discarded by the final where, but NaNs would poison both sides)
    scaled = logits / torch.clamp(temperature.float(), min=1e-6)[:, None]
    sampled = categorical_rows(keys, _nucleus(scaled, top_k, top_p)[0])
    return torch.where(temperature > 0, sampled, greedy)


def sample_token(logits, seed, position, temperature, top_k, top_p, mask):
    """Deterministically sample one token from one ``[vocab]`` logits row
    (``generate.py:156-197``): a pure function of ``(logits, seed, position,
    temperature, top_k, top_p, mask)``.

    * ``mask`` (bool ``[vocab]``) sets disallowed tokens to ``-inf`` first.
    * ``temperature == 0`` (or ``top_k == 1``) is the argmax, bitwise.
    * ``top_k > 0`` keeps the k highest scaled logits, ``top_p < 1`` the
      smallest prefix of the sorted distribution whose mass *before* each
      token stays under ``top_p`` (the first token always survives); ties
      break by the stable descending sort, lowest id first.
    * the draw is ``jax.random.categorical`` at
      :func:`sampling_key` ``(seed, position)``.

    ``logits`` and ``mask`` are tensors; the rest are Python numbers. Returns
    a 0-dim int64 tensor on the logits' device."""
    device = logits.device
    keys = key_tensor([sampling_key(seed, position)], device)
    token = sample_rows(
        logits.reshape(1, -1), keys,
        torch.tensor([temperature], dtype=torch.float32, device=device),
        torch.tensor([top_k], device=device),
        torch.tensor([top_p], dtype=torch.float32, device=device),
        torch.as_tensor(mask, device=device).reshape(1, -1))
    return token[0]


def _resolve_impl(decode_impl: str, reason: str | None, decoder,
                  device: torch.device) -> str:
    """'flax' | 'fused' for this decode clone; ``reason`` is why the fused
    step cannot run it (``None`` when it can). 'auto' picks 'fused' on the
    card, where the decode kernels run (bfloat16 models), and 'flax'
    elsewhere."""
    if decode_impl not in ('auto', 'flax', 'fused'):
        raise ValueError(f'unknown decode_impl {decode_impl!r}; '
                         "expected 'auto', 'flax' or 'fused'")
    if decode_impl == 'flax':
        return 'flax'
    if decode_impl == 'fused':
        if reason is not None:
            raise ValueError(
                f"decode_impl='fused' cannot run this module: {reason}")
        return 'fused'
    if (reason is None and device.type == 'cuda'
            and decoder.compute_dtype == torch.bfloat16):
        return 'fused'
    return 'flax'


@torch.no_grad()
def generate(module, params, prompt, *, steps: int,
             temperature: float = 0.0, rng=None, stream_dtype: str = 'auto',
             decode_impl: str = 'auto', device=None):
    """Generate ``steps`` tokens after ``prompt``.

    Args:
        module: the LM (its decode-mode clone is used).
        params: state dict of weights, or ``None`` for the module's own.
        prompt: int ``[batch, prompt_len]`` token ids.
        steps: tokens to generate per sequence.
        temperature: 0 is the greedy argmax; otherwise categorical sampling
            of ``logits / temperature``.
        rng: threefry key (two 32-bit words, e.g. ``jax.random.PRNGKey``'s
            array), required when ``temperature > 0``.
        stream_dtype: ``'auto'`` | ``'bfloat16'`` | ``'float32'`` |
            ``'int8'`` | ``'fp8'``.
        decode_impl: ``'flax'`` | ``'fused'`` | ``'auto'``.
        device: where to run; ``None`` is the card.

    Returns:
        int32 ``[batch, prompt_len + steps]`` on ``device``.
    """
    if steps < 1:
        raise ValueError(f'steps must be >= 1, got {steps}')
    if temperature > 0.0 and rng is None:
        raise ValueError('temperature sampling needs an rng key')
    rng = as_key(rng) if rng is not None else PRNGKey(0)
    device = resolve_device(device)
    decoder = _decoder(module)
    params = _stream_params(decoder, param_dict(module, params, device),
                            stream_dtype)
    prompt = torch.as_tensor(prompt, device=device).long()
    if prompt.shape[1] + steps > decoder.max_seq:
        raise ValueError(
            f'prompt ({prompt.shape[1]}) + steps ({steps}) exceeds the '
            f'cache capacity max_seq={decoder.max_seq}')
    if _resolve_impl(decode_impl, fused_unsupported_reason(decoder), decoder,
                     device) == 'fused':
        return build_fused(decoder, steps, temperature)(params, prompt, rng)
    return _run(decoder, steps, temperature, params, prompt, rng)


def _run(decoder, steps: int, temperature: float, params: dict, prompt,
         rng):
    """The module-path decode loop: prefill, then one forward per token;
    ``rng`` is split before each token, as the reference's scan splits it
    (``generate.py:669-696``)."""
    params = _dequant(params, decoder)
    logits, cache = functional_call(decoder, params, (prompt,),
                                    {'cache': None})
    rng, key = split(rng)
    token = _sample(logits[:, -1], temperature, key)
    emitted = [token]
    length = prompt.shape[1]
    for step in range(steps - 1):
        logits, cache = functional_call(
            decoder, params, (token[:, None],),
            {'cache': cache, 'depth': length + step})
        rng, key = split(rng)
        token = _sample(logits[:, -1], temperature, key)
        emitted.append(token)
    return torch.cat([prompt, torch.stack(emitted, 1)], 1).to(torch.int32)


def _softmax(logits, temperature: float):
    """``jax.nn.softmax(logits.astype(float32) / temperature)`` over the
    last dim with jax's arithmetic, ``exp(x - max) / sum`` (the division by
    a one-element tensor, as :func:`_sample` divides)."""
    scaled = logits.float() / torch.tensor([temperature],
                                           device=logits.device)
    unnormalized = torch.exp(scaled - scaled.amax(-1, keepdim=True))
    return unnormalized / unnormalized.sum(-1, keepdim=True)


@torch.no_grad()
def speculative_generate(module, params, prompt, *, steps: int,
                         draft_module, draft_params, speculate: int = 4,
                         temperature: float = 0.0, rng=None,
                         stream_dtype: str = 'auto', tree_fanout: int = 1,
                         device=None):
    """Generation accelerated by a draft model (``generate.py:299-400``).

    Each round the draft proposes ``speculate`` tokens one at a time and the
    target verifies the ``[token, drafts]`` window in one forward; every row
    emits its accepted prefix plus one corrected token, so a round yields 1
    to ``speculate + 1`` tokens a row, and a bad draft costs speed only:

    * ``temperature == 0``: a draft is accepted where it equals the
      target's argmax, so the output is the target's greedy decode (in
      window-invariant arithmetic: float32 on the CPU);
    * ``temperature > 0``: draft ``d`` is accepted with probability
      ``min(1, p(d) / q(d))`` and a rejection resamples from
      ``norm(max(0, p - q))`` (from ``p`` when every draft was accepted),
      with the reference's key chain, so the output follows the target's
      sampling distribution and equals the reference's draws for the same
      ``rng``;
    * ``tree_fanout = F > 1`` (greedy only): each sequence drafts ``F``
      branches (the draft's top-F first tokens, each continued greedily)
      verified as extra rows of the same forward; the longest accepted
      branch wins and its cache rows are copied over its siblings'.

    Both caches keep per-row cursors and rewind to each row's accepted
    depth; rows that reach ``steps`` idle, their cursors parked at the
    prompt end, until the slowest row finishes. ``stream_dtype`` applies to
    both param dicts. Returns int32 ``[batch, prompt_len + steps]`` on
    ``device`` (``None``: the card). ``speculative_generate.rounds`` counts
    the last call's rounds (its verify forwards)."""
    if steps < 1:
        raise ValueError(f'steps must be >= 1, got {steps}')
    if speculate < 1:
        raise ValueError(f'speculate must be >= 1, got {speculate}')
    if tree_fanout < 1:
        raise ValueError(f'tree_fanout must be >= 1, got {tree_fanout}')
    if tree_fanout > 1 and temperature > 0.0:
        raise ValueError(
            'tree_fanout > 1 implements greedy token-tree verify only; '
            'rejection-sampling over trees is not implemented — use '
            'tree_fanout=1 for temperature sampling')
    if temperature > 0.0 and rng is None:
        raise ValueError('temperature sampling needs an rng key')
    rng = as_key(rng) if rng is not None else PRNGKey(0)
    device = resolve_device(device)
    decoder = _decoder(module, per_row=True)
    drafter = _decoder(draft_module, per_row=True)
    params = _stream_params(decoder, param_dict(module, params, device),
                            stream_dtype)
    draft_params = _stream_params(
        drafter, param_dict(draft_module, draft_params, device),
        stream_dtype)
    prompt = torch.as_tensor(prompt, device=device).long()
    speculative_generate.rounds = 0
    needed = prompt.shape[1] + steps + speculate + 1
    capacity = min(decoder.max_seq, drafter.max_seq)
    if needed > capacity:
        raise ValueError(
            f'prompt + steps + speculate + 1 = {needed} exceeds the cache '
            f'capacity max_seq={capacity} (verification overshoots by up to '
            f'speculate tokens before rewinding)')
    if tree_fanout > 1:
        if tree_fanout > drafter.vocab_size:
            raise ValueError(f'tree_fanout ({tree_fanout}) exceeds the '
                             f'draft vocab ({drafter.vocab_size})')
        return _speculative_tree(decoder, drafter, steps, speculate,
                                 tree_fanout, params, draft_params, prompt)
    return _speculative(decoder, drafter, steps, speculate, temperature,
                        params, draft_params, prompt, rng)


speculative_generate.rounds = 0


def _emit(drafts, accepted, correction):
    """``[rows, K + 1]``: each row's accepted drafts, then its correction,
    then zeros."""
    positions = torch.arange(drafts.shape[1] + 1,
                             device=drafts.device)[None]
    padded = torch.nn.functional.pad(drafts, (0, 1))
    return torch.where(positions < accepted[:, None], padded,
                       torch.where(positions == accepted[:, None],
                                   correction[:, None],
                                   torch.zeros_like(padded)))


def _accepted(drafts, candidates):
    """Each row's count of leading drafts equal to the target's choices."""
    matches = (drafts == candidates[:, :drafts.shape[1]]).long()
    return torch.cumprod(matches, 1).sum(1)


def draft_tree(drafter, params: dict, cache: dict, token, depth: int,
               speculate: int, fanout: int):
    """The greedy draft of a token tree: ``speculate + 1`` draft steps from
    ``token`` (the last consumes the last draft, so a fully accepted
    branch's cache already holds its KV), the first fanning each group of
    ``fanout`` adjacent rows over the draft's top tokens (row ``f`` of a
    group takes the ``f``-th; sibling rows see identical logits), the rest
    greedy. ``depth`` is the deepest row's cursor before the first step.
    Returns ``(drafts [rows, speculate], cache)``."""
    branch = torch.arange(token.shape[0], device=token.device) % fanout
    drafts = []
    for index in range(speculate + 1):
        logits, cache = functional_call(
            drafter, params, (token[:, None],),
            {'cache': cache, 'depth': depth + index})
        logits = logits[:, -1]
        if index == 0 and fanout > 1:
            # jax.lax.top_k's order: most probable first, ties to the lower
            # index (the router's top-k)
            token = _top_k(logits, fanout)[1].gather(1, branch[:, None])[:, 0]
        else:
            token = logits.argmax(-1)
        drafts.append(token)
    return torch.stack(drafts[:speculate], 1), cache


def pick_winners(drafts, candidates, fanout: int):
    """Each group's winning branch of a verified tree: the branch with the
    longest accepted prefix, ties to the lowest (the draft's most probable).
    Returns ``(accepted [groups], winning rows [groups], emitted [groups,
    speculate + 1])``, ``emitted`` the winner's accepted drafts, its
    correction (the target's choice after them) and zeros."""
    per_group = _accepted(drafts, candidates).reshape(-1, fanout)
    winner = per_group.argmax(1)               # the first maximum
    accepted = per_group.gather(1, winner[:, None])[:, 0]
    rows = torch.arange(per_group.shape[0], device=drafts.device) * fanout \
        + winner
    correction = candidates[rows].gather(1, accepted[:, None])[:, 0]
    return accepted, rows, _emit(drafts[rows], accepted, correction)


def _record(out, emitted, produced, done):
    """Write the rows still producing into their next ``K + 1`` columns of
    ``out`` (idle rows write nowhere)."""
    live = np.flatnonzero(~done)
    if live.size:
        rows = torch.as_tensor(live, device=out.device)
        columns = (torch.as_tensor(produced[live], device=out.device)[:, None]
                   + torch.arange(emitted.shape[1], device=out.device)[None])
        out[rows[:, None], columns] = emitted[rows]


def _speculative(decoder, drafter, steps: int, K: int, temperature: float,
                 params: dict, draft_params: dict, prompt, rng):
    """The linear draft-and-verify loop (``generate.py:407-535``). The
    host mirrors ``produced`` and ``cursor`` advance from each round's
    accepted counts, the round's one device-to-host copy."""
    batch, prefix = prompt.shape
    device = prompt.device
    params, draft_params = (_dequant(params, decoder),
                            _dequant(draft_params, drafter))
    tlogits, tcache = functional_call(decoder, params, (prompt,),
                                      {'cache': None})
    _, dcache = functional_call(drafter, draft_params, (prompt,),
                                {'cache': None})
    rng, key = split(rng)
    token = _sample(tlogits[:, -1], temperature, key)
    # padded so a full window write at the last offset stays in bounds
    out = torch.zeros((batch, steps + K + 1), dtype=torch.long,
                      device=device)
    out[:, 0] = token
    produced = np.ones(batch, np.int64)
    cursor = np.full(batch, prefix, np.int64)
    while produced.min() < steps:
        speculative_generate.rounds += 1
        rng, draft_rng, accept_rng, fix_rng = split(rng, 4)
        done = produced >= steps
        depth = int(cursor.max())
        # K+1 draft steps: the last consumes d_K so the draft cache holds
        # its KV when every draft is accepted (its proposal is unused)
        drafts, draft_logits, tok = [], [], token
        for index, key in enumerate(split(draft_rng, K + 1)):
            logits, dcache = functional_call(
                drafter, draft_params, (tok[:, None],),
                {'cache': dcache, 'depth': depth + index})
            logits = logits[:, -1]
            tok = _sample(logits, temperature, key)
            drafts.append(tok)
            draft_logits.append(logits)
        drafts = torch.stack(drafts[:K], 1)                      # [B, K]
        window = torch.cat([token[:, None], drafts], 1)
        vlogits, tcache = functional_call(decoder, params, (window,),
                                          {'cache': tcache, 'depth': depth})
        if temperature == 0.0:
            candidates = vlogits.argmax(-1)
            accepted = _accepted(drafts, candidates)
            correction = candidates.gather(1, accepted[:, None])[:, 0]
        else:
            accepted, correction = _rejection_sample(
                vlogits, torch.stack(draft_logits[:K], 1), drafts,
                temperature, accept_rng, fix_rng)
        emitted = _emit(drafts, accepted, correction)
        _record(out, emitted, produced, done)
        taken = accepted.cpu().numpy()
        advance = np.where(done, 0, taken + 1)
        produced = produced + advance
        cursor = cursor + advance
        # rows at or past `steps` keep drafting and verifying until the
        # slowest row finishes: their cursors park at the prompt end so
        # the dead writes stay inside the capacity checked above
        cursor = np.where(produced >= steps, np.minimum(cursor, prefix),
                          cursor)
        token = torch.where(torch.as_tensor(done, device=device), token,
                            emitted.gather(1, accepted[:, None])[:, 0])
        at = torch.as_tensor(cursor, device=device)
        tcache, dcache = rewind(tcache, at), rewind(dcache, at)
    return torch.cat([prompt, out[:, :steps]], 1).to(torch.int32)


def _rejection_sample(vlogits, draft_logits, drafts, temperature: float,
                      accept_rng, fix_rng):
    """Rejection-sampling acceptance (``generate.py:488-514``): draft ``d``
    is accepted when ``u * q(d) < p(d)`` for ``u = uniform(accept_rng,
    (batch, K))``; the correction is ``categorical(fix_rng, log(residual +
    1e-20))`` at each row's first rejection, ``residual = max(0, p - q)``
    (``p`` itself where every draft was accepted, ``q`` being 0 past the
    window, or where the residual's mass is under 1e-9). Returns
    ``(accepted, correction)``."""
    batch, K = drafts.shape
    p_dist = _softmax(vlogits, temperature)                      # [B, K+1, V]
    q_dist = _softmax(draft_logits, temperature)                 # [B, K, V]
    p_draft = p_dist[:, :K].gather(-1, drafts[..., None])[..., 0]
    q_draft = q_dist.gather(-1, drafts[..., None])[..., 0]
    uniforms = uniform(accept_rng, (batch, K), device=vlogits.device)
    accepts = (uniforms * q_draft < p_draft).long()
    accepted = torch.cumprod(accepts, 1).sum(1)
    rows = torch.arange(batch, device=vlogits.device)
    p_at = p_dist[rows, accepted]                                # [B, V]
    q_at = torch.nn.functional.pad(q_dist, (0, 0, 0, 1))[rows, accepted]
    residual = torch.clamp(p_at - q_at, min=0.0)
    degenerate = residual.sum(-1, keepdim=True) < 1e-9
    residual = torch.where(degenerate, p_at, residual)
    correction = categorical(fix_rng, torch.log(residual + 1e-20))
    return accepted, correction


def _speculative_tree(decoder, drafter, steps: int, K: int, fanout: int,
                      params: dict, draft_params: dict, prompt):
    """Greedy token-tree verify (``generate.py:542-663``): row ``b * F +
    f`` is branch ``f`` of sequence ``b``; the draft fans out over its
    top-F at step 0 and continues each branch greedily, one target forward
    verifies every branch, and the branch with the longest accepted prefix
    wins (ties to the lowest branch, the draft's most probable), its cache
    rows copied over its siblings' before both caches rewind."""
    batch, prefix = prompt.shape
    device = prompt.device
    F = fanout
    params, draft_params = (_dequant(params, decoder),
                            _dequant(draft_params, drafter))
    prompt_wide = prompt.repeat_interleave(F, 0)        # branches adjacent
    tlogits, tcache = functional_call(decoder, params, (prompt_wide,),
                                      {'cache': None})
    _, dcache = functional_call(drafter, draft_params, (prompt_wide,),
                                {'cache': None})
    token = tlogits[:, -1].argmax(-1)
    out = torch.zeros((batch, steps + K + 1), dtype=torch.long,
                      device=device)
    out[:, 0] = token[::F]
    produced = np.ones(batch, np.int64)
    cursor = np.full(batch * F, prefix, np.int64)
    while produced.min() < steps:
        speculative_generate.rounds += 1
        done = produced >= steps
        depth = int(cursor.max())
        drafts, dcache = draft_tree(drafter, draft_params, dcache, token,
                                    depth, K, F)
        window = torch.cat([token[:, None], drafts], 1)
        vlogits, tcache = functional_call(decoder, params, (window,),
                                          {'cache': tcache, 'depth': depth})
        accepted_w, win_rows, emitted = pick_winners(
            drafts, vlogits.argmax(-1), F)
        _record(out, emitted, produced, done)
        taken = accepted_w.cpu().numpy()
        advance = np.where(done, 0, taken + 1)
        produced = produced + advance
        cursor = cursor + np.repeat(advance, F)
        # park finished groups' cursors at the prompt end
        cursor = np.where(np.repeat(produced >= steps, F),
                          np.minimum(cursor, prefix), cursor)
        next_token = emitted.gather(1, accepted_w[:, None])[:, 0]
        token = torch.where(torch.as_tensor(np.repeat(done, F),
                                            device=device),
                            token, next_token.repeat_interleave(F))
        # losing branches inherit the winner's cache rows, then every row
        # rewinds to its group's accepted depth
        rowmap = win_rows.repeat_interleave(F)
        at = torch.as_tensor(cursor, device=device)
        tcache = rewind(gather_rows(tcache, rowmap), at)
        dcache = rewind(gather_rows(dcache, rowmap), at)
    return torch.cat([prompt, out[:, :steps]], 1).to(torch.int32)
