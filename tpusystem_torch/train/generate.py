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
sort and the argmax are PyTorch ops. Not ported yet: speculative decoding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import functional_call

from tpusystem_torch.device import resolve_device
from tpusystem_torch.ops.precision import (dequantize_streamed,
                                           quantize_streamed)
from tpusystem_torch.ops.threefry import (MASK, PRNGKey, as_key,
                                          categorical, categorical_rows,
                                          fold_in, key_tensor, split,
                                          threefry2x32)
from tpusystem_torch.train.decode_fused import (build_fused,
                                                fused_unsupported_reason)

STREAM_DTYPES = ('auto', 'float32', 'bfloat16', 'int8', 'fp8')


def _decoder(module, per_row: bool = False):
    """The module's decode-mode clone: xla attention, no dropout, logits
    output, contiguous cache (the serving engine sets ``decode_pages`` on
    its own clone). Each field is set only where the module has it, as the
    reference does (``generate.py:36-46``), so one clone serves GPT-2 and
    Llama. ``per_row`` switches the cache writes to per-row. An MoE module
    raises: the reference serves it through its module paged step, not
    ported yet."""
    if getattr(module, 'moe_experts', 0):
        raise NotImplementedError(
            'decoding an MoE model is not ported to tpusystem_torch yet '
            '(ROADMAP queue 1: MoE serving through the module paged step)')
    updates = {'decode': True}
    for field, value in (('attention', 'xla'), ('dropout', 0.0),
                         ('return_features', False), ('remat', False),
                         ('per_row_decode', per_row),
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
    # step sums wte + wpe rows in float32) and vectors (biases, norms)
    return {name: (tensor.to(dtype) if 'embedding' not in name
                   and tensor.dim() >= 2
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
