"""Greedy autoregressive generation with a KV cache: the port of
:func:`tpusystem.train.generate.generate`.

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
:func:`torch.func.functional_call`. Not ported yet: sampling
(``temperature > 0``: ``categorical`` on top of
:mod:`tpusystem_torch.ops.threefry`) and speculative decoding.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from tpusystem_torch.device import resolve_device
from tpusystem_torch.ops.precision import (dequantize_streamed,
                                           quantize_streamed)
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
    """Generate ``steps`` greedy tokens after ``prompt``.

    Args:
        module: the LM (its decode-mode clone is used).
        params: state dict of weights, or ``None`` for the module's own.
        prompt: int ``[batch, prompt_len]`` token ids.
        steps: tokens to generate per sequence.
        temperature: 0 only (greedy); sampling is not ported yet.
        rng: unused until sampling is ported.
        stream_dtype: ``'auto'`` | ``'bfloat16'`` | ``'float32'`` |
            ``'int8'`` | ``'fp8'``.
        decode_impl: ``'flax'`` | ``'fused'`` | ``'auto'``.
        device: where to run; ``None`` is the card.

    Returns:
        int32 ``[batch, prompt_len + steps]`` on ``device``.
    """
    del rng
    if steps < 1:
        raise ValueError(f'steps must be >= 1, got {steps}')
    if temperature > 0.0:
        raise NotImplementedError(
            'temperature sampling is not ported yet (ROADMAP queue 1: '
            'sampling with the threefry port)')
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
        return build_fused(decoder, steps)(params, prompt)
    return _run(decoder, steps, params, prompt)


def _run(decoder, steps: int, params: dict, prompt):
    """The module-path decode loop: prefill, then one forward per token."""
    params = _dequant(params, decoder)
    logits, cache = functional_call(decoder, params, (prompt,),
                                    {'cache': None})
    token = logits[:, -1].argmax(-1)
    emitted = [token]
    length = prompt.shape[1]
    for step in range(steps - 1):
        logits, cache = functional_call(
            decoder, params, (token[:, None],),
            {'cache': cache, 'depth': length + step})
        token = logits[:, -1].argmax(-1)
        emitted.append(token)
    return torch.cat([prompt, torch.stack(emitted, 1)], 1).to(torch.int32)
