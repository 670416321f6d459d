"""Greedy autoregressive generation with a KV cache: the port of
:func:`tpusystem.train.generate.generate`.

``generate`` clones the LM into decode mode, prefills the prompt in one
forward pass (prompts of 512 tokens or more through the flash kernel), then
decodes one token per step. ``decode_impl='flax'`` runs each step through the
module itself; ``'fused'`` through the hand-rolled token step of
:mod:`tpusystem_torch.train.decode_fused`, whose matrix products are the
decode kernels. PyTorch runs eagerly, so the loop is a Python loop and the
host picks each step's read window from the cursor it already knows.

Parameters travel beside the module, as in the reference (``params`` is a
state dict such as :func:`tpusystem_torch.convert.params_from_jax` returns,
or ``None`` for the module's own), and are applied with
:func:`torch.func.functional_call`. Not ported yet: sampling
(``temperature > 0``, which needs the threefry port), ``int8``/``fp8``
weight streaming and speculative decoding.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from tpusystem_torch.device import resolve_device
from tpusystem_torch.train.decode_fused import (build_fused,
                                                fused_unsupported_reason)

STREAM_DTYPES = ('auto', 'float32', 'bfloat16', 'int8', 'fp8')


def _decoder(module, per_row: bool = False):
    """The module's decode-mode clone: xla attention, no dropout, logits
    output, contiguous cache (the serving engine sets ``decode_pages`` on
    its own clone). ``per_row`` switches the cache writes to per-row."""
    return module.replace(decode=True, attention='xla', dropout=0.0,
                          remat=False, per_row_decode=per_row,
                          decode_pages=None)


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
    """The param dict a decode loop streams: float32 matrices pre-cast to
    the compute dtype (``'auto'`` when that is narrower, or ``'bfloat16'``),
    or the masters untouched (``'float32'``)."""
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f'unknown stream_dtype {stream_dtype!r}; '
                         f'expected one of {STREAM_DTYPES}')
    if stream_dtype == 'float32':
        return params
    if stream_dtype in ('int8', 'fp8'):
        raise NotImplementedError(
            f"stream_dtype={stream_dtype!r} is not ported yet (ROADMAP queue "
            '1: int8/fp8 streaming with the decode kernels\' dequant)')
    if stream_dtype == 'auto':
        dtype = decoder.compute_dtype
        if dtype.itemsize >= torch.float32.itemsize:
            return params
        return _cast(params, dtype)
    return _cast(params, torch.bfloat16)


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
        stream_dtype: ``'auto'`` | ``'bfloat16'`` | ``'float32'``.
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
