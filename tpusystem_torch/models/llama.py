"""Llama-3 language model family: the port of :mod:`tpusystem.models.llama`.

Decoder-only transformer with rotary position embeddings, grouped-query
attention, a SwiGLU FFN, RMSNorm, no biases and an untied LM head.
Parameters keep the flax layout and names of the reference
(``layer_0.attn.q.kernel`` is a ``[in, out]`` kernel, ``lm_head.kernel`` is
``[dim, vocab]``), so :func:`tpusystem_torch.convert.params_from_jax` carries
a JAX param tree over name for name. Parameters are float32 masters;
activations run in ``dtype`` (bfloat16 by default), rounding where the
reference rounds:

* the embedding lookup is float32, then cast to the compute dtype;
* a dense layer multiplies in the compute dtype (``nn.Dense(dtype=bf16,
  use_bias=False)``);
* RMSNorm runs in float32, ``x * rsqrt(mean(x^2) + 1e-5) * scale``, and
  returns the input dtype;
* rotary rotates **interleaved** pairs ``(x[..., 0::2], x[..., 1::2])`` in
  float32 at absolute positions (not the half-split ``rotate_half``);
* SwiGLU ``down(silu(gate(x)) * up(x))`` runs in the compute dtype.

KV stays at ``kv_heads`` in the decode caches; the attention functions of
:mod:`tpusystem_torch.ops.attention` broadcast it over each query-head
group, and the flash kernel maps query head ``h`` to kv head
``h // group``. ``decode=True`` is the KV-cache mode: ``forward(tokens,
cache)`` returns ``(logits, cache)``, with each layer's rotary positions
read from that layer's cursor (``layer_{i}/attn/index``) before the call
advances it; there is no model-level ``position`` leaf. ``decode_pages``
switches to the serving engine's paged pool.

Training runs through ``attention='flash'``: K1 forward, and the fused
backward K2b for GQA (K2a for MHA past 1,024 keys), at head dims 16 to
128; ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat``).

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: ``scan_layers`` / ``scan_unit``, and the multi-device knobs ``mesh``
and ``schedule``.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.models.gpt2 import Dense, Embed
from tpusystem_torch.ops.attention import attend, cached_attention
from tpusystem_torch.ops.precision import head_logits
from tpusystem_torch.registry import register

# the std of the unit normal truncated at +-2: flax's truncated_normal
# divides by it so the variance stays 1 / fan_in
TRUNCATED_STD = 0.87962566103423978


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               f'(ROADMAP queue 1: {item})')


def rotary_embedding(positions, head_dim: int, theta: float = 500_000.0):
    """``(cos, sin)`` tables of shape ``[*positions.shape, head_dim / 2]``,
    float32. ``positions`` is ``[len]`` for training and prefill, or
    ``[batch, len]`` when rows decode at their own cursors."""
    frequencies = 1.0 / theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim)
    angles = positions.float()[..., None] * frequencies
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(tensor, cos, sin):
    """Rotate the interleaved pairs ``(x_even, x_odd)`` of ``[batch, len,
    heads, head_dim]`` by the position angle, in float32; returns the input
    dtype. Tables are ``[len, head_dim / 2]`` (shared by the batch) or
    ``[batch, len, head_dim / 2]`` (per-row positions)."""
    dtype = tensor.dtype
    paired = tensor.float().reshape(*tensor.shape[:-1], -1, 2)
    even, odd = paired[..., 0], paired[..., 1]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    rotated = torch.stack((even * cos - odd * sin, even * sin + odd * cos),
                          dim=-1)
    return rotated.reshape(tensor.shape).to(dtype)


class RMSNorm(nn.Module):
    """Root-mean-square normalization in float32, returned in the input
    dtype; the param is ``scale``."""

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 device) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, hidden):
        dtype = hidden.dtype
        hidden = hidden.float()
        variance = (hidden * hidden).mean(-1, keepdim=True)
        return (hidden * torch.rsqrt(variance + self.epsilon)
                * self.scale).to(dtype)


class _HeadKernel(nn.Module):
    """The bare ``lm_head.kernel`` ``[dim, vocab]``, float32, untied."""

    def __init__(self, dim: int, vocab: int, *, device) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(dim, vocab, device=device))


class LlamaAttention(nn.Module):
    """Causal grouped-query attention with rotary embeddings. ``attention(q,
    k, v)`` is the kernel (forward attention or a decode cache) the model
    chose; KV reaches it at ``kv_heads``."""

    def __init__(self, dim: int, heads: int, kv_heads: int, *,
                 device) -> None:
        super().__init__()
        self.heads, self.kv_heads = heads, kv_heads
        head_dim = dim // heads
        dense = functools.partial(Dense, dim, device=device, use_bias=False)
        self.q = dense(heads * head_dim)
        self.k = dense(kv_heads * head_dim)
        self.v = dense(kv_heads * head_dim)
        self.out = Dense(dim, dim, device=device, use_bias=False)

    def forward(self, hidden, dtype, attention, positions,
                rope_theta: float):
        batch, length, dim = hidden.shape
        head_dim = dim // self.heads
        query = self.q(hidden, dtype).reshape(batch, length, self.heads,
                                              head_dim)
        key = self.k(hidden, dtype).reshape(batch, length, self.kv_heads,
                                            head_dim)
        value = self.v(hidden, dtype).reshape(batch, length, self.kv_heads,
                                              head_dim)
        cos, sin = rotary_embedding(positions, head_dim, rope_theta)
        context = attention(apply_rotary(query, cos, sin),
                            apply_rotary(key, cos, sin), value)
        return self.out(context.reshape(batch, length, dim), dtype)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm transformer block with a SwiGLU FFN."""

    def __init__(self, dim: int, heads: int, kv_heads: int, ffn_dim: int, *,
                 device, schedule=None) -> None:
        super().__init__()
        if schedule is not None:
            # the reference's scheduled SwiGLU (llama.py:188-211) composes
            # tensor-parallel rings with FSDP prefetch over a device mesh
            raise _not_ported('the scheduled SwiGLU (schedule=)',
                              '9. Multi-GPU parallelism')
        self.attn_norm = RMSNorm(dim, device=device)
        self.attn = LlamaAttention(dim, heads, kv_heads, device=device)
        self.ffn_norm = RMSNorm(dim, device=device)
        dense = functools.partial(Dense, device=device, use_bias=False)
        self.gate = dense(dim, ffn_dim)
        self.up = dense(dim, ffn_dim)
        self.down = dense(ffn_dim, dim)

    def forward(self, hidden, dtype, attention, positions,
                rope_theta: float):
        normed = self.attn_norm(hidden)
        hidden = hidden + self.attn(normed, dtype, attention, positions,
                                    rope_theta)
        normed = self.ffn_norm(hidden)
        gated = F.silu(self.gate(normed, dtype)) * self.up(normed, dtype)
        return hidden + self.down(gated, dtype)


class Llama(nn.Module):
    """Llama-3-style decoder-only transformer.

    Defaults are the 8B shape (vocab 128256, 32 x 4096, 32 heads / 8 KV
    heads, SwiGLU 14336, RoPE theta 5e5); :func:`llama3_8b` and
    :func:`llama_tiny` are the presets. ``device`` defaults to the card
    (``'cpu'`` must be asked for); weights are drawn from a generator
    seeded 0 — :meth:`init_weights` redraws them, ``load_state_dict``
    replaces them."""

    FIELDS = ('vocab_size', 'layers', 'dim', 'heads', 'kv_heads', 'ffn_dim',
              'max_seq', 'rope_theta', 'dtype', 'attention', 'remat',
              'return_features', 'decode', 'per_row_decode', 'decode_pages')

    def __init__(self, vocab_size: int = 128_256, layers: int = 32,
                 dim: int = 4096, heads: int = 32, kv_heads: int = 8,
                 ffn_dim: int = 14_336, max_seq: int = 8192,
                 rope_theta: float = 500_000.0, dtype: str = 'bfloat16',
                 attention: str = 'xla', mesh=None, remat: bool = False,
                 scan_layers: bool = False, scan_unit: int = 1,
                 return_features: bool = False, decode: bool = False,
                 per_row_decode: bool = False,
                 decode_pages: tuple | None = None, schedule=None,
                 device=None) -> None:
        super().__init__()
        if scan_layers or scan_unit != 1:
            raise _not_ported('scan_layers / scan_unit', 'scan_layers')
        if mesh is not None:
            raise _not_ported('a device mesh (mesh=)',
                              '9. Multi-GPU parallelism')
        if attention not in ('xla', 'flash'):          # ring / ulysses
            raise _not_ported(f'{attention!r} attention',
                              '9. Multi-GPU parallelism')
        if dim % heads or heads % kv_heads:
            raise ValueError(f'dim ({dim}) must split over heads ({heads}), '
                             f'and heads over kv_heads ({kv_heads})')
        device = resolve_device(device)
        self.vocab_size, self.layers, self.dim = vocab_size, layers, dim
        self.heads, self.kv_heads, self.ffn_dim = heads, kv_heads, ffn_dim
        self.max_seq, self.rope_theta = max_seq, rope_theta
        self.dtype, self.attention, self.remat = dtype, attention, remat
        self.return_features, self.decode = return_features, decode
        self.per_row_decode, self.decode_pages = per_row_decode, decode_pages
        compute_dtype(dtype)                               # validates
        self.embed = Embed(vocab_size, dim, device=device)
        for index in range(layers):
            self.add_module(f'layer_{index}', LlamaBlock(
                dim, heads, kv_heads, ffn_dim, device=device,
                schedule=schedule))
        self.final_norm = RMSNorm(dim, device=device)
        self.lm_head = _HeadKernel(dim, vocab_size, device=device)
        self.init_weights(torch.Generator(device).manual_seed(0))

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def blocks(self):
        return [getattr(self, f'layer_{index}')
                for index in range(self.layers)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (on the weights' device) as
        the flax initialisers draw them: kernels ``lecun_normal`` (a normal
        truncated at +-2, variance ``1 / fan_in``), the embedding
        ``nn.Embed``'s normal with std ``dim ** -0.5``, RMSNorm scales 1."""
        for name, param in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if leaf == 'scale':
                param.fill_(1.0)
            elif leaf == 'embedding':
                param.copy_(torch.randn(param.shape, generator=generator,
                                        device=generator.device)
                            * param.shape[1] ** -0.5)
            else:
                values = torch.empty(param.shape, device=generator.device)
                nn.init.trunc_normal_(values, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                param.copy_(values * (param.shape[0] ** -0.5
                                      / TRUNCATED_STD))
                del values

    def replace(self, **updates) -> 'Llama':
        """A clone with other mode fields (``dataclasses.replace`` on the
        flax module), sharing this module's parameters."""
        unknown = set(updates) - set(self.FIELDS)
        if unknown:
            raise TypeError(f'unknown Llama fields {sorted(unknown)}')
        clone = copy.copy(self)
        for name, value in updates.items():
            setattr(clone, name, value)
        return clone

    def init_cache(self, batch: int, device=None) -> dict:
        """Zeroed decode cache for ``batch`` rows at ``kv_heads``: the serving
        engine's paged pool when ``decode_pages`` is set, else contiguous
        strips. Each layer keeps its own cursor; there is no model-level
        ``position`` leaf."""
        device = self.device if device is None else torch.device(device)
        dtype = self.compute_dtype
        index = torch.zeros(batch, dtype=torch.int32, device=device)
        cache = {}
        for layer in range(self.layers):
            prefix = f'layer_{layer}/attn'
            if self.decode_pages:
                blocks, block = self.decode_pages
                shape = (blocks * block, self.kv_heads, self.head_dim)
                cache[prefix + '/table'] = torch.zeros(
                    (batch, self.max_seq // block), dtype=torch.int32,
                    device=device)
            else:
                shape = (batch, self.max_seq, self.kv_heads, self.head_dim)
            cache[prefix + '/key'] = torch.zeros(shape, dtype=dtype,
                                                 device=device)
            cache[prefix + '/value'] = torch.zeros(shape, dtype=dtype,
                                                   device=device)
            cache[prefix + '/index'] = index
        return cache

    def forward(self, tokens, cache: dict | None = None, *,
                depth: int | None = None):
        """Logits ``[batch, length, vocab]`` (float32) for ``tokens``, or
        ``(features, head table)`` with ``return_features``.

        In decode mode returns ``(logits, cache)``: ``cache=None`` is the
        prefill, which creates the contiguous cache; later calls pass the
        returned cache back (its tensors are updated in place). ``depth`` is
        the deepest row's cursor before the call, the host's choice of read
        window; when omitted it is read from the cache."""
        dtype = self.compute_dtype
        batch, length = tokens.shape
        if length > self.max_seq:
            raise ValueError(f'sequence length {length} exceeds '
                             f'max_seq={self.max_seq}')
        tokens = tokens.long()
        steps = torch.arange(length, device=tokens.device)
        if self.decode:
            cache = {} if cache is None else cache
            if depth is None:
                cursor = cache.get('layer_0/attn/index')
                depth = 0 if cursor is None else int(cursor.max())
        hidden = self.embed(tokens).to(dtype)
        remat = self.remat and not self.decode and torch.is_grad_enabled()
        for index, block in enumerate(self.blocks()):
            if self.decode:
                prefix = f'layer_{index}/attn'
                # rotary at absolute positions: this layer's cursor before
                # cached_attention advances it (zeros on the prefill call)
                cursor = cache.get(prefix + '/index')
                if cursor is None:
                    cursor = torch.zeros(batch, dtype=torch.int32,
                                         device=tokens.device)
                positions = cursor[:, None].long() + steps[None, :]
                attention = functools.partial(
                    cached_attention, cache=cache, prefix=prefix,
                    max_seq=self.max_seq, per_row=self.per_row_decode,
                    pages=self.decode_pages, depth=depth)
            else:
                positions = steps
                attention = functools.partial(attend, kernel=self.attention)
            run = (functools.partial(checkpoint, block, use_reentrant=False)
                   if remat else block)
            hidden = run(hidden, dtype, attention, positions,
                         self.rope_theta)
        features = self.final_norm(hidden)
        table = self.lm_head.kernel.to(dtype)
        if self.return_features:
            outputs = (features, table)
        else:
            outputs = head_logits(features, table, tied=False)
        return (outputs, cache) if self.decode else outputs


register(Llama, excluded_kwargs={'mesh', 'device'})


def llama3_8b(**overrides) -> Llama:
    """The 8B preset (== class defaults), gradient checkpointing on."""
    config = dict(remat=True)
    config.update(overrides)
    return Llama(**config)


def llama_tiny(**overrides) -> Llama:
    """Test scale: runs in seconds on the CPU."""
    config = dict(vocab_size=256, layers=2, dim=64, heads=4, kv_heads=2,
                  ffn_dim=128, max_seq=128)
    config.update(overrides)
    return Llama(**config)
