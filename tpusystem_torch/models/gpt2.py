"""GPT-2 language model: the port of :mod:`tpusystem.models.gpt2`.

Decoder-only transformer with learned positions and a tied LM head.
Parameters keep the flax layout and names of the reference
(``h_0.attn.qkv.kernel`` is a ``[in, out]`` kernel, biases are separate
vectors), so :func:`tpusystem_torch.convert.params_from_jax` carries a JAX
param tree over name for name and the module path and the fused decode
step read the same tensors. Parameters are float32 masters; activations run
in ``dtype`` (bfloat16 by default) with float32 layernorms, softmax and
logits, rounding where the reference rounds:

* token and position embeddings are summed in float32, then cast;
* a dense layer multiplies in the compute dtype and adds its bias there
  (``nn.Dense(dtype=bf16)``);
* layernorm is flax's: float32, epsilon 1e-6, ``E[x^2] - E[x]^2`` clipped
  at 0;
* GELU is the tanh approximation (``jax.nn.gelu``'s default).

``decode=True`` is the KV-cache mode: ``forward(tokens, cache)`` returns
``(logits, cache)``, the cache a dict of tensors keyed by the reference's
cache paths (see :mod:`tpusystem_torch.ops.attention`). ``decode_pages``
switches it to the serving engine's paged pool. Not ported yet, each
raising ``NotImplementedError``: ``scan_layers``, MoE blocks, ``remat``,
ring/ulysses attention and training-time dropout; ``return_features`` (the
chunked loss's input) is not a field yet.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.ops.attention import attend, cached_attention
from tpusystem_torch.ops.precision import head_logits
from tpusystem_torch.registry import register

EMBED_STD = 0.02    # GPT-2's initializer range for the embedding tables


class Dense(nn.Module):
    """``flax.linen.Dense``: a ``[in, out]`` kernel and a bias."""

    def __init__(self, features_in: int, features: int, *, device) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x, dtype):
        return (torch.matmul(x.to(dtype), self.kernel.to(dtype))
                + self.bias.to(dtype))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: float32 statistics with the
    fast variance ``E[x^2] - E[x]^2`` clipped at 0, epsilon 1e-6."""

    def __init__(self, features: int, *, device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


class Embed(nn.Module):
    """``flax.linen.Embed(dtype=float32)``: a float32 lookup table."""

    def __init__(self, count: int, features: int, *, device) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(count, features,
                                                  device=device))

    def forward(self, ids):
        return self.embedding[ids]


class SelfAttention(nn.Module):
    """Causal multi-head self-attention; ``attention(q, k, v)`` is the
    kernel (forward attention or a decode cache) chosen by the model."""

    def __init__(self, dim: int, heads: int, *, device) -> None:
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.out = Dense(dim, dim, device=device)

    def forward(self, hidden, dtype, attention):
        batch, length, dim = hidden.shape
        qkv = self.qkv(hidden, dtype)
        shape = (batch, length, self.heads, dim // self.heads)
        query, key, value = (t.reshape(shape) for t in qkv.split(dim, -1))
        context = attention(query, key, value)
        return self.out(context.reshape(batch, length, dim), dtype)


class Block(nn.Module):
    """Pre-norm transformer block: attention, then the GELU MLP."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, *,
                 device) -> None:
        super().__init__()
        self.ln_1 = LayerNorm(dim, device=device)
        self.attn = SelfAttention(dim, heads, device=device)
        self.ln_2 = LayerNorm(dim, device=device)
        self.fc = Dense(dim, mlp_ratio * dim, device=device)
        self.proj = Dense(mlp_ratio * dim, dim, device=device)

    def forward(self, hidden, dtype, attention):
        normed = self.ln_1(hidden).to(dtype)
        hidden = hidden + self.attn(normed, dtype, attention)
        normed = self.ln_2(hidden).to(dtype)
        grown = F.gelu(self.fc(normed, dtype), approximate='tanh')
        return hidden + self.proj(grown, dtype)


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               f'(ROADMAP queue 1: {item})')


class GPT2(nn.Module):
    """Decoder-only transformer with learned positions and tied LM head.

    125M preset == defaults (vocab 50257, 12 x 768, 12 heads, seq 1024).
    ``device`` defaults to the card (``'cpu'`` must be asked for); weights
    are drawn from a generator seeded 0 — :meth:`init_weights` redraws
    them, ``load_state_dict`` replaces them."""

    FIELDS = ('vocab_size', 'layers', 'dim', 'heads', 'max_seq', 'mlp_ratio',
              'dropout', 'dtype', 'attention', 'remat', 'scan_layers',
              'decode', 'per_row_decode', 'decode_pages', 'moe_experts')

    def __init__(self, vocab_size: int = 50257, layers: int = 12,
                 dim: int = 768, heads: int = 12, max_seq: int = 1024,
                 mlp_ratio: int = 4, dropout: float = 0.1,
                 dtype: str = 'bfloat16', attention: str = 'xla',
                 remat: bool = False, scan_layers: bool = False,
                 decode: bool = False,
                 per_row_decode: bool = False,
                 decode_pages: tuple | None = None, moe_experts: int = 0,
                 device=None) -> None:
        super().__init__()
        if scan_layers:
            raise _not_ported('scan_layers', 'the GPT-2 train step')
        if moe_experts:
            raise _not_ported('MoE blocks', 'MoE')
        if remat:
            raise _not_ported('remat', 'the GPT-2 train step')
        if attention not in ('xla', 'flash'):  # ring / ulysses
            raise _not_ported(f'{attention!r} attention',
                              'multi-GPU parallelism')
        device = resolve_device(device)
        self.vocab_size, self.layers, self.dim = vocab_size, layers, dim
        self.heads, self.max_seq, self.mlp_ratio = heads, max_seq, mlp_ratio
        self.dropout, self.dtype, self.attention = dropout, dtype, attention
        self.remat, self.scan_layers, self.decode = remat, scan_layers, decode
        self.per_row_decode, self.decode_pages = per_row_decode, decode_pages
        self.moe_experts = moe_experts
        compute_dtype(dtype)                               # validates
        self.wte = Embed(vocab_size, dim, device=device)
        self.wpe = Embed(max_seq, dim, device=device)
        for index in range(layers):
            self.add_module(f'h_{index}',
                            Block(dim, heads, mlp_ratio, device=device))
        self.ln_f = LayerNorm(dim, device=device)
        self.init_weights(torch.Generator(device).manual_seed(0))

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    @property
    def device(self) -> torch.device:
        return self.wte.embedding.device

    def blocks(self):
        return [getattr(self, f'h_{index}') for index in range(self.layers)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (on the weights' device):
        lecun-normal kernels (std ``fan_in ** -0.5``), embeddings with std
        0.02; biases 0, layernorm scales 1."""
        for name, param in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if leaf == 'kernel':
                std = param.shape[0] ** -0.5
            elif leaf == 'embedding':
                std = EMBED_STD
            else:
                param.fill_(1.0 if leaf == 'scale' else 0.0)
                continue
            param.copy_(torch.randn(param.shape, generator=generator,
                                    device=generator.device) * std)

    def replace(self, **updates) -> 'GPT2':
        """A clone with other mode fields (``dataclasses.replace`` on the
        flax module). The clone shares this module's parameters."""
        unknown = set(updates) - set(self.FIELDS)
        if unknown:
            raise TypeError(f'unknown GPT2 fields {sorted(unknown)}')
        clone = copy.copy(self)
        for name, value in updates.items():
            setattr(clone, name, value)
        return clone

    def init_cache(self, batch: int, device=None) -> dict:
        """Zeroed decode cache for ``batch`` rows: the serving engine's paged
        pool when ``decode_pages`` is set, else contiguous strips."""
        device = self.device if device is None else torch.device(device)
        head_dim = self.dim // self.heads
        dtype = self.compute_dtype
        index = torch.zeros(batch, dtype=torch.int32, device=device)
        cache = {'position': index}
        for layer in range(self.layers):
            prefix = f'h_{layer}/attn'
            if self.decode_pages:
                blocks, block = self.decode_pages
                shape = (blocks * block, self.heads, head_dim)
                cache[prefix + '/table'] = torch.zeros(
                    (batch, self.max_seq // block), dtype=torch.int32,
                    device=device)
            else:
                shape = (batch, self.max_seq, self.heads, head_dim)
            cache[prefix + '/key'] = torch.zeros(shape, dtype=dtype,
                                                 device=device)
            cache[prefix + '/value'] = torch.zeros(shape, dtype=dtype,
                                                   device=device)
            cache[prefix + '/index'] = index
        return cache

    def forward(self, tokens, cache: dict | None = None, *,
                train: bool = False, depth: int | None = None):
        """Logits ``[batch, length, vocab]`` (float32) for ``tokens``.

        In decode mode returns ``(logits, cache)``: ``cache=None`` is the
        prefill, which creates the contiguous cache; later calls pass the
        returned cache back (its tensors are updated in place). ``depth`` is
        the deepest row's cursor before the call, the host's choice of read
        window; when omitted it is read from the cache."""
        if train and self.dropout:
            raise _not_ported('training-time dropout', 'the GPT-2 train step')
        dtype = self.compute_dtype
        batch, length = tokens.shape
        if length > self.max_seq:
            raise ValueError(f'sequence length {length} exceeds '
                             f'max_seq={self.max_seq}')
        tokens = tokens.long()
        steps = torch.arange(length, device=tokens.device)
        if self.decode:
            cache = {} if cache is None else cache
            offset = cache.get('position')
            if offset is None:
                offset = torch.zeros(batch, dtype=torch.int32,
                                     device=tokens.device)
                depth = 0
            elif depth is None:
                depth = int(offset.max())
            positions = offset[:, None].long() + steps[None, :]
            cache['position'] = offset + length
        else:
            positions = steps
        hidden = (self.wte(tokens) + self.wpe(positions)).to(dtype)
        for index, block in enumerate(self.blocks()):
            if self.decode:
                attention = functools.partial(
                    cached_attention, cache=cache, prefix=f'h_{index}/attn',
                    max_seq=self.max_seq,
                    per_row=self.per_row_decode, pages=self.decode_pages,
                    depth=depth)
            else:
                attention = functools.partial(attend, kernel=self.attention)
            hidden = block(hidden, dtype, attention)
        logits = head_logits(self.ln_f(hidden).to(dtype),
                             self.wte.embedding.to(dtype), tied=True)
        return (logits, cache) if self.decode else logits


register(GPT2, excluded_kwargs={'device'})


def gpt2_small(**overrides) -> GPT2:
    return GPT2(**overrides)


def gpt2_tiny(**overrides) -> GPT2:
    """Test scale: runs in seconds on the CPU."""
    config = dict(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                  dropout=0.0)
    config.update(overrides)
    return GPT2(**config)
