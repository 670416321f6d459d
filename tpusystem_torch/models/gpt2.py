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
switches it to the serving engine's paged pool. ``return_features=True``
returns ``(features, table)`` instead of logits: the input of
:class:`tpusystem_torch.train.ChunkedNextTokenLoss`, which owns the head.
``forward(train=True)`` trains through autograd (the flash kernels carry
their own backward). With ``moe_experts > 0`` block ``i`` is an MoE block
iff ``i % moe_every == moe_every - 1``: its FFN is a
:class:`~tpusystem_torch.ops.moe.MoEMLP` named ``moe``, and the model
returns ``(outputs, aux)``, ``aux`` the mean of the MoE layers' router
losses (for :class:`tpusystem_torch.train.WithAuxLoss`).

``remat=True`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``, non-reentrant): the reference's
``nn.remat(Block)``, which saves nothing inside a block. Training-time
dropout (``forward(train=True, rng=key)``, ``key`` the threefry key the
reference passes as ``rngs={'dropout': key}``) drops at the reference's
sites with the reference's masks: each site's key is the one flax's
``make_rng('dropout')`` returns there (:func:`dropout_keys`), the
embeddings' ``Dropout_0``, each block's ``Dropout_0`` (attention output) and
``Dropout_1`` (MLP or expert output) and, at ``attn_dropout`` (``None``
follows ``dropout``), the attention probabilities from ``attn``'s key,
inside the flash kernels on ``'flash'``. The keys are derived on the host
before any block runs, so a recomputed block draws the masks it drew the
first time. Not ported yet, each raising ``NotImplementedError`` that names
its ROADMAP item: ``scan_layers``, ring/ulysses attention, and decoding an
MoE model.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.ops.attention import (apply_dropout, attend,
                                          cached_attention)
from tpusystem_torch.ops.moe import MoEMLP, init_parameter
from tpusystem_torch.ops.precision import head_logits
from tpusystem_torch.ops.threefry import as_key, make_rng
from tpusystem_torch.registry import register

EMBED_STD = 0.02    # GPT-2's initializer range for the embedding tables


class Dense(nn.Module):
    """``flax.linen.Dense``: a ``[in, out]`` kernel and, unless
    ``use_bias=False``, a bias; the product and the bias add run in the
    compute dtype."""

    def __init__(self, features_in: int, features: int, *, device,
                 use_bias: bool = True) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, dtype):
        out = torch.matmul(x.to(dtype), self.kernel.to(dtype))
        return out if self.bias is None else out + self.bias.to(dtype)


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
    """Pre-norm transformer block: attention, then the GELU MLP, or with
    ``moe`` (the :class:`MoEMLP` arguments) the expert FFN; an MoE block
    returns ``(hidden, aux)``. ``rate`` drops the attention and FFN
    outputs, with masks from ``keys`` (two threefry keys)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, *,
                 device, moe: dict | None = None) -> None:
        super().__init__()
        self.ln_1 = LayerNorm(dim, device=device)
        self.attn = SelfAttention(dim, heads, device=device)
        self.ln_2 = LayerNorm(dim, device=device)
        if moe:
            self.moe = MoEMLP(dim, mlp_ratio=mlp_ratio, device=device, **moe)
        else:
            self.moe = None
            self.fc = Dense(dim, mlp_ratio * dim, device=device)
            self.proj = Dense(mlp_ratio * dim, dim, device=device)

    def forward(self, hidden, dtype, attention, rate: float = 0.0,
                keys: tuple = (None, None)):
        normed = self.ln_1(hidden).to(dtype)
        attended = self.attn(normed, dtype, attention)
        hidden = hidden + apply_dropout(attended, rate, keys[0])
        normed = self.ln_2(hidden).to(dtype)
        if self.moe is not None:
            shrunk, aux = self.moe(normed)
            return hidden + apply_dropout(shrunk, rate, keys[1]), aux
        grown = F.gelu(self.fc(normed, dtype), approximate='tanh')
        return hidden + apply_dropout(self.proj(grown, dtype), rate, keys[1])


MOE_SERVING = 'MoE serving through the module paged step'
# GPT2 field -> the MoEMLP setting it governs
MOE_LAYER_FIELDS = {'moe_k': 'k', 'moe_capacity_factor': 'capacity_factor',
                    'moe_sparse_impl': 'sparse_impl', 'dtype': 'dtype',
                    'decode': 'full_capacity'}


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               f'(ROADMAP queue 1: {item})')


def dropout_keys(rng, layers: int) -> tuple:
    """The dropout keys of one training forward from the step's key ``rng``:
    ``(embeddings, [(attention, attention output, FFN output)] * layers)``,
    each the key flax's ``make_rng('dropout')`` returns at the reference
    module's path (``Dropout_0``; ``h_i/attn``, ``h_i/Dropout_0``,
    ``h_i/Dropout_1``), the first call of each scope."""
    rng = as_key(rng)
    blocks = [tuple(make_rng(rng, (f'h_{index}', site))
                    for site in ('attn', 'Dropout_0', 'Dropout_1'))
              for index in range(layers)]
    return make_rng(rng, ('Dropout_0',)), blocks


class GPT2(nn.Module):
    """Decoder-only transformer with learned positions and tied LM head.

    125M preset == defaults (vocab 50257, 12 x 768, 12 heads, seq 1024).
    ``device`` defaults to the card (``'cpu'`` must be asked for); weights
    are drawn from a generator seeded 0 — :meth:`init_weights` redraws
    them, ``load_state_dict`` replaces them."""

    FIELDS = ('vocab_size', 'layers', 'dim', 'heads', 'max_seq', 'mlp_ratio',
              'dropout', 'dtype', 'attention', 'attn_dropout', 'remat',
              'scan_layers',
              'return_features', 'decode', 'per_row_decode', 'decode_pages',
              'moe_experts', 'moe_every', 'moe_k', 'moe_capacity_factor',
              'moe_sparse_impl')

    def __init__(self, vocab_size: int = 50257, layers: int = 12,
                 dim: int = 768, heads: int = 12, max_seq: int = 1024,
                 mlp_ratio: int = 4, dropout: float = 0.1,
                 dtype: str = 'bfloat16', attention: str = 'xla',
                 attn_dropout: float | None = None,
                 remat: bool = False, scan_layers: bool = False,
                 return_features: bool = False, decode: bool = False,
                 per_row_decode: bool = False,
                 decode_pages: tuple | None = None, moe_experts: int = 0,
                 moe_every: int = 2, moe_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 moe_sparse_impl: str = 'gather', device=None) -> None:
        super().__init__()
        if scan_layers:
            raise _not_ported('scan_layers', 'scan_layers')
        if moe_experts and decode:
            raise _not_ported('decoding an MoE model', MOE_SERVING)
        if attention not in ('xla', 'flash'):  # ring / ulysses
            raise _not_ported(f'{attention!r} attention',
                              'multi-GPU parallelism')
        device = resolve_device(device)
        self.vocab_size, self.layers, self.dim = vocab_size, layers, dim
        self.heads, self.max_seq, self.mlp_ratio = heads, max_seq, mlp_ratio
        self.dropout, self.dtype, self.attention = dropout, dtype, attention
        self.attn_dropout = attn_dropout
        self.remat, self.scan_layers, self.decode = remat, scan_layers, decode
        self.return_features = return_features
        self.per_row_decode, self.decode_pages = per_row_decode, decode_pages
        self.moe_experts, self.moe_every, self.moe_k = (moe_experts,
                                                        moe_every, moe_k)
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_sparse_impl = moe_sparse_impl
        compute_dtype(dtype)                               # validates
        self.wte = Embed(vocab_size, dim, device=device)
        self.wpe = Embed(max_seq, dim, device=device)
        moe = dict(experts=moe_experts, **{
            layer_field: getattr(self, field)
            for field, layer_field in MOE_LAYER_FIELDS.items()})
        for index in range(layers):
            self.add_module(f'h_{index}', Block(
                dim, heads, mlp_ratio, device=device,
                moe=moe if self.is_moe(index) else None))
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

    def is_moe(self, index: int) -> bool:
        """Whether block ``index`` carries the expert FFN."""
        return (self.moe_experts > 0
                and index % self.moe_every == self.moe_every - 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (on the weights' device):
        lecun-normal kernels (std ``fan_in ** -0.5``), embeddings with std
        0.02; biases 0, layernorm scales 1; MoE weights as
        :func:`~tpusystem_torch.ops.moe.init_parameter` draws them."""
        for name, param in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if '.moe.' in name:
                init_parameter(leaf, param, generator)
                continue
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
        flax module). The clone shares this module's parameters; its MoE
        layers are clones too when a field they read changes. Fields that
        shape the parameters of the experts cannot change."""
        unknown = set(updates) - set(self.FIELDS)
        if unknown:
            raise TypeError(f'unknown GPT2 fields {sorted(unknown)}')
        for name in ('moe_experts', 'moe_every'):
            if name in updates and updates[name] != getattr(self, name):
                raise ValueError(f'replace cannot change {name}: it shapes '
                                 'the parameters')
        clone = copy.copy(self)
        for name, value in updates.items():
            setattr(clone, name, value)
        layer_updates = {MOE_LAYER_FIELDS[name]: value
                         for name, value in updates.items()
                         if name in MOE_LAYER_FIELDS}
        if self.moe_experts and layer_updates:
            clone._modules = dict(self._modules)
            for index in range(self.layers):
                if self.is_moe(index):
                    name = f'h_{index}'
                    block = copy.copy(self._modules[name])
                    layer = copy.copy(block.moe)
                    layer._parameters = dict(layer._parameters)
                    for field, value in layer_updates.items():
                        setattr(layer, field, value)
                    block._modules = dict(block._modules, moe=layer)
                    clone._modules[name] = block
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

    def dropout_rates(self, train: bool) -> tuple[float, float]:
        """``(rate, attention rate)`` of a forward: 0 outside training;
        ``attn_dropout=None`` follows ``dropout``."""
        if not train:
            return 0.0, 0.0
        attn = self.dropout if self.attn_dropout is None else self.attn_dropout
        return self.dropout, attn

    def forward(self, tokens, cache: dict | None = None, *,
                train: bool = False, depth: int | None = None,
                rng=None):
        """Logits ``[batch, length, vocab]`` (float32) for ``tokens``.

        In decode mode returns ``(logits, cache)``: ``cache=None`` is the
        prefill, which creates the contiguous cache; later calls pass the
        returned cache back (its tensors are updated in place). ``depth`` is
        the deepest row's cursor before the call, the host's choice of read
        window; when omitted it is read from the cache. A training forward
        with dropout derives its masks' keys from ``rng``, the step's
        threefry key (the reference's ``'dropout'`` rng)."""
        rate, attn_rate = self.dropout_rates(train)
        if (rate or attn_rate) and rng is None:
            raise ValueError('a training forward with dropout needs rng=, a '
                             'threefry key')
        if self.decode and self.moe_experts:
            raise _not_ported('decoding an MoE model', MOE_SERVING)
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
        # every mask's key, derived before any block runs (see the docstring)
        embed_key, block_keys = (dropout_keys(rng, self.layers)
                                 if rate or attn_rate
                                 else (None, [(None,) * 3] * self.layers))
        hidden = apply_dropout(self.wte(tokens) + self.wpe(positions), rate,
                               embed_key).to(dtype)
        aux_losses = []
        remat = self.remat and not self.decode and torch.is_grad_enabled()
        for index, block in enumerate(self.blocks()):
            attn_key, *output_keys = block_keys[index]
            if self.decode:
                attention = functools.partial(
                    cached_attention, cache=cache, prefix=f'h_{index}/attn',
                    max_seq=self.max_seq,
                    per_row=self.per_row_decode, pages=self.decode_pages,
                    depth=depth)
            else:
                attention = functools.partial(attend, kernel=self.attention,
                                              dropout=attn_rate, rng=attn_key)
            run = (functools.partial(checkpoint, block, use_reentrant=False)
                   if remat else block)
            hidden = run(hidden, dtype, attention, rate, tuple(output_keys))
            if self.is_moe(index):
                hidden, aux = hidden
                aux_losses.append(aux)
        features = self.ln_f(hidden).to(dtype)
        table = self.wte.embedding.to(dtype)
        if self.return_features:
            # the criterion owns the head: the [batch * seq, vocab] float32
            # logits never form (ChunkedNextTokenLoss)
            outputs = (features, table)
        else:
            outputs = head_logits(features, table, tied=True)
        if self.moe_experts:
            # the arity follows the configuration, not which layers are MoE
            aux = (torch.stack(aux_losses).mean() if aux_losses
                   else features.new_zeros((), dtype=torch.float32))
            return outputs, aux
        return (outputs, cache) if self.decode else outputs


register(GPT2, excluded_kwargs={'device'})


def gpt2_small(**overrides) -> GPT2:
    return GPT2(**overrides)


def gpt2_tiny(**overrides) -> GPT2:
    """Test scale: runs in seconds on the CPU."""
    config = dict(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                  dropout=0.0)
    config.update(overrides)
    return GPT2(**config)
