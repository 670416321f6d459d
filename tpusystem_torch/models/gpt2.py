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
first time.

``scan_layers=True`` holds the blocks as one template whose parameters are
stacked at a leading layer dimension under ``hs`` (``hs.attn.qkv.kernel`` is
``[layers, in, out]``), the reference's ``nn.scan`` layout, applied layer by
layer (:mod:`tpusystem_torch.models.scan`). With ``moe_experts`` (or
``scan_unit > 1``) the template is a :class:`BlockSpan` of ``d_{i}`` and
``moe_{i}`` blocks, stacked per span. Decode mode stacks the caches too
(``hs/attn/key`` is ``[layers, batch, max_seq, heads, head_dim]``). A
scanned training forward drops with ``nn.scan``'s per-unit keys
(``split_rngs={'dropout': True}``, :func:`scanned_dropout_keys`).
``attention='ring'`` or ``'ulysses'`` with a
``mesh`` is sequence parallelism (:mod:`tpusystem_torch.ops.ring`): a rank
holds its chunk of every row's positions over the ``seq`` axis, embedded at
their global positions, and attends over the ring (the step sums over
``seq``: :func:`tpusystem_torch.train.build_train_step`).
:meth:`GPT2.partition_rules` are the reference's, for the sharding
policies of :mod:`tpusystem_torch.parallel.sharding`.

An MoE model decodes too (``decode=True``): its expert layers dispatch at
full capacity, as the reference's do (``gpt2.py:150-153``), and the
training-only router loss is dropped, so decode returns ``(logits,
cache)`` whatever the configuration.
"""

from __future__ import annotations

import copy
import functools
import re

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.models.scan import (apply_unit, as_unit,
                                         init_stacked, layer_slices, lookup,
                                         restack_caches, stack_parameters,
                                         unit_cache)
from tpusystem_torch.ops.attention import (apply_dropout, attend,
                                          cached_attention)
from tpusystem_torch.ops.moe import MoEMLP, init_parameter
from tpusystem_torch.ops.precision import head_logits
from tpusystem_torch.ops.threefry import as_key, make_rng, split
from tpusystem_torch.parallel.collectives import (copy_to, gather_from,
                                                  reduce_from, scatter_to)
from tpusystem_torch.parallel.mesh import (DATA, EXPERT, FSDP, MODEL, SEQ,
                                           STAGE)
from tpusystem_torch.parallel.overlap import DenseParams
from tpusystem_torch.parallel.schedule import (over_fsdp_whole,
                                               resolve_schedule,
                                               schedule_applicable,
                                               scheduled_ffn)
from tpusystem_torch.parallel.sharding import gathered, held_axes, with_held
from tpusystem_torch.registry import register

EMBED_STD = 0.02    # GPT-2's initializer range for the embedding tables


def _dense(x, kernel, bias, dtype):
    out = torch.matmul(x.to(dtype), kernel.to(dtype))
    return out if bias is None else out + bias.to(dtype)


class Dense(DenseParams):
    """``flax.linen.Dense``: a ``[in, out]`` kernel and, unless
    ``use_bias=False``, a bias; the product and the bias add run in the
    compute dtype."""

    def forward(self, x, dtype):
        return _dense(x, self.kernel, self.bias, dtype)


# Megatron tensor parallelism over the mesh's ``model`` axis. Activations
# outside a tensor-parallel product are whole on every ``model`` rank; a
# kernel reaches the forward whole, or as this rank's block over ``model``
# (held_axes names it), and each product takes it as it comes.


def split_over_model(tensor, dim: int, mesh) -> bool:
    """Whether ``tensor`` is this rank's block of ``dim`` over a ``model``
    axis of more than one rank (a block over one rank is the whole)."""
    return (mesh is not None and mesh.shape[MODEL] > 1
            and MODEL in held_axes(tensor).get(dim, ()))


def column(dense: DenseParams, x, dtype, mesh):
    """``dense(x)``, column-parallel where the kernel is this rank's block
    of columns: ``(out, split)``, ``out`` this rank's columns when
    ``split``. The input's gradient is summed over ``model``; the bias
    rides its block."""
    kernel = dense.kernel if mesh is None else over_fsdp_whole(dense.kernel,
                                                               mesh)
    if not split_over_model(kernel, 1, mesh):
        return _dense(x, kernel, dense.bias, dtype), False
    bias = (None if dense.bias is None
            else scatter_to(dense.bias, mesh, MODEL, dimension=0))
    return _dense(copy_to(x, mesh, MODEL), kernel, bias, dtype), True


def row(dense: DenseParams, x, split: bool, dtype, mesh):
    """``dense(x)``, row-parallel where the kernel is this rank's block of
    rows: the float32 partial products summed over ``model``, cast once,
    then the bias. ``split`` says ``x`` is this rank's block of features
    already (a column-parallel product's output)."""
    kernel = dense.kernel if mesh is None else over_fsdp_whole(dense.kernel,
                                                               mesh)
    if not split_over_model(kernel, 0, mesh):
        if split:
            x = gather_from(x, mesh, MODEL, dimension=-1)
        return _dense(x, kernel, dense.bias, dtype)
    if not split:
        x = scatter_to(x, mesh, MODEL, dimension=-1)
    partial = torch.matmul(x.to(dtype).float(), kernel.to(dtype).float())
    out = reduce_from(partial, mesh, MODEL).to(dtype)
    return out if dense.bias is None else out + dense.bias.to(dtype)


def vocab_lookup(table, ids, mesh):
    """``table[ids]`` where ``table`` may be this rank's block of rows over
    ``model``: ids outside the block look up zero, and the sum over
    ``model`` completes every row."""
    if not split_over_model(table, 0, mesh):
        return table[ids]
    rows = table.shape[0]
    local = ids - mesh.axis_index(MODEL) * rows
    inside = (local >= 0) & (local < rows)
    found = table[local.clamp(0, rows - 1)]
    return reduce_from(torch.where(inside[..., None], found,
                                   torch.zeros_like(found)), mesh, MODEL)


def feature_lookup(table, ids, mesh):
    """``table[ids]`` where ``table`` may be this rank's block of features
    over ``model``: each rank looks up its features, gathered whole."""
    if not split_over_model(table, 1, mesh):
        return table[ids]
    return gather_from(table[ids], mesh, MODEL, dimension=-1)


def whole_rows(table, mesh, dimension: int = 0):
    """``table`` whole, gathered over ``model`` where this rank holds a
    block of its ``dimension`` (a head's vocabulary)."""
    if not split_over_model(table, dimension, mesh):
        return table
    return gather_from(table, mesh, MODEL, dimension=dimension)


def local_heads(attention, mesh):
    """``attention(q, k, v)`` over a head-split decode cache: this rank's
    block of the heads in, the context's heads gathered whole out."""
    def run(query, key, value):
        pick = functools.partial(scatter_to, mesh=mesh, axis=MODEL,
                                 dimension=2)
        context = attention(pick(query), pick(key), pick(value))
        return gather_from(context, mesh, MODEL, dimension=2)
    return run


def heads_split(mesh, kv_heads: int) -> bool:
    """Whether a decode cache holds this rank's block of the KV heads: a
    ``model`` axis of more than one rank that divides them."""
    model = 1 if mesh is None else mesh.shape[MODEL]
    return model > 1 and kv_heads % model == 0


def global_shape(hidden, mesh) -> tuple:
    """The ``[batch, seq, dim]`` of the whole batch a rank's rows are part
    of (its rows times the ``(data, fsdp)`` ranks)."""
    batch, seq, dim = hidden.shape
    return (batch * mesh.axis_size((DATA, FSDP)), seq, dim)


def _cast(tensor, dtype):
    return with_held(tensor.to(dtype), tensor)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: float32 statistics with the
    fast variance ``E[x^2] - E[x]^2`` clipped at 0, epsilon 1e-6."""

    def __init__(self, features: int, *, device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias)


def layer_norm(x, scale, bias):
    """:class:`LayerNorm`'s arithmetic on the given ``scale`` and ``bias``."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + 1e-6) * scale) + bias


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

    def forward(self, hidden, dtype, attention, mesh=None):
        batch, length, dim = hidden.shape
        qkv, split = column(self.qkv, hidden, dtype, mesh)
        if split:
            qkv = gather_from(qkv, mesh, MODEL, dimension=-1)
        shape = (batch, length, self.heads, dim // self.heads)
        query, key, value = (t.reshape(shape) for t in qkv.split(dim, -1))
        context = attention(query, key, value)
        return row(self.out, context.reshape(batch, length, dim), False,
                   dtype, mesh)


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
            self.grown = mlp_ratio * dim
            self.fc = Dense(dim, mlp_ratio * dim, device=device)
            self.proj = Dense(mlp_ratio * dim, dim, device=device)

    def forward(self, hidden, dtype, attention, rate: float = 0.0,
                keys: tuple = (None, None), tp: tuple | None = None):
        """``tp`` is ``(mesh, schedule)`` over a mesh (the model's), else
        ``None``."""
        mesh, schedule = tp or (None, None)
        normed = self.ln_1(hidden).to(dtype)
        attended = self.attn(normed, dtype, attention, mesh)
        hidden = hidden + apply_dropout(attended, rate, keys[0])
        normed = self.ln_2(hidden).to(dtype)
        if self.moe is not None:
            shrunk, aux = self.moe(normed)
            return hidden + apply_dropout(shrunk, rate, keys[1]), aux
        if mesh is not None and schedule_applicable(
                schedule, mesh, global_shape(normed, mesh), self.grown):
            # the scheduled FFN (parallel/schedule.py): the sequence rows
            # all-gather into the fc matmul and the proj matmul
            # reduce-scatters them back (decomposed rings when
            # schedule.tp='overlap'); with schedule.fsdp='prefetch' the
            # kernels arrive still FSDP-split and are gathered here
            shrunk = scheduled_ffn(
                normed, _cast(self.fc.kernel, dtype),
                self.fc.bias.to(dtype), _cast(self.proj.kernel, dtype),
                self.proj.bias.to(dtype), mesh, schedule=schedule,
                activation=functools.partial(F.gelu, approximate='tanh'))
        else:
            grown, split = column(self.fc, normed, dtype, mesh)
            shrunk = row(self.proj, F.gelu(grown, approximate='tanh'),
                         split, dtype, mesh)
        return hidden + apply_dropout(shrunk, rate, keys[1])


class BlockSpan(nn.Module):
    """``span`` consecutive blocks (``tpusystem/models/gpt2.py:207``), the
    unit a scanned MoE or ``scan_unit`` stack repeats: with ``moe`` block
    ``i`` is MoE iff ``i % moe_every == moe_every - 1`` (named ``moe_{i}``,
    dense ones ``d_{i}``). ``attentions`` maps each block's name to its
    attention function. Returns ``hidden``, or ``(hidden, aux)`` with the
    mean router loss of the span's MoE blocks. ``keys`` maps each block's
    name to its two output-dropout keys."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, span: int, *,
                 device, moe: dict | None = None, moe_every: int = 2) -> None:
        super().__init__()
        self.names = []
        for index in range(span):
            is_moe = moe is not None and index % moe_every == moe_every - 1
            name = f'moe_{index}' if is_moe else f'd_{index}'
            self.add_module(name, Block(dim, heads, mlp_ratio, device=device,
                                        moe=moe if is_moe else None))
            self.names.append(name)

    def forward(self, hidden, dtype, attentions: dict, rate: float = 0.0,
                tp: tuple | None = None, keys: dict | None = None):
        aux_terms = []
        for name in self.names:
            block = getattr(self, name)
            out = block(hidden, dtype, attentions[name], rate,
                        (keys or {}).get(name, (None, None)), tp)
            if block.moe is not None:
                hidden, aux = out
                aux_terms.append(aux)
            else:
                hidden = out
        if not aux_terms:
            return hidden
        return hidden, torch.stack(aux_terms).mean()


def _clone_moe(block: Block, layer_updates: dict) -> Block:
    """A shallow clone of an MoE block whose expert layer reads other mode
    fields (the parameters stay shared)."""
    block = copy.copy(block)
    layer = copy.copy(block.moe)
    layer._parameters = dict(layer._parameters)
    for field, value in layer_updates.items():
        setattr(layer, field, value)
    block._modules = dict(block._modules, moe=layer)
    return block


# GPT2 field -> the MoEMLP setting it governs; decode mode dispatches at
# full capacity (capacity = the call's token count), so routing drops no
# token and a row's experts never depend on its co-batched neighbours
MOE_LAYER_FIELDS = {'moe_k': 'k', 'moe_capacity_factor': 'capacity_factor',
                    'moe_exchange': 'exchange',
                    'moe_sparse_impl': 'sparse_impl', 'dtype': 'dtype',
                    'decode': 'full_capacity', 'mesh': 'mesh',
                    'schedule': 'schedule'}


def block_tp_rules() -> tuple:
    """One block's tensor-parallel rules (``gpt2.py:28``)."""
    from tpusystem_torch.parallel.mesh import PartitionSpec as P
    return ((r'attn/qkv/kernel$', P(None, 'model')),
            (r'attn/out/kernel$', P('model', None)),
            (r'fc/kernel$', P(None, 'model')),
            (r'proj/kernel$', P('model', None)))


def sequence_offset(attention: str, mesh, length: int) -> int:
    """The first position of this rank's chunk: under the sequence-parallel
    kernels over a ``seq`` axis of more than one rank, a rank holds
    positions ``[index * length, (index + 1) * length)`` of its rows."""
    if (attention not in ('ring', 'ulysses') or mesh is None
            or mesh.shape[SEQ] == 1):
        return 0
    return mesh.axis_index(SEQ) * length


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


def scanned_dropout_keys(rng, units: int, names) -> list[dict]:
    """The dropout keys of a scanned stack's ``units`` units from the
    step's key ``rng``: for each unit ``{name: (attention, attention
    output, FFN output)}`` over its blocks' ``names`` (``None`` for a plain
    block template). ``nn.scan(split_rngs={'dropout': True})`` gives unit
    ``j`` key ``j`` of ``split(rng, units)`` in place of ``rng``, under the
    template's path ``hs`` (``tpusystem/models/gpt2.py:440``); a block's
    sites then take flax's ``make_rng`` keys below it, each at count 2:
    flax traces the scanned body twice (once to find its carry's shape),
    and every trace advances the sites' counters."""
    out = []
    for unit in split(as_key(rng), units):
        keys = {}
        for name in names:
            path = ('hs',) if name is None else ('hs', name)
            keys[name] = tuple(make_rng(unit, path + (site,), count=2)
                               for site in ('attn', 'Dropout_0', 'Dropout_1'))
        out.append(keys)
    return out


class GPT2(nn.Module):
    """Decoder-only transformer with learned positions and tied LM head.

    125M preset == defaults (vocab 50257, 12 x 768, 12 heads, seq 1024).
    ``device`` defaults to the card (``'cpu'`` must be asked for); weights
    are drawn from a generator seeded 0 — :meth:`init_weights` redraws
    them, ``load_state_dict`` replaces them.

    ``mesh`` (a :class:`~tpusystem_torch.parallel.mesh.Mesh` of ranks)
    runs tensor parallelism over its ``model`` axis on the pieces the step
    hands over (:meth:`keeps_split`): ``qkv``/``fc`` column-parallel,
    ``out``/``proj`` row-parallel (an all-reduce over ``model``), the
    attention heads split over ``model`` (``attend``'s sharded flash call;
    a decode cache holds this rank's heads), the vocabulary-split ``wte``
    looked up to zero outside a rank's rows and summed, the
    feature-split ``wpe`` gathered, and the tied head on the gathered
    table. ``tp_impl``/``tp_chunks`` or ``schedule`` (an
    :class:`~tpusystem_torch.parallel.schedule.OverlapSchedule`) route the
    dense FFN through :func:`~tpusystem_torch.parallel.schedule.scheduled_ffn`
    where :func:`~tpusystem_torch.parallel.schedule.schedule_applicable`
    holds. The expert layers take the mesh too: over an ``expert`` axis
    each rank holds its experts (:meth:`keeps_split`) and the rows cross by
    ``moe_exchange`` (``'quota'``, ``'ragged'``, ``'ragged-emulated'``;
    ``schedule``'s ``moe=`` arm pipelines the quota exchange), or by the
    dense dispatch where the reference's blocker falls back
    (:class:`~tpusystem_torch.ops.moe.MoEMLP`). None of them changes the
    parameter tree.

    Under a placed step (:func:`~tpusystem_torch.train.build_train_step`)
    the forward gathers the leaves FSDP split one unit at a time
    (``gathers_units``): the embeddings, each block or layer slice, the
    final norm with the tied head; the backward gathers each unit's leaves
    again when it reaches the unit."""

    gathers_units = True

    FIELDS = ('vocab_size', 'layers', 'dim', 'heads', 'max_seq', 'mlp_ratio',
              'dropout', 'dtype', 'attention', 'attn_dropout', 'remat',
              'scan_layers', 'scan_unit',
              'return_features', 'decode', 'per_row_decode', 'decode_pages',
              'moe_experts', 'moe_every', 'moe_k', 'moe_capacity_factor',
              'moe_exchange', 'moe_sparse_impl', 'mesh', 'tp_impl',
              'tp_chunks', 'schedule')

    def __init__(self, vocab_size: int = 50257, layers: int = 12,
                 dim: int = 768, heads: int = 12, max_seq: int = 1024,
                 mlp_ratio: int = 4, dropout: float = 0.1,
                 dtype: str = 'bfloat16', attention: str = 'xla',
                 attn_dropout: float | None = None,
                 remat: bool = False, scan_layers: bool = False,
                 scan_unit: int = 1,
                 return_features: bool = False, decode: bool = False,
                 per_row_decode: bool = False,
                 decode_pages: tuple | None = None, moe_experts: int = 0,
                 moe_every: int = 2, moe_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 moe_exchange: str = 'quota',
                 moe_sparse_impl: str = 'gather', mesh=None,
                 tp_impl: str = 'gspmd', tp_chunks: int = 1, schedule=None,
                 device=None) -> None:
        super().__init__()
        # the reference raises at init; the knob's one resolution
        resolve_schedule(schedule, tp_impl, tp_chunks)
        device = resolve_device(device)
        self.vocab_size, self.layers, self.dim = vocab_size, layers, dim
        self.heads, self.max_seq, self.mlp_ratio = heads, max_seq, mlp_ratio
        self.dropout, self.dtype, self.attention = dropout, dtype, attention
        self.attn_dropout = attn_dropout
        self.remat, self.scan_layers, self.decode = remat, scan_layers, decode
        self.scan_unit = scan_unit
        self.return_features = return_features
        self.per_row_decode, self.decode_pages = per_row_decode, decode_pages
        self.moe_experts, self.moe_every, self.moe_k = (moe_experts,
                                                        moe_every, moe_k)
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_exchange, self.moe_sparse_impl = (moe_exchange,
                                                   moe_sparse_impl)
        self.mesh, self.tp_impl, self.tp_chunks = mesh, tp_impl, tp_chunks
        self.schedule = schedule
        compute_dtype(dtype)                               # validates
        self.wte = Embed(vocab_size, dim, device=device)
        self.wpe = Embed(max_seq, dim, device=device)
        moe = dict(experts=moe_experts, **{
            layer_field: getattr(self, field)
            for field, layer_field in MOE_LAYER_FIELDS.items()})
        if scan_layers:
            span = self.scan_span()
            template = (BlockSpan(dim, heads, mlp_ratio, span, device=device,
                                  moe=moe if moe_experts else None,
                                  moe_every=moe_every) if span
                        else Block(dim, heads, mlp_ratio, device=device))
            self.stacked_names = stack_parameters(template,
                                            layers // max(span, 1))
            self.hs = template
        else:
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

    @property
    def tp(self) -> tuple | None:
        """``(mesh, schedule)`` the blocks run under, ``None`` without a
        mesh."""
        if self.mesh is None:
            return None
        return self.mesh, resolve_schedule(self.schedule, self.tp_impl,
                                           self.tp_chunks)

    def keeps_split(self, name: str) -> tuple:
        """The mesh axes the forward takes the placed leaf ``name`` split
        over (the step gathers it over the others): ``expert`` for the
        expert layers' leaves (each rank runs its own experts), ``model``
        for every other leaf, and ``fsdp`` too for the FFN kernels under
        ``schedule.fsdp='prefetch'``, which the scheduled FFN gathers."""
        if self.mesh is None:
            return ()
        if '.moe.' in name:
            return (EXPERT,)
        prefetch = self.tp[1].fsdp == 'prefetch' and re.search(
            r'(^|\.)(fc|proj)\.kernel$', name)
        return (MODEL, FSDP) if prefetch else (MODEL,)

    def cache_heads(self) -> int:
        """Heads a decode cache holds: this rank's block over a ``model``
        axis that divides them, else all."""
        if heads_split(self.mesh, self.heads):
            return self.heads // self.mesh.shape[MODEL]
        return self.heads

    def scan_span(self) -> int:
        """Layers per scanned unit: 0 for one plain block, else the
        :class:`BlockSpan`'s size (``scan_unit``, or ``moe_every`` for an
        MoE stack), with the reference's ``ValueError`` s
        (``gpt2.py:378-406``) when it does not divide ``layers``."""
        if self.moe_experts:
            span = self.scan_unit if self.scan_unit > 1 else self.moe_every
            if span % self.moe_every:
                raise ValueError(
                    f'scan_unit ({span}) must be a multiple of moe_every '
                    f'({self.moe_every}) so each scanned span carries whole '
                    f'MoE groups')
            if self.layers % span:
                raise ValueError(
                    f'scan_layers with moe_experts needs layers '
                    f'({self.layers}) divisible by the span ({span})')
            return span
        if self.scan_unit > 1:
            if self.layers % self.scan_unit:
                raise ValueError(f'scan_unit={self.scan_unit} must divide '
                                 f'layers ({self.layers})')
            return self.scan_unit
        return 0

    def scan_prefixes(self) -> list[tuple[str | None, str]]:
        """``(block name in the span, cache prefix)`` of each block of the
        scanned unit (``None`` for a plain block template)."""
        if isinstance(self.hs, BlockSpan):
            return [(name, f'hs/{name}/attn') for name in self.hs.names]
        return [(None, 'hs/attn')]

    @staticmethod
    def partition_rules():
        """The reference's Megatron-style rules (``gpt2.py:505``), paths in
        the port's names: qkv/fc split columns on ``model``, out/proj split
        rows, the embeddings split the vocab/position table; the ``hs/``
        rules cover ``scan_layers`` (the same splits one dim right, past
        the layer dim), and the MoE rules the expert stacks. On a mesh with
        ``model=1`` a rule still claims its dimension, so FSDP inference
        picks another one."""
        from tpusystem_torch.ops.moe import moe_partition_rules
        from tpusystem_torch.parallel.mesh import EXPERT
        from tpusystem_torch.parallel.mesh import PartitionSpec as P
        block = block_tp_rules()
        return (
            *tuple((rf'hs/.*{pattern}', P(None, *spec))
                   for pattern, spec in block),
            (r'hs/.*moe/w1$', P(None, EXPERT, None, 'model')),
            (r'hs/.*moe/b1$', P(None, EXPERT, 'model')),
            (r'hs/.*moe/w2$', P(None, EXPERT, 'model', None)),
            (r'hs/.*moe/b2$', P(None, EXPERT, None)),
            (r'hs/.*moe/router$', P()),
            *block,
            (r'wte/embedding$', P('model', None)),
            (r'wpe/embedding$', P(None, 'model')),
        ) + moe_partition_rules()

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
        def draw(name, leaf, param):
            if '.moe.' in name:
                init_parameter(leaf, param, generator)
                return
            if leaf == 'kernel':
                std = param.shape[0] ** -0.5
            elif leaf == 'embedding':
                std = EMBED_STD
            else:
                param.fill_(1.0 if leaf == 'scale' else 0.0)
                return
            param.copy_(torch.randn(param.shape, generator=generator,
                                    device=generator.device) * std)

        for name, param in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            init_stacked(param, functools.partial(draw, name, leaf))

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
            if self.scan_layers:
                span = copy.copy(self.hs)
                span._modules = {
                    name: (_clone_moe(block, layer_updates)
                           if block.moe is not None else block)
                    for name, block in self.hs._modules.items()}
                clone._modules['hs'] = span
            for index in range(0 if self.scan_layers else self.layers):
                if self.is_moe(index):
                    name = f'h_{index}'
                    clone._modules[name] = _clone_moe(self._modules[name],
                                                      layer_updates)
        return clone

    def init_cache(self, batch: int, device=None) -> dict:
        """Zeroed decode cache for ``batch`` rows: the serving engine's paged
        pool when ``decode_pages`` is set, else contiguous strips."""
        device = self.device if device is None else torch.device(device)
        head_dim = self.dim // self.heads
        heads = self.cache_heads()
        dtype = self.compute_dtype
        index = torch.zeros(batch, dtype=torch.int32, device=device)
        cache = {'position': index}
        if self.scan_layers:
            # stacked strips: a leading unit dimension per span position
            units = self.layers // max(self.scan_span(), 1)
            shape = (units, batch, self.max_seq, heads, head_dim)
            for _, prefix in self.scan_prefixes():
                cache[prefix + '/key'] = torch.zeros(shape, dtype=dtype,
                                                     device=device)
                cache[prefix + '/value'] = torch.zeros(shape, dtype=dtype,
                                                       device=device)
                cache[prefix + '/index'] = index.expand(units, batch)
            return cache
        for layer in range(self.layers):
            prefix = f'h_{layer}/attn'
            if self.decode_pages:
                blocks, block = self.decode_pages
                shape = (blocks * block, heads, head_dim)
                cache[prefix + '/table'] = torch.zeros(
                    (batch, self.max_seq // block), dtype=torch.int32,
                    device=device)
            else:
                shape = (batch, self.max_seq, heads, head_dim)
            cache[prefix + '/key'] = torch.zeros(shape, dtype=dtype,
                                                 device=device)
            cache[prefix + '/value'] = torch.zeros(shape, dtype=dtype,
                                                   device=device)
            cache[prefix + '/index'] = index
        return cache

    def dropout_rates(self, train: bool) -> tuple[float, float]:
        """``(rate, attention rate)`` of a forward: 0 outside training;
        ``attn_dropout=None`` follows ``dropout`` on the ``'xla'`` and
        ``'flash'`` kernels and is 0 on the sequence-parallel ones."""
        if not train:
            return 0.0, 0.0
        if self.attn_dropout is not None:
            return self.dropout, self.attn_dropout
        follows = self.attention in ('xla', 'flash')
        return self.dropout, self.dropout if follows else 0.0

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
            positions = steps + sequence_offset(self.attention, self.mesh,
                                                length)
        # every mask's key, derived before any block runs (see the docstring)
        dropping = bool(rate or attn_rate)
        embed_key, block_keys = (dropout_keys(rng, self.layers) if dropping
                                 else (None, [(None,) * 3] * self.layers))
        mesh, tp = self.mesh, self.tp
        # the units of per-unit FSDP gathering: the embeddings, each block
        # (or layer slice), the final norm with the head; a unit's leaves
        # are gathered when it is entered (parallel/sharding.py gathered)
        embedded = (vocab_lookup(gathered(self.wte.embedding), tokens, mesh)
                    + feature_lookup(gathered(self.wpe.embedding), positions,
                                     mesh))
        hidden = apply_dropout(embedded, rate, embed_key).to(dtype)
        aux_losses = []
        remat = self.remat and not self.decode and torch.is_grad_enabled()
        if self.scan_layers:
            hidden, aux_losses = self._scanned(
                hidden, dtype, cache, depth, remat, rate, attn_rate,
                rng if dropping else None)
        for index, block in enumerate(() if self.scan_layers
                                      else self.blocks()):
            attn_key, *output_keys = block_keys[index]
            if self.decode:
                attention = self._cached(functools.partial(
                    cached_attention, cache=cache, prefix=f'h_{index}/attn',
                    max_seq=self.max_seq,
                    per_row=self.per_row_decode, pages=self.decode_pages,
                    depth=depth))
            else:
                attention = functools.partial(attend, kernel=self.attention,
                                              dropout=attn_rate, rng=attn_key,
                                              mesh=mesh)
            run = as_unit(block, remat)
            hidden = run(hidden, dtype, attention, rate, tuple(output_keys),
                         tp)
            if self.is_moe(index):
                hidden, aux = hidden
                aux_losses.append(aux)
        features = as_unit(self.ln_f)(hidden).to(dtype)
        table = whole_rows(gathered(self.wte.embedding), mesh).to(dtype)
        if self.scan_layers and aux_losses:
            # the reference's scanned aux: the mean over spans of each
            # span's mean router loss
            aux_losses = [torch.stack(aux_losses).mean()]
        if self.return_features:
            # the criterion owns the head: the [batch * seq, vocab] float32
            # logits never form (ChunkedNextTokenLoss)
            outputs = (features, table)
        else:
            outputs = head_logits(features, table, tied=True)
        if self.moe_experts and not self.decode:
            # the arity follows the configuration, not which layers are MoE;
            # in decode mode the router loss means nothing and is dropped
            aux = (torch.stack(aux_losses).mean() if aux_losses
                   else features.new_zeros((), dtype=torch.float32))
            return outputs, aux
        return (outputs, cache) if self.decode else outputs


    def _cached(self, attention):
        """A decode attention over this rank's heads where the cache holds
        them (:meth:`cache_heads`)."""
        if heads_split(self.mesh, self.heads):
            return local_heads(attention, self.mesh)
        return attention

    def _scanned(self, hidden, dtype, cache, depth, remat, rate=0.0,
                 attn_rate=0.0, rng=None):
        """The scanned stack: the template applied to each unit's parameter
        slices (one ``unbind`` a parameter); in decode mode each unit reads
        and writes its slice of the stacked caches. With ``rng`` each unit
        drops with its :func:`scanned_dropout_keys`."""
        template, prefixes = self.hs, self.scan_prefixes()
        strips: dict[str, list] = {}
        aux_terms = []
        units = layer_slices(template, self.stacked_names)
        names = [name for name, _ in prefixes]
        unit_keys = (scanned_dropout_keys(rng, len(units), names)
                     if rng is not None
                     else [dict.fromkeys(names, (None,) * 3)] * len(units))
        for unit, slices in enumerate(units):
            attentions = {}
            keys = unit_keys[unit]
            for name, prefix in prefixes:
                attentions[name] = (self._cached(functools.partial(
                    cached_attention, cache=unit_cache(cache, prefix, unit,
                                                       strips),
                    prefix=prefix, max_seq=self.max_seq,
                    per_row=self.per_row_decode, pages=self.decode_pages,
                    depth=depth)) if self.decode else functools.partial(
                        attend, kernel=self.attention, mesh=self.mesh,
                        dropout=attn_rate, rng=keys[name][0]))
            span = isinstance(template, BlockSpan)
            args = ((dtype, attentions, rate, self.tp,
                     {name: key[1:] for name, key in keys.items()}) if span
                    else (dtype, attentions[None], rate, keys[None][1:],
                          self.tp))
            hidden = apply_unit(template, self.stacked_names, slices, hidden,
                                args, remat)
            if isinstance(hidden, tuple):
                hidden, aux = hidden
                aux_terms.append(aux)
        restack_caches(cache, strips)
        return hidden, aux_terms


register(GPT2, excluded_kwargs={'device', 'mesh'})


class GPT2Pipelined(nn.Module):
    """GPT-2 with its block stack pipelined over the ``stage`` mesh axis
    (``tpusystem/models/gpt2.py:536``).

    The blocks are one template whose parameters are stacked at a leading
    ``layers`` dimension under ``h`` (``h.attn.qkv.kernel`` is ``[layers,
    dim, 3 * dim]``; with ``interleave = v > 1`` chunk-major ``[v, layers /
    v, ...]``, a plain reshape of the layer-major stack), run through
    :func:`~tpusystem_torch.parallel.pipeline.pipeline_apply`: each stage
    holds ``layers / stages`` of them, and microbatches ride the stage
    ring. The embeddings, the final layernorm and the tied head run on
    every rank. Dropout is 0 inside the pipe and attention is the einsum
    path (``'xla'``), as in the reference. ``forward(tokens)`` returns
    logits (``(features, table)`` with ``return_features``), or with
    ``moe_experts > 0`` (every ``moe_every``-th block's FFN an MoE layer on
    its ``'gather'`` path; the stacked unit a :class:`BlockSpan` of
    ``moe_every`` blocks) ``(outputs, aux)``, the router losses through the
    pipeline's aux channel; only the GPipe path takes MoE spans
    (:func:`~tpusystem_torch.train.build_1f1b_train_step` refuses them).

    ``schedule=OverlapSchedule(pp='overlap', ...)`` skews the GPipe loop
    (each stage-to-stage hop issued before the microbatch compute it could
    run under). Its ``tp=`` and ``fsdp=`` arms stay off inside the stages,
    where the blocks take the Megatron products over ``model`` (PP x TP)
    and their kernels arrive gathered over ``fsdp``; its ``moe=`` arm has
    nothing to pipeline on one expert shard. None of them changes the
    parameter tree. ``mesh`` is required; the step hands each ``h`` leaf to
    the forward as this rank's stage piece (:meth:`keeps_split`), and a
    forward given whole stacks takes its slice of them."""

    def __init__(self, vocab_size: int = 50257, layers: int = 12,
                 dim: int = 768, heads: int = 12, max_seq: int = 1024,
                 mlp_ratio: int = 4, dtype: str = 'bfloat16',
                 microbatches: int = 4, remat: bool = True, mesh=None,
                 return_features: bool = False, interleave: int = 1,
                 schedule=None, moe_experts: int = 0, moe_every: int = 2,
                 moe_k: int = 2, moe_capacity_factor: float = 1.25,
                 device=None) -> None:
        super().__init__()
        if mesh is None:
            raise ValueError('GPT2Pipelined needs a mesh with a stage axis')
        if layers % max(interleave, 1):
            raise ValueError(f'{layers} layers not divisible by '
                             f'interleave={interleave}')
        device = resolve_device(device)
        self.vocab_size, self.layers, self.dim = vocab_size, layers, dim
        self.heads, self.max_seq, self.mlp_ratio = heads, max_seq, mlp_ratio
        self.dtype = dtype
        self.microbatches, self.remat, self.mesh = microbatches, remat, mesh
        self.return_features, self.interleave = return_features, interleave
        self.schedule = schedule
        self.moe_experts, self.moe_every = moe_experts, moe_every
        self.moe_k, self.moe_capacity_factor = moe_k, moe_capacity_factor
        compute_dtype(dtype)                               # validates
        if moe_experts:
            if interleave > 1:
                raise ValueError('moe_experts with interleave > 1 is not '
                                 'supported (the aux channel rides the '
                                 'plain GPipe schedule)')
            if layers % moe_every:
                raise ValueError(f'{layers} layers not divisible by '
                                 f'moe_every ({moe_every})')
            moe = dict(experts=moe_experts, k=moe_k,
                       capacity_factor=moe_capacity_factor,
                       sparse_impl='gather', dtype=dtype,
                       full_capacity=False)
            template = BlockSpan(dim, heads, mlp_ratio, moe_every,
                                 device=device, moe=moe, moe_every=moe_every)
            self.stacked_units = layers // moe_every
        else:
            template = Block(dim, heads, mlp_ratio, device=device)
            self.stacked_units = layers
        self.stacked_key = 'h'  # the stage-split layer stack's parameters
        self.wte = Embed(vocab_size, dim, device=device)
        self.wpe = Embed(max_seq, dim, device=device)
        lead = ((self.stacked_units,) if interleave <= 1
                else (interleave, self.stacked_units // interleave))
        for sub in template.modules():
            for name, param in list(sub._parameters.items()):
                sub._parameters[name] = nn.Parameter(param.detach().expand(
                    lead + tuple(param.shape)).clone())
        self.h = template
        self.ln_f = LayerNorm(dim, device=device)
        self.init_weights(torch.Generator(device).manual_seed(0))

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    @property
    def device(self) -> torch.device:
        return self.wte.embedding.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator``, each stacked layer slice
        as :meth:`GPT2.init_weights` draws a layer's."""
        lead = 1 if self.interleave <= 1 else 2
        for name, param in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            stacked = name.startswith('h.')
            pieces = (param.reshape((-1,) + tuple(param.shape[lead:]))
                      .unbind(0) if stacked else (param,))
            for piece in pieces:
                if '.moe.' in name:
                    init_parameter(leaf, piece, generator)
                elif leaf == 'kernel':
                    piece.copy_(torch.randn(piece.shape, generator=generator,
                                            device=generator.device)
                                * piece.shape[0] ** -0.5)
                elif leaf == 'embedding':
                    piece.copy_(torch.randn(piece.shape, generator=generator,
                                            device=generator.device)
                                * EMBED_STD)
                else:
                    piece.fill_(1.0 if leaf == 'scale' else 0.0)

    def keeps_split(self, name: str) -> tuple:
        """The mesh axes the forward takes the placed leaf ``name`` split
        over: a stacked leaf's ``stage`` piece (and its ``model`` block
        under PP x TP); every other leaf whole."""
        return (MODEL, STAGE) if name.startswith('h.') else ()

    def _params(self) -> dict:
        """Every parameter as the module holds it now (inside a
        ``functional_call``, the caller's tensors)."""
        return {name: lookup(self, name) for name, _ in
                self.named_parameters()}

    def _embed(self, params: dict, tokens):
        length = tokens.shape[-1]
        if length > self.max_seq:
            raise ValueError(f'sequence length {length} exceeds '
                             f'max_seq={self.max_seq}')
        positions = torch.arange(length, device=tokens.device)
        hidden = (params['wte.embedding'][tokens.long()]
                  + params['wpe.embedding'][positions])
        return hidden.to(self.compute_dtype)

    def _head(self, params: dict, hidden):
        # the unpipelined family's ln_f, applied to the given parameters
        hidden = layer_norm(hidden, params['ln_f.scale'], params['ln_f.bias'])
        table = params['wte.embedding'].to(self.compute_dtype)
        if self.return_features:
            # the criterion owns the head (ChunkedNextTokenLoss)
            return hidden.to(self.compute_dtype), table
        return head_logits(hidden, table, tied=True)

    def _block_fn(self):
        """``(layer_params, x) -> x`` (``(x, aux)`` for an MoE span), the
        template applied to one layer's slices; under a ``model`` axis of
        more than one rank the blocks take the Megatron products."""
        from tpusystem_torch.parallel.schedule import OverlapSchedule
        template, dtype = self.h, self.compute_dtype
        attention = functools.partial(attend, kernel='xla')
        tp = ((self.mesh, OverlapSchedule())
              if self.mesh.shape[MODEL] > 1 else None)
        if isinstance(template, BlockSpan):
            attentions = {name: attention for name in template.names}
            args = (dtype, attentions, 0.0, tp)
        else:
            args = (dtype, attention, 0.0, (None, None), tp)

        def block_fn(layer_params, activations):
            return torch.func.functional_call(template, layer_params,
                                              (activations, *args))
        return block_fn

    def _stacked(self, params: dict) -> dict:
        """The stacked leaves, keyed by their names in the template."""
        return {name[2:]: leaf for name, leaf in params.items()
                if name.startswith('h.')}

    def _flat_stack(self, stacked: dict) -> dict:
        """Layer-major view of the stacked leaves (undoes the chunk-major
        interleave storage; the identity when interleave == 1)."""
        if self.interleave <= 1:
            return stacked
        return {name: leaf.reshape((self.layers,) + tuple(leaf.shape[2:]))
                for name, leaf in stacked.items()}

    def forward(self, tokens, train: bool = False):
        from tpusystem_torch.parallel.pipeline import pipeline_apply
        params = self._params()
        hidden = pipeline_apply(self._block_fn(), self._stacked(params),
                                self._embed(params, tokens), self.mesh,
                                microbatches=self.microbatches,
                                remat=self.remat, interleave=self.interleave,
                                schedule=self.schedule,
                                has_aux=bool(self.moe_experts))
        if self.moe_experts:
            hidden, aux = hidden
            return self._head(params, hidden), aux
        return self._head(params, hidden)

    def sequential_apply(self, tokens):
        """The forward without the pipeline (the correctness harness), on
        the module's whole stacks. With MoE spans the aux is the mean over
        span units on the whole batch, where the pipelined one averages
        per-microbatch means: they agree only approximately."""
        from tpusystem_torch.parallel.pipeline import _stage_scan
        params = self._params()
        hidden = self._embed(params, tokens)
        body = _stage_scan(self._block_fn(), has_aux=bool(self.moe_experts))
        out = body(self._flat_stack(self._stacked(params)), hidden)
        if self.moe_experts:
            hidden, aux_sum = out
            return self._head(params, hidden), aux_sum / self.stacked_units
        return self._head(params, out)

    @staticmethod
    def block_partition_rules():
        """Megatron rules for the within-stack block leaf paths
        (``attn/qkv/kernel`` etc., no layer dimension): the unpipelined
        family's block rules. :func:`~tpusystem_torch.parallel.pipeline.
        PipelineParallel` ``(stacked_rules=...)`` shifts them past the
        stage dimension(s)."""
        return block_tp_rules()

    def partition_rules(self):
        """Stage splitting for the stacked blocks, composed with the
        Megatron within-stage splits; embeddings and layernorm
        replicated. With interleave the chunk-major stack splits its
        second dimension."""
        from tpusystem_torch.parallel.pipeline import compose_stacked_rules
        return compose_stacked_rules(r'(^|/)h/', self.block_partition_rules(),
                                     self.interleave)


register(GPT2Pipelined, excluded_kwargs={'device', 'mesh'})


def gpt2_small(**overrides) -> GPT2:
    return GPT2(**overrides)


def gpt2_tiny(**overrides) -> GPT2:
    """Test scale: runs in seconds on the CPU."""
    config = dict(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                  dropout=0.0)
    config.update(overrides)
    return GPT2(**config)
