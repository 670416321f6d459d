"""Precision rules: the LM head's, and the streamed int8/fp8 weights of
decoding.

Port of :func:`tpusystem.ops.precision.head_logits` and of the reference's
streamed quantization (``precision.py:69-200``). The reference runs the
head as a bf16 x bf16 product accumulated in float32. ``torch.matmul`` on
bf16 operands returns bf16, so the port rounds both operands to the
compute dtype, widens them to float32 and multiplies in float32: the same
products, summed in float32. TF32 would keep only ~10 mantissa bits of each
operand, so :func:`head_logits` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
before the product. In training the product runs in float32 outside the
tensor cores, forward and backward, by the same rule (a speed item in
ROADMAP).

Streamed quantization: :func:`quantize_streamed` turns a state dict's float
matrices into :class:`QuantizedLeaf` s (int8 or float8 e4m3 values and a
float32 scale per output channel), which the decode kernels read narrow and
widen on chip (:mod:`tpusystem_torch.ops.cuda.decode_matmul`); :func:`qdot`
is their arithmetic in plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

# symmetric range per streamable narrow dtype: int8 uses the full signed
# range minus the asymmetric -128 (so negation is exact), fp8 e4m3fn its
# largest finite (the cast would leave the range past it, hence the clip)
QMAX = {'int8': 127.0, 'fp8': 448.0}
QDTYPES = {'int8': torch.int8, 'fp8': torch.float8_e4m3fn}


def head_logits(features, table, *, tied: bool | None = None):
    """Project ``[..., dim]`` features onto the vocabulary: float32 logits
    from operands rounded to ``table``'s dtype.

    ``tied=True`` means ``table`` is a ``[vocab, dim]`` embedding table
    (GPT-2), ``tied=False`` a ``[dim, vocab]`` head kernel. ``tied=None``
    infers the orientation from the shapes but refuses a square table,
    where guessing would silently transpose the head."""
    dim = features.shape[-1]
    if tied is None:
        if table.shape[0] == table.shape[1]:
            raise ValueError(f'square head table {tuple(table.shape)}: pass '
                             'tied= explicitly')
        tied = table.shape[-1] == dim
    table_dim = 1 if tied else 0
    if table.shape[table_dim] != dim:
        raise ValueError(
            f'feature dim {dim} does not match table {tuple(table.shape)} '
            f'(tied={tied})')
    torch.backends.cuda.matmul.allow_tf32 = False
    features = features.to(table.dtype).float()
    weight = table.float()
    return torch.matmul(features, weight.t() if tied else weight)


def _qdtype(mode: str) -> torch.dtype:
    if mode not in QDTYPES:
        raise ValueError(f'unknown quantized stream mode {mode!r}; '
                         f'expected one of {tuple(QMAX)}')
    return QDTYPES[mode]


@dataclasses.dataclass
class QuantizedLeaf:
    """A matrix streamed narrow: ``values`` (int8 or float8 e4m3, the
    original matrix's shape) and float32 ``scales`` per output channel (the
    matrix's shape with the contraction dim, second to last, reduced to 1),
    so ``values * scales`` broadcasts back to the dequantized matrix."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.values.nbytes + self.scales.nbytes


def quantize_leaf(leaf: torch.Tensor, mode: str) -> QuantizedLeaf:
    """Per-output-channel symmetric quantization of one ``[..., in, out]``
    matrix (``precision.py:115``): ``scales = absmax(leaf, dim=-2) /
    QMAX``, all-zero columns scale 1, values clipped into ``[-QMAX,
    QMAX]`` and then rounded half to even (int8) or cast (fp8)."""
    qdtype, qmax = _qdtype(mode), QMAX[mode]
    wide = leaf.float()
    absmax = wide.abs().amax(dim=-2, keepdim=True)
    scales = torch.where(absmax > 0.0, absmax,
                         torch.full_like(absmax, qmax)) / qmax
    scaled = torch.clamp(wide / scales, -qmax, qmax)
    if mode == 'int8':
        scaled = torch.round(scaled)
    return QuantizedLeaf(scaled.to(qdtype), scales)


def dequantize_leaf(leaf: QuantizedLeaf, compute=None) -> torch.Tensor:
    """``values * scales`` in float32, rounded once to ``compute`` (default:
    float32): what the module path of decoding multiplies by."""
    wide = leaf.values.float() * leaf.scales
    return wide if compute is None else wide.to(compute)


def quantize_streamed(params: dict, mode: str) -> dict:
    """A state dict with its streamed matrices quantized to ``mode``
    (``'int8'`` / ``'fp8'``): float tensors of two or more dims, except
    the embedding tables (the embed step sums wte and wpe rows in float32,
    and the tied head needs the table exact) and MoE routers (float32 gate
    logits), as ``precision.py:158-166`` selects them. Other leaves are
    returned as they are."""
    _qdtype(mode)                                   # validates eagerly
    return {name: (quantize_leaf(leaf, mode)
                   if 'embedding' not in name and 'router' not in name
                   and leaf.dim() >= 2 and leaf.is_floating_point()
                   else leaf)
            for name, leaf in params.items()}


def dequantize_streamed(params: dict, compute=None) -> dict:
    """Every :class:`QuantizedLeaf` of ``params`` replaced by its
    dequantized matrix in ``compute``; the same dict, unchanged, when
    nothing in it is quantized."""
    if not any(isinstance(leaf, QuantizedLeaf) for leaf in params.values()):
        return params
    return {name: (dequantize_leaf(leaf, compute)
                   if isinstance(leaf, QuantizedLeaf) else leaf)
            for name, leaf in params.items()}


def qdot(x, w, *, compute=None) -> torch.Tensor:
    """``x @ w`` with float32 sums: a :class:`QuantizedLeaf`'s narrow values
    are cast to the compute dtype (``x``'s by default) as the operand, and
    the per-channel scale multiplies the float32 sum once, as the decode
    kernels do; a plain ``w`` is cast to the compute dtype. Returns
    float32."""
    compute = compute or x.dtype
    if isinstance(w, QuantizedLeaf):
        product = torch.matmul(x.float(), w.values.to(compute).float())
        return product * w.scales.reshape(-1)
    return torch.matmul(x.float(), w.to(compute).float())
