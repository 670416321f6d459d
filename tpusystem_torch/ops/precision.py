"""The LM head's precision rule: compute-dtype operands, float32 logits.

Port of :func:`tpusystem.ops.precision.head_logits`. The reference runs the
head as a bf16 x bf16 product accumulated in float32. ``torch.matmul`` on
bf16 operands returns bf16, so the port rounds both operands to the
compute dtype, widens them to float32 and multiplies in float32: the same
products, summed in float32. TF32 would keep only ~10 mantissa bits of each
operand, so :func:`head_logits` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
before the product. In training the product runs in float32 outside the
tensor cores, forward and backward, by the same rule (a speed item in
ROADMAP). The streamed int8/fp8 quantization of the reference module is
not ported yet.
"""

from __future__ import annotations

import torch


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
