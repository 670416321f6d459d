"""Rounding of a product's operands, for the references in plain PyTorch.

``float32`` leaves them alone. The lower precisions round each operand of
every product the way the hardware path would (TF32: a 10-bit mantissa;
fp8: e4m3 under a per-tensor scale) and keep float32 accumulation.
The rounding passes gradients straight through, so a reference run at a
lower precision is the control of a correctness check.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0         # the largest finite float8_e4m3fn


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + (((bits >> 13) & 1) + 0x0FFF)) & -0x2000
    return rounded.view(torch.float32)


def _fp8(x):
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDING = {'tf32': _tf32, 'fp8': _fp8}


def operand(precision: str):
    """The function a reference applies to each operand of a product."""
    if precision == 'float32':
        return lambda x: x
    rounding = ROUNDING[precision]

    def cast(x):
        return x + (rounding(x.detach()) - x).detach()
    return cast


def no_tf32(torch_module=torch) -> None:
    """Full float32 products on the card: the references' setting."""
    torch_module.backends.cuda.matmul.allow_tf32 = False
    torch_module.backends.cudnn.allow_tf32 = False
