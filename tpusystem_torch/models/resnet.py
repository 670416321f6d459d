"""ResNet family: the port of :mod:`tpusystem.models.resnet`.

A bottleneck ResNet over NHWC images (the reference's entry layout), with
GroupNorm in place of BatchNorm (stateless, so the train step stays one
function of the state), convolutions in the compute dtype and every norm,
the residual stream, the pooled mean and the head in float32.

Inside, activations are NCHW tensors in ``torch.channels_last`` memory (an
NHWC image permuted, no copy), so cuDNN gets NHWC memory; the convolutions
are ``F.conv2d`` and the norms ``F.group_norm`` (the reference's convs and
norms are XLA's, not Pallas kernels). Parameters keep the reference's names
and layouts: a conv ``kernel`` is HWIO, a norm has ``scale`` and ``bias``,
the head's ``kernel`` is ``[in, out]``; the kernels are permuted to OIHW
inside ``forward``. So :func:`tpusystem_torch.convert.params_from_jax`
carries a ResNet across name for name. :meth:`ResNet.partition_rules`
are the reference's (the head's classes over ``model``; the convs left to
the data and fsdp axes).

flax pads ``'SAME'``: at stride 2 the padding is asymmetric (a 7x7 stride-2
conv pads 2 before and 3 after; a 3x3 stride-2 conv or max-pool on an even
size pads 0 and 1), so an asymmetric pad is an ``F.pad`` before an unpadded
conv (the pool's with ``-inf``). flax's ``GroupNorm`` epsilon is 1e-6.

Weights are drawn from a generator seeded 0 on the module's device (conv
and head kernels normal with std ``fan_in ** -0.5``, norm scales one,
biases zero); :meth:`ResNet.init_weights` redraws them. A module built on
the ``meta`` device holds shapes only and draws nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.registry import register

# flax GroupNorm's default epsilon (PyTorch's is 1e-5)
EPSILON = 1e-6


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``'SAME'`` padding of one spatial dim: the output is
    ``ceil(size / stride)`` and the extra element, if any, goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(hidden: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> tuple[torch.Tensor, tuple[int, int]]:
    """``hidden`` (NCHW) ready for an op with ``padding=`` the returned
    pair: symmetric pads stay with the op, asymmetric ones are applied
    here with ``value``."""
    (top, bottom), (left, right) = (same_pads(hidden.shape[2], kernel, stride),
                                    same_pads(hidden.shape[3], kernel, stride))
    if top == bottom and left == right:
        return hidden, (top, left)
    return F.pad(hidden, (left, right, top, bottom), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias, ``'SAME'`` padding: ``kernel``
    ``[size, size, in, out]`` (HWIO)."""

    def __init__(self, in_features: int, features: int, size: int,
                 stride: int, device) -> None:
        super().__init__()
        self.size, self.stride = size, stride
        self.kernel = nn.Parameter(torch.empty(size, size, in_features,
                                               features, device=device))

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype):
        """Cast ``hidden`` (NCHW) and the kernel to ``dtype`` and convolve;
        the output is in ``dtype``, channels-last."""
        weight = self.kernel.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        hidden, padding = _pad_same(hidden.to(dtype), self.size, self.stride)
        return F.conv2d(hidden, weight, stride=self.stride, padding=padding)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(dtype=float32)``: statistics and output in
    float32, epsilon 1e-6, ``scale``/``bias`` per channel."""

    def __init__(self, features: int, groups: int, device) -> None:
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.group_norm(hidden.float(), self.groups, self.scale,
                            self.bias, EPSILON)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut on
    stride/width changes (the ResNet-50 block); the stride sits on the
    3x3 conv and the projection."""

    def __init__(self, in_features: int, features: int, stride: int,
                 groups: int, device) -> None:
        super().__init__()
        out_features = 4 * features
        self.project = stride != 1 or in_features != out_features
        if self.project:
            self.proj = Conv(in_features, out_features, 1, stride, device)
            self.proj_norm = GroupNorm(out_features, groups, device)
        self.conv1 = Conv(in_features, features, 1, 1, device)
        self.norm1 = GroupNorm(features, groups, device)
        self.conv2 = Conv(features, features, 3, stride, device)
        self.norm2 = GroupNorm(features, groups, device)
        self.conv3 = Conv(features, out_features, 1, 1, device)
        self.norm3 = GroupNorm(out_features, groups, device)

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype):
        shortcut = hidden
        if self.project:
            shortcut = self.proj_norm(self.proj(hidden, dtype))
        hidden = F.relu(self.norm1(self.conv1(hidden, dtype)))
        hidden = F.relu(self.norm2(self.conv2(hidden, dtype)))
        hidden = self.norm3(self.conv3(hidden, dtype))
        return F.relu(hidden + shortcut)


class ResNet(nn.Module):
    """Bottleneck ResNet over NHWC images. Defaults are ResNet-50
    (stages 3-4-6-3, widths 64-128-256-512, 1000 classes).

    Args:
        classes: output dimension of the float32 head.
        stages: blocks per stage; stage ``s`` has width ``width * 2**s``
            and its first block strides 2 (but the first stage's).
        width: the stem's width and the first stage's bottleneck width.
        groups: GroupNorm groups.
        dtype: the convolutions' compute dtype (``'bfloat16'``,
            ``'float32'``).
        stem_stride: 2 for a 7x7 stride-2 stem (ImageNet-style), 1 for a
            3x3 stem (small inputs).
        stem_pool: a 3x3 stride-2 max-pool after the stem.
        device: where the weights live; ``None`` is the card.
    """

    def __init__(self, classes: int = 1000, stages: tuple = (3, 4, 6, 3),
                 width: int = 64, groups: int = 32, dtype: str = 'bfloat16',
                 stem_stride: int = 2, stem_pool: bool = True, *,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        compute_dtype(dtype)                               # validates
        self.classes, self.stages = classes, tuple(stages)
        self.width, self.groups, self.dtype = width, groups, dtype
        self.stem_stride, self.stem_pool = stem_stride, stem_pool
        size = 7 if stem_stride == 2 else 3
        self.stem = Conv(3, width, size, stem_stride, device)
        self.stem_norm = GroupNorm(width, groups, device)
        features = width
        for stage, blocks in enumerate(self.stages):
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(f's{stage}_b{block}', Bottleneck(
                    features, width * 2 ** stage, stride, groups, device))
                features = 4 * width * 2 ** stage
        self.head = nn.Module()
        self.head.kernel = nn.Parameter(torch.empty(features, classes,
                                                    device=device))
        self.head.bias = nn.Parameter(torch.empty(classes, device=device))
        if device.type != 'meta':
            self.init_weights(torch.Generator(device).manual_seed(0))

    @staticmethod
    def partition_rules():
        """Classifier head splits classes on ``model`` (``resnet.py:95``);
        conv weights are left to the FSDP/data axes."""
        from tpusystem_torch.parallel.mesh import PartitionSpec as P
        return ((r'head/kernel$', P(None, 'model')),)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every parameter from ``generator``: conv and head kernels
        normal with std ``fan_in ** -0.5``, norm scales one, biases zero."""
        for name, parameter in self.named_parameters():
            if name.endswith('kernel'):
                fan_in = parameter.shape[:-1].numel()
                parameter.normal_(0.0, fan_in ** -0.5, generator=generator)
            elif name.endswith('scale'):
                parameter.fill_(1.0)
            else:
                parameter.zero_()

    def blocks(self) -> list[Bottleneck]:
        return [getattr(self, f's{stage}_b{block}')
                for stage, count in enumerate(self.stages)
                for block in range(count)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Float32 logits ``[batch, classes]`` of NHWC ``images``."""
        dtype = compute_dtype(self.dtype)
        # NHWC memory seen as NCHW: channels-last, no copy
        hidden = images.to(dtype).permute(0, 3, 1, 2)
        hidden = F.relu(self.stem_norm(self.stem(hidden, dtype)))
        if self.stem_pool:
            hidden, padding = _pad_same(hidden, 3, 2, float('-inf'))
            hidden = F.max_pool2d(hidden, 3, 2, padding)
        for block in self.blocks():
            hidden = block(hidden, dtype)
        pooled = hidden.float().mean(dim=(2, 3))           # global average
        return pooled @ self.head.kernel + self.head.bias


register(ResNet, excluded_kwargs={'device'})


def resnet50(**overrides) -> ResNet:
    return ResNet(**overrides)


def resnet_tiny(**overrides) -> ResNet:
    """Test scale: 8-group norm, 2 stages, CIFAR-style stem, float32."""
    config = dict(classes=10, stages=(1, 1), width=16, groups=8,
                  stem_stride=1, stem_pool=False, dtype='float32')
    config.update(overrides)
    return ResNet(**config)
