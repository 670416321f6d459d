"""Multi-layer perceptron: the port of :mod:`tpusystem.models.mlp`.

The flattening classifier of the verybasic example: per hidden width a
dense layer, ReLU and dropout, then a float32 dense head onto the classes.
The layers are ``torch.nn.Linear`` modules named as flax names the
reference's (``Dense_0`` ... ``Dense_{n}``, the head last), so
:func:`tpusystem_torch.convert.params_from_jax` carries its parameters
across (a flax ``[in, out]`` kernel becomes a ``Linear.weight [out, in]``).

Dropout is flax's: in training, ``Dropout_{i}``'s mask is
``bernoulli(make_rng(rng, ('Dropout_{i}',)), 1 - dropout)`` of the step's
threefry key ``rng`` (flax's ``make_rng('dropout')`` at that module path),
one kernel on the card
(:func:`tpusystem_torch.ops.cuda.threefry.bernoulli_mask`). Weights are
drawn from a generator seeded 0 on the module's device (kernels normal with
std ``fan_in ** -0.5``, zero biases); :meth:`MLP.init_weights` redraws them.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import compute_dtype, resolve_device
from tpusystem_torch.ops.attention import apply_dropout
from tpusystem_torch.ops.threefry import as_key, make_rng
from tpusystem_torch.registry import register


class MLP(nn.Module):
    """Flattening MLP classifier with dropout between hidden layers.

    Args:
        features: hidden-layer widths.
        classes: output dimension.
        dropout: drop probability applied after each hidden activation.
        dtype: the hidden layers' compute dtype (``'float32'``,
            ``'bfloat16'``); the head computes in float32.
        device: where the weights live; ``None`` is the card.
    """

    def __init__(self, features: Sequence[int] = (256, 128),
                 classes: int = 10, dropout: float = 0.1,
                 dtype: str = 'float32', *, features_in: int = 28 * 28,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.features, self.classes = tuple(features), classes
        self.dropout, self.dtype = dropout, dtype
        compute_dtype(dtype)                               # validates
        for index, width in enumerate(self.features):
            self.add_module(f'Dense_{index}',
                            nn.Linear(features_in, width, device=device))
            features_in = width
        self.add_module(f'Dense_{len(self.features)}',
                        nn.Linear(features_in, classes, device=device))
        self.init_weights(torch.Generator(device).manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every layer from ``generator``: weights normal with std
        ``fan_in ** -0.5``, biases zero."""
        for layer in self.children():
            layer.weight.normal_(0.0, layer.weight.shape[1] ** -0.5,
                                 generator=generator)
            layer.bias.zero_()

    def forward(self, inputs, train: bool = False, rng=None):
        """Float32 logits ``[batch, classes]``. A training forward with
        dropout draws its masks from ``rng``, the step's threefry key."""
        if train and self.dropout and rng is None:
            raise ValueError('a training forward with dropout needs rng=, a '
                             'threefry key')
        dtype = compute_dtype(self.dtype)
        hidden = inputs.reshape(inputs.shape[0], -1).to(dtype)
        depth = len(self.features)
        for index in range(depth):
            layer = getattr(self, f'Dense_{index}')
            hidden = F.relu(F.linear(hidden, layer.weight.to(dtype),
                                     layer.bias.to(dtype)))
            if train and self.dropout:
                key = make_rng(as_key(rng), (f'Dropout_{index}',))
                hidden = apply_dropout(hidden, self.dropout, key)
        head = getattr(self, f'Dense_{depth}')
        return F.linear(hidden.float(), head.weight, head.bias)


register(MLP, excluded_kwargs={'device'})
