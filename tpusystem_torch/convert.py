"""Carry parameters over from the JAX package.

The port keeps the reference's parameter names and layouts (a flax
``Dense`` kernel stays ``[in, out]``), so the conversion is a flattening:
the nested param tree's path ``h_0/attn/qkv/kernel`` becomes the state-dict
key ``h_0.attn.qkv.kernel`` (a DLRM's ``table_3/embedding`` becomes
``table_3.embedding``, a TwoTower's ``user_tower/fc_0/kernel``
``user_tower.fc_0.kernel``). Leaves arrive as numpy arrays (or anything
``numpy.asarray`` takes), so this module needs no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _tensor(leaf) -> torch.Tensor:
    array = np.asarray(leaf)
    if array.dtype.name == 'bfloat16':       # ml_dtypes: no torch equivalent
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(array, copy=True))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """State dict (CPU tensors) of a JAX param tree, name for name: load it
    with ``module.load_state_dict`` or pass it as ``params`` to
    :func:`tpusystem_torch.train.generate` and
    :class:`tpusystem_torch.serve.Engine`."""
    flat: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for name, child in node.items():
                walk(child, path + (str(name),))
        else:
            flat['.'.join(path)] = _tensor(node)

    walk(tree, ())
    return flat
