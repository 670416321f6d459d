"""Carry parameters over from the JAX package.

The port keeps the reference's parameter names and layouts (a flax
``Dense`` kernel stays ``[in, out]``), so the conversion is a flattening:
the nested param tree's path ``h_0/attn/qkv/kernel`` becomes the state-dict
key ``h_0.attn.qkv.kernel`` (a DLRM's ``table_3/embedding`` becomes
``table_3.embedding``, a TwoTower's ``user_tower/fc_0/kernel``
``user_tower.fc_0.kernel``). One exception: a dense layer flax names itself
(``Dense_{i}``, the MLP's) is a ``torch.nn.Linear`` in the port, so its
``[in, out]`` kernel becomes ``Dense_{i}.weight``, transposed to
``[out, in]``. A scanned model's stacked tree maps the same way: ``hs/attn/
qkv/kernel`` of shape ``[layers, in, out]`` is the stacked parameter
``hs.attn.qkv.kernel`` of the port's ``GPT2(scan_layers=True)``, an MoE or
``scan_unit`` span's ``hs/d_0/...`` and ``hs/moe_1/moe/w1`` are
``hs.d_0....`` and ``hs.moe_1.moe.w1``, and Llama's ``blocks/...`` is
``blocks....`` (:mod:`tpusystem_torch.models.scan`); a pipelined model's
``h/attn/qkv/kernel`` (``[layers, in, out]``, or chunk-major ``[v, layers
/ v, in, out]`` under ``interleave = v``) and its MoE spans' ``h/moe_1/moe/
w1`` are ``GPT2Pipelined``'s ``h.attn.qkv.kernel`` and ``h.moe_1.moe.w1``. Leaves arrive as numpy arrays (or anything ``numpy.asarray``
takes), so this module needs no JAX.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

# a flax-named dense layer's kernel: a torch Linear's weight in the port
LINEAR_KERNEL = re.compile(r'(^|\.)Dense_\d+\.kernel$')


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
            name, tensor = '.'.join(path), _tensor(node)
            if LINEAR_KERNEL.search(name):
                name, tensor = name[:-len('kernel')] + 'weight', tensor.T
            flat[name] = tensor.contiguous()

    walk(tree, ())
    return flat
