"""Scanned layer stacks: one template module whose parameters carry a
leading layer (or span) dimension, the port's counterpart of flax's
``nn.scan`` over stacked params (``variable_axes={'params': 0}``).

The stack keeps the reference's parameter names (``hs.attn.qkv.kernel`` of
shape ``[layers, in, out]``), so a JAX tree's stacked leaves load name for
name. A forward takes every parameter's per-layer slices with **one**
``unbind`` (a single ``UnbindBackward`` stacks the gradients once, where
indexing ``stacked[i]`` per layer would allocate a zero tensor the size of
the whole stack for each layer in the backward) and applies the template
to each layer's slices through ``torch.func.functional_call``. Stacked
parameters are marked ``stacked = True``, so the optimizer's global norm
counts them as their layer slices, in layer order, as the unrolled model's
leaves come (:func:`tpusystem_torch.train.optim.global_norm`).

Each layer slice, and each block run through :func:`as_unit`, is a unit of
per-unit FSDP gathering: a leaf a placed step hands over as a stand-in
(:func:`~tpusystem_torch.parallel.sharding.defer_leaf`) is gathered when
its unit is entered and dropped when the unit returns.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpusystem_torch.parallel.sharding import (deferred_layers, gathered,
                                               is_deferred)

CACHE_LEAVES = ('/key', '/value', '/index')


def stack_parameters(module: nn.Module, length: int) -> list[str]:
    """Give every parameter of ``module`` a leading ``length`` dimension
    (each slice a copy of the parameter), mark it ``stacked``, and return
    the parameter names in order."""
    for sub in module.modules():
        for name, param in list(sub._parameters.items()):
            if param is None:
                continue
            stacked = nn.Parameter(param.detach().unsqueeze(0).repeat(
                length, *([1] * param.dim())))
            stacked.stacked = True
            sub._parameters[name] = stacked
    return [name for name, _ in module.named_parameters()]


def lookup(module: nn.Module, name: str) -> torch.Tensor:
    """The tensor at a dotted parameter path, as the module holds it now
    (inside a ``functional_call``, the caller's tensor)."""
    return functools.reduce(getattr, name.split('.'), module)


def layer_slices(module: nn.Module, names: list[str]) -> list[dict]:
    """``[{name: slice of layer j}]`` for every layer, one ``unbind`` a
    parameter. A stacked piece held split over mesh axes
    (:func:`~tpusystem_torch.parallel.sharding.held_axes`) gives slices
    held split over them one dimension left; a stacked stand-in gives
    stand-ins of its layer slices, each gathered on its own."""
    pieces = []
    for name in names:
        stacked = lookup(module, name)
        if is_deferred(stacked):
            pieces.append(deferred_layers(stacked))
            continue
        held = getattr(stacked, 'held', None) or {}
        if 0 in held:
            raise ValueError(f'{name} is split over {held[0]} at its layer '
                             'dimension, which a layer slice cannot hold')
        layers = stacked.unbind(0)
        for piece in layers if held else ():
            piece.held = {dim - 1: axes for dim, axes in held.items()}
        pieces.append(layers)
    return [dict(zip(names, layer)) for layer in zip(*pieces)]


@torch.no_grad()
def init_stacked(param: torch.Tensor, init) -> None:
    """Run ``init(slice)`` on each layer slice of a stacked parameter (a
    plain parameter is its own one slice)."""
    for piece in (param if getattr(param, 'stacked', False) else (param,)):
        init(piece)


def apply_unit(template: nn.Module, names: list[str], slices: dict,
               hidden, args: tuple, remat: bool):
    """``template(hidden, *args)`` with one unit's parameter slices in place
    of its stacked parameters, stand-ins gathered on entry; with ``remat``
    under one non-reentrant checkpoint (the reference's ``nn.remat`` of the
    block or span), which gathers them again in its recompute."""
    def apply(hidden, *values):
        return torch.func.functional_call(
            template, dict(zip(names, map(gathered, values))),
            (hidden, *args))

    run = (functools.partial(checkpoint, apply, use_reentrant=False)
           if remat else apply)
    return run(hidden, *(slices[name] for name in names))


def as_unit(module: nn.Module, remat: bool = False):
    """``module(*args)`` as one unit: the stand-ins among the tensors the
    module holds when it is called (inside a ``functional_call``, the
    caller's) gathered on entry and dropped on return. With ``remat``,
    under one non-reentrant checkpoint whose recompute reads the
    parameters the forward read: those tensors are the checkpoint's
    explicit inputs, so the backward's recompute, which runs after that
    call has restored the module's own tensors, takes (and gathers) them
    again."""
    names = [name for name, _ in module.named_parameters()]

    def apply(count, *flat):
        return torch.func.functional_call(
            module, dict(zip(names, map(gathered, flat[:count]))),
            flat[count:])

    def run(*args):
        values = [lookup(module, name) for name in names]
        if remat:
            return checkpoint(apply, len(values), *values, *args,
                              use_reentrant=False)
        if not any(map(is_deferred, values)):
            return module(*args)
        return apply(len(values), *values, *args)
    return run


def unit_cache(cache: dict, prefix: str, unit: int, strips: dict) -> dict:
    """One unit's decode cache at ``prefix``: views of the stacked strips
    (written in place by the attention), empty on the prefill; recorded in
    ``strips`` for :func:`restack_caches`."""
    view = {prefix + leaf: cache[prefix + leaf][unit]
            for leaf in CACHE_LEAVES if prefix + leaf in cache}
    strips.setdefault(prefix, []).append(view)
    return view


def restack_caches(cache: dict, strips: dict) -> None:
    """Stack the units' cursors (new tensors each call) and, on the
    prefill, their new strips back into ``cache``."""
    for prefix, views in strips.items():
        for leaf in CACHE_LEAVES:
            key = prefix + leaf
            if leaf == '/index' or key not in cache:
                cache[key] = torch.stack([view[key] for view in views])
