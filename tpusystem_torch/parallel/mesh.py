"""Device meshes in one-device form: the port of
:mod:`tpusystem.parallel.mesh`.

The reference's injected runtime fact is a :class:`jax.sharding.Mesh`
over the chip topology, with every parallelism expressed as a named axis.
The port runs one process on one card, so a :class:`Mesh` here is a handle
on one :class:`torch.device` carrying the reference's six axis names, each
of size 1, and a placement (:func:`batch_sharding`, :func:`replicated`,
...) is "move to that device". :class:`MeshSpec` keeps the reference's
arithmetic (``resolved_sizes``, ``resized``) and its identity; a spec that
resolves to more than one device raises ``NotImplementedError`` (ROADMAP
queue 1, 9. Multi-GPU parallelism).

======== ========================================================
``data``   pure data parallelism (gradient all-reduce)
``fsdp``   fully-sharded data parallelism (params/opt-state scatter)
``model``  tensor parallelism (weight-matrix column/row split)
``seq``    sequence/context parallelism (ring attention)
``expert`` expert parallelism (MoE all-to-all dispatch)
``stage``  pipeline parallelism (collective-permute between stages)
======== ========================================================
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from tpusystem_torch.device import resolve_device
from tpusystem_torch.registry import register

DATA, FSDP, MODEL, SEQ, EXPERT, STAGE = ('data', 'fsdp', 'model', 'seq',
                                         'expert', 'stage')
AXES = (DATA, FSDP, MODEL, SEQ, EXPERT, STAGE)

__all__ = ['AXES', 'DATA', 'FSDP', 'MODEL', 'SEQ', 'EXPERT', 'STAGE', 'Mesh',
           'MeshSpec', 'Placement', 'single_device_mesh', 'batch_sharding',
           'stacked_batch_sharding', 'replicated']


def _multi_device(count: int) -> NotImplementedError:
    return NotImplementedError(
        f'a mesh over {count} devices is not ported to tpusystem_torch yet '
        f'(ROADMAP queue 1: 9. Multi-GPU parallelism); the port runs one '
        f'process on one device')


class Mesh:
    """One device under the reference's axis names (every axis of size 1):
    ``shape`` maps each axis to its size, as a jax mesh's does."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.axis_names = AXES
        self.shape = {axis: 1 for axis in AXES}

    def __repr__(self) -> str:
        return f'Mesh({self.device})'


class Placement:
    """Where a tree of tensors goes on a :class:`Mesh`: its device (the
    one-device form of a ``NamedSharding``). Calling it moves every tensor
    of a tree of dicts, tuples and lists there, and numpy arrays become
    tensors there; a tensor already on the device is returned as it is. A
    :class:`~tpusystem_torch.train.TrainState` is moved in place and
    returned, so parameters already there stay the module's own."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.device = mesh.device

    def __call__(self, tree: Any) -> Any:
        if hasattr(tree, 'params') and hasattr(tree, 'opt_state'):
            tree.params = self(tree.params)
            tree.opt_state = self(tree.opt_state)
            tree.step = self(tree.step)
            if tree.health is not None:
                for name, value in tree.health.tensors().items():
                    setattr(tree.health, name, self(value))
            return tree
        if isinstance(tree, torch.Tensor):
            return tree.to(self.device)
        if isinstance(tree, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(tree)).to(
                self.device)
        if isinstance(tree, dict):
            return {key: self(value) for key, value in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self(value) for value in tree)
        return tree


@register
class MeshSpec:
    """Declarative mesh layout: axis name -> size.

    Size ``-1`` on exactly one axis means "fill with all remaining devices".
    Axes of size 1 are kept (they cost nothing and keep the layout uniform
    across configurations).

    Example::

        MeshSpec(data=-1).build()                      # the card
        MeshSpec().build([torch.device('cpu')])        # the CPU
    """

    def __init__(self, data: int = 1, fsdp: int = 1, model: int = 1,
                 seq: int = 1, expert: int = 1, stage: int = 1):
        self.sizes = {DATA: data, FSDP: fsdp, MODEL: model,
                      SEQ: seq, EXPERT: expert, STAGE: stage}

    def resolved_sizes(self, device_count: int) -> dict[str, int]:
        sizes = dict(self.sizes)
        wildcards = [axis for axis, size in sizes.items() if size == -1]
        if len(wildcards) > 1:
            raise ValueError(f'only one axis may be -1, got {wildcards}')
        fixed = math.prod(size for size in sizes.values() if size != -1)
        if wildcards:
            if device_count % fixed:
                raise ValueError(
                    f'{device_count} devices not divisible by fixed axes {fixed}')
            sizes[wildcards[0]] = device_count // fixed
        elif fixed != device_count:
            raise ValueError(
                f'mesh wants {fixed} devices but {device_count} are available')
        return sizes

    def build(self, devices: Sequence[torch.device] | None = None) -> Mesh:
        """The mesh over ``devices`` (default: this process's card,
        :func:`~tpusystem_torch.device.resolve_device`, which raises where
        there is none). More than one device raises
        ``NotImplementedError``."""
        devices = list(devices) if devices is not None else [
            resolve_device()]
        fixed = math.prod(size for size in self.sizes.values() if size != -1)
        if len(devices) > 1 or fixed > 1:
            raise _multi_device(max(len(devices), fixed))
        self.resolved_sizes(len(devices))
        return Mesh(devices[0])

    def resized(self, device_count: int) -> 'MeshSpec':
        """The same layout policy scaled to a new device count (the mesh
        derivation of an elastic resize): a wildcard spec re-fills; a
        pinned one scales ``data``, else ``fsdp``. Raises ``ValueError``
        when neither divides the new count."""
        sizes = dict(self.sizes)
        if any(size == -1 for size in sizes.values()):
            spec = MeshSpec(**sizes)
            spec.resolved_sizes(device_count)     # validate divisibility now
            return spec
        for axis in (DATA, FSDP):
            fixed = math.prod(size for name, size in sizes.items()
                              if name != axis)
            if device_count % fixed == 0:
                return MeshSpec(**{**sizes, axis: device_count // fixed})
        raise ValueError(
            f'cannot rescale mesh {sizes} to {device_count} devices: '
            f'neither the data nor the fsdp axis divides the new count')


def single_device_mesh(device: torch.device | str | None = None) -> Mesh:
    """A 1x1x1x1x1x1 mesh over one device (default: the card)."""
    return MeshSpec().build([resolve_device(device)])


def batch_sharding(mesh: Mesh) -> Placement:
    """Where a global batch goes: the mesh's device (the reference splits
    the batch dimension over ``(data, fsdp)``, both of size 1 here)."""
    return Placement(mesh)


def stacked_batch_sharding(mesh: Mesh) -> Placement:
    """Where a ``[steps, batch, ...]`` stack (the
    :func:`tpusystem_torch.train.build_multi_step` input) goes: the mesh's
    device."""
    return Placement(mesh)


def replicated(mesh: Mesh) -> Placement:
    """Where a replicated tree goes: the mesh's device."""
    return Placement(mesh)
