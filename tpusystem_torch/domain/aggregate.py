"""Aggregate root for training systems: the port of
:mod:`tpusystem.domain.aggregate`.

A DDD *aggregate* is the unit of consistency a training service operates on:
the neural network plus everything needed to train/evaluate it (criterion,
optimizer, its state, data cursors, ...). In PyTorch idiom, as in the
upstream TorchSystem (``torchsystem/domain/aggregate.py:26``), the aggregate
*is* a ``torch.nn.Module``: a network assigned to it registers as a child
module, so ``phase`` moves every child between training and evaluation mode
(dropout on or off) through ``nn.Module.train()`` / ``eval()``. The port's
train step (:func:`tpusystem_torch.train.build_train_step`) advances the
parameters and optimizer slots in place, so a subclass keeps its
:class:`~tpusystem_torch.train.TrainState` as a plain attribute.

Behavioral parity contracts (``torchsystem/domain/aggregate.py:102-158``):
``id`` is abstract; ``phase`` maps the training flag to
``'train' | 'evaluation'``; setting ``phase`` flips the flag then calls
``onphase()``; assigning ``epoch`` calls ``onepoch()`` only when the
attribute already existed (so ``__init__`` assignment does not fire it).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Literal

from torch import nn

from tpusystem_torch.domain.events import Events

Phase = Literal['train', 'evaluation'] | str


class Aggregate(nn.Module, ABC):
    """Aggregate root with phase/epoch hooks and domain events.

    ``nn.Module.__init__`` runs first in ``__init__``: every attribute
    assignment goes through ``nn.Module.__setattr__``, which needs it."""

    def __init__(self) -> None:
        super().__init__()
        self.events = Events()

    @property
    @abstractmethod
    def id(self) -> Any:
        """Unique identity of the aggregate root within its boundary.

        Use :func:`tpusystem_torch.registry.gethash` over the registered
        network definition for a deterministic, restart-stable id that keys
        experiment rows and checkpoint directories.
        """

    @property
    def phase(self) -> Phase:
        """``'train'`` while in training mode, ``'evaluation'`` otherwise:
        ``nn.Module.training``, which the children share."""
        return 'train' if self.training else 'evaluation'

    @phase.setter
    def phase(self, value: Phase) -> None:
        self.train() if value == 'train' else self.eval()
        self.onphase()

    def onphase(self) -> None:
        """Hook fired after every phase change. Override for custom behavior."""

    def onepoch(self) -> None:
        """Hook fired after every epoch assignment (post-``__init__``).

        Typical use: ``self.events.commit()`` so exceptions enqueued during
        the epoch (early stopping) unwind into the epoch loop here.
        """

    def __setattr__(self, name: str, value: Any) -> None:
        if name == 'epoch' and hasattr(self, 'epoch'):
            super().__setattr__(name, value)
            self.onepoch()
        else:
            super().__setattr__(name, value)
