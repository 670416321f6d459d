"""Weight repository keyed by aggregate identity: the port of
:mod:`tpusystem.checkpoint.repository`.

The repository stores and restores an aggregate's learned state, addressed
by ``aggregate.id`` alone — same hyperparameters, same identity, same
checkpoint, across process restarts. The payload is the aggregate's
``state`` (a :class:`tpusystem_torch.train.TrainState` or any state the
:class:`Checkpointer` takes, such as a module's ``state_dict()``), saved
async through the :class:`Checkpointer` and restored into the aggregate's
own tensors in place.
"""

from __future__ import annotations

import pathlib
from typing import Any, Protocol, runtime_checkable

from tpusystem_torch.checkpoint.checkpointer import Checkpointer


@runtime_checkable
class Stateful(Protocol):
    """Anything with an identity and a state attribute."""
    id: Any
    state: Any


class Repository:
    """Store/restore aggregates by identity hash.

    ``epoch`` defaults to the aggregate's own ``epoch`` attribute when it has
    one, else to the next free version.
    """

    def __init__(self, root: str | pathlib.Path = 'data/weights', *,
                 max_to_keep: int | None = 3, async_save: bool = True) -> None:
        self.checkpointer = Checkpointer(root, max_to_keep=max_to_keep,
                                         async_save=async_save)

    def store(self, aggregate: Any, epoch: int | None = None, *,
              extras: Any | None = None) -> None:
        """Persist ``aggregate.state`` under its identity; ``extras`` is
        optional JSON-able host metadata stored alongside."""
        if epoch is None:
            epoch = getattr(aggregate, 'epoch', None)
        if epoch is None:
            # newest(), not latest(): an async save still in flight owns
            # its step number even though nothing committed yet
            newest = self.checkpointer.newest(str(aggregate.id))
            epoch = 0 if newest is None else newest + 1
        self.checkpointer.save(str(aggregate.id), epoch, aggregate.state,
                               extras=extras)

    def restore(self, aggregate: Any, epoch: int | None = None) -> None:
        """Load the stored state back into ``aggregate.state`` in place."""
        aggregate.state = self.checkpointer.restore(
            str(aggregate.id), aggregate.state, epoch)

    def latest(self, aggregate: Any) -> int | None:
        """Latest stored epoch for this aggregate, or ``None`` if fresh."""
        return self.checkpointer.latest(str(aggregate.id))

    def resume(self, aggregate: Any) -> tuple[int, Any | None]:
        """Restore the newest committed checkpoint into ``aggregate.state``
        and return ``(step, extras)``."""
        state, step, extras = self.checkpointer.resume(
            str(aggregate.id), aggregate.state)
        aggregate.state = state
        return step, extras

    def fence(self, aggregate: Any) -> int | None:
        """Block until pending saves commit, then advance the monotonic
        commit fence for this aggregate (see :meth:`Checkpointer.fence`)."""
        return self.checkpointer.fence(str(aggregate.id))

    def wait(self) -> None:
        self.checkpointer.wait()

    def close(self) -> None:
        self.checkpointer.close()
