"""The classifier aggregate (the twin of
``examples/tinysys/tinysys/classifier.py``): an aggregate whose identity is
the hash of its network and whose ``fit``/``evaluate`` are the per-step hot
path. The aggregate is an ``nn.Module`` carrying identity, phase and epoch;
the math is the port's step functions advancing a
:class:`~tpusystem_torch.train.TrainState` in place on the mesh's device.
``fit`` returns device values only — metrics accumulate on the device and
the single host read happens once per phase.
"""

from __future__ import annotations

from typing import Any

from tpusystem_torch import Aggregate
from tpusystem_torch.parallel import (batch_sharding, replicated,
                                      stacked_batch_sharding)
from tpusystem_torch.registry import gethash
from tpusystem_torch.train import (build_eval_step, build_multi_eval_step,
                                   build_multi_step, build_train_step,
                                   init_state, module_apply)


def predictions(outputs):
    """Logits reduced to class ids, so stacked metrics stay exact."""
    return outputs.argmax(-1)


class Classifier(Aggregate):
    """Network + criterion + optimizer as one identity-bearing unit."""

    def __init__(self, network, criterion, optimizer):
        super().__init__()
        self.network = network
        self.criterion = criterion
        self.optimizer = optimizer
        self.state = None           # TrainState; created by place()
        self.mesh = None
        self.epoch = 0              # first assignment: no onepoch() fire
        apply_fn = module_apply(network)
        self._train_step = build_train_step(apply_fn, criterion, optimizer)
        self._eval_step = build_eval_step(apply_fn, criterion)
        # N steps per host dispatch: predictions stack reduced to argmax so
        # metrics stay exact
        self._train_many = build_multi_step(self._train_step,
                                            outputs_fn=predictions)
        self._eval_many = build_multi_eval_step(self._eval_step,
                                                outputs_fn=predictions)

    @property
    def id(self) -> str:
        """Registry hash of the network — deterministic across hosts and
        restarts (``examples/tinysys/tinysys/classifier.py:18-20``)."""
        return gethash(self.network)

    def modules(self) -> dict[str, Any]:
        """Registered parts, for the experiment-tracking consumer."""
        return {'nn': self.network, 'criterion': self.criterion,
                'optimizer': self.optimizer}

    def place(self, sample_inputs, mesh) -> None:
        """Initialize the train state on the mesh's device: the network's
        own parameters (moved there in place) and zeroed optimizer slots.
        ``sample_inputs`` is the reference's shape sample; the port's
        modules hold their weights already."""
        self.mesh = mesh
        self.network.to(mesh.device)
        state = init_state(self.network, self.optimizer)
        self.state = replicated(mesh)(state)

    def shard_batch(self, batch: tuple) -> tuple:
        return tuple(batch_sharding(self.mesh)(part) for part in batch)

    def shard_batches(self, stacked: tuple) -> tuple:
        """Place ``[steps, batch, ...]`` stacks on the mesh's device."""
        return tuple(stacked_batch_sharding(self.mesh)(part)
                     for part in stacked)

    def fit(self, inputs, targets):
        """One optimization step; returns (predictions, loss) on device."""
        self.state, (outputs, loss) = self._train_step(self.state, inputs,
                                                       targets)
        return predictions(outputs), loss

    def evaluate(self, inputs, targets):
        """Deterministic forward; returns (predictions, loss) on device."""
        outputs, loss = self._eval_step(self.state, inputs, targets)
        return predictions(outputs), loss

    def fit_many(self, inputs, targets):
        """N optimization steps in one dispatch over [N, batch, ...]
        stacks; returns (predictions [N, batch], losses [N])."""
        self.state, (stacked, losses) = self._train_many(self.state, inputs,
                                                         targets)
        return stacked, losses

    def evaluate_many(self, inputs, targets):
        return self._eval_many(self.state, inputs, targets)

    def onepoch(self) -> None:
        """Commit domain events at every epoch edge — enqueued exceptions
        (early stop) unwind into the epoch loop here."""
        self.events.commit()
