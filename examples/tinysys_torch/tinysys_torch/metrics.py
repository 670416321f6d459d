"""Classification metric bundle (the twin of
``examples/tinysys/tinysys/metrics.py``). Accumulation stays on the device
per batch; the one device-to-host read per phase happens in
:meth:`ClassifierMetrics.compute`.
"""

from __future__ import annotations

from tpusystem_torch.train import Accuracy, Mean


class ClassifierMetrics:
    def __init__(self) -> None:
        self.loss = Mean()
        self.accuracy = Accuracy()

    def update(self, loss, predictions, targets) -> None:
        self.loss.update(loss)
        self.accuracy.update(predictions, targets)

    def compute(self) -> dict[str, float]:
        return {'loss': self.loss.compute(),
                'accuracy': self.accuracy.compute()}

    def reset(self) -> None:
        self.loss.reset()
        self.accuracy.reset()
