"""Minimal end-to-end training on the PyTorch port (the twin of
``examples/verybasic/train.py``).

One MLP, one train step, one loader; the loss falls. The smallest
tpusystem_torch program: it trains on the card, or on the CPU with
``main(device='cpu')``.
"""

from tpusystem_torch.data import Loader, SyntheticDigits
from tpusystem_torch.models import MLP
from tpusystem_torch.train import (Adam, CrossEntropyLoss, Mean,
                                   build_train_step, init_state,
                                   module_apply)


def main(device=None) -> list:
    """Train three epochs and return each epoch's mean loss."""
    module = MLP(features=(128,), classes=10, device=device)
    optimizer = Adam(lr=1e-3)
    step = build_train_step(module_apply(module), CrossEntropyLoss(),
                            optimizer)
    state = init_state(module, optimizer)

    loader = Loader(SyntheticDigits(samples=2048), batch_size=64,
                    shuffle=True, device=device)
    losses = []
    for epoch in range(3):
        loss = Mean()
        for inputs, targets in loader:
            state, (_, batch_loss) = step(state, inputs, targets)
            loss.update(batch_loss)
        losses.append(loss.compute())
        print(f'epoch {epoch}: loss={losses[-1]:.4f}')
    return losses


if __name__ == '__main__':
    main()
