"""Domain events in isolation, on the PyTorch port (the twin of
``examples/verybasic/events.py``).

An aggregate enqueues events during an epoch; ``commit`` dispatches them.
Exceptions without handlers raise at commit — the early-stop mechanism.
"""

from tpusystem_torch.domain import Events


class Overfitting(Exception):
    """Validation loss rose while training loss fell."""


def main() -> None:
    events = Events()

    events.handlers[Overfitting] = lambda: print('handled: reduce lr, continue')
    events.enqueue(Overfitting())
    events.commit()                     # handled -> no raise

    del events.handlers[Overfitting]
    events.enqueue(Overfitting('val loss diverged'))
    try:
        events.commit()                 # unhandled exception raises here
    except Overfitting as stop:
        print(f'training stopped: {stop}')


if __name__ == '__main__':
    main()
