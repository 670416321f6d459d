"""Publisher/Subscriber bus in isolation, on the PyTorch port (the twin of
``examples/verybasic/pubsub.py``).

Messages route by *topic*; a handler exception propagates to the publisher —
the designed early-stop signal path.
"""

from tpusystem_torch.services import Publisher, Subscriber


def main() -> None:
    subscriber = Subscriber()
    publisher = Publisher()
    publisher.register(subscriber)

    @subscriber.subscribe('loss', 'accuracy')
    def chart(value: float) -> None:
        print(f'charting {value}')

    @subscriber.subscribe('loss')
    def watchdog(value: float) -> None:
        if value > 10.0:
            raise StopIteration('loss diverged')

    publisher.publish(0.37, 'loss')
    publisher.publish(0.91, 'accuracy')
    try:
        publisher.publish(99.0, 'loss')
    except StopIteration as stop:
        print(f'stopped: {stop}')


if __name__ == '__main__':
    main()
