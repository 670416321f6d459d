"""Producer/Consumer bus in isolation, on the PyTorch port (the twin of
``examples/verybasic/prodcon.py``).

Events route by *type*; a handler annotated with a union consumes every
member; dependencies inject per call.
"""

from tpusystem_torch.services import Consumer, Depends, Producer, event


@event
class ModelTrained:
    accuracy: float


@event
class ModelEvaluated:
    accuracy: float


def database() -> list:
    raise NotImplementedError('overridden at the composition root')


consumer = Consumer()
producer = Producer()
producer.register(consumer)


@consumer.handler
def on_metrics(message: ModelTrained | ModelEvaluated,
               db: list = Depends(database)) -> None:
    phase = 'train' if isinstance(message, ModelTrained) else 'eval'
    db.append((phase, message.accuracy))
    print(f'{phase}: accuracy={message.accuracy}')


def main() -> None:
    rows: list = []
    consumer.dependency_overrides[database] = lambda: rows
    producer.dispatch(ModelTrained(accuracy=0.91))
    producer.dispatch(ModelEvaluated(accuracy=0.88))
    print('stored rows:', rows)


if __name__ == '__main__':
    main()
