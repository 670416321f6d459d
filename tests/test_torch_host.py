"""The port's host layers against the JAX package's, on the CPU.

Each test runs one scenario through both packages and requires equal
observable outcomes: the trace of handler calls and teardowns in order, the
value returned or the exception raised (its type's name and its message),
the kebab names, the bytes of a ``DocumentStore`` file after the same
operations, the registry snapshot of a DLRM, and the event ledger's digest
of the same event stream. These are twins of the reference's
``test_depends``, ``test_events``, ``test_aggregate``, ``test_prodcon``,
``test_pubsub``, ``test_service``, ``test_compiler``, ``test_storage`` and
the one-process parts of ``test_runtime``; the port's own contracts (its
``Aggregate`` is an ``nn.Module``, its ``compile`` is the identity, its
``Runtime`` refuses a second process) close the file.
"""

import dataclasses
import importlib
import signal
import types
import typing

import pytest
import torch
from torch import nn

PACKAGES = ('tpusystem', 'tpusystem_torch')


def _package(root: str) -> types.SimpleNamespace:
    """The host modules of one package, by their common names."""
    names = ('depends', 'compiler', 'config', 'runtime', 'domain',
             'domain.events', 'services', 'services.prodcon',
             'storage', 'storage.documents', 'observe.events',
             'observe.ledger', 'parallel.multihost', 'parallel.recovery',
             'registry')
    return types.SimpleNamespace(root=root, **{
        name.replace('.', '_'): importlib.import_module(f'{root}.{name}')
        for name in names})


def _outcome(scenario, pkg) -> tuple:
    """(trace, result) of ``scenario(pkg, trace)``; an exception counts as
    its type's name and message."""
    trace = []
    try:
        result = ('returned', scenario(pkg, trace))
    except Exception as error:                     # the outcome under test
        result = ('raised', type(error).__name__, str(error))
    return trace, result


def _twin(scenario):
    """Both packages' outcomes, which must be equal; returns the port's."""
    reference, port = (_outcome(scenario, _package(root))
                       for root in PACKAGES)
    assert port == reference
    return port


# --- depends ------------------------------------------------------------

def _plain(pkg, trace):
    @pkg.depends.inject(pkg.depends.Provider())
    def function(value: int = pkg.depends.Depends(lambda: 42)):
        return value
    return function()


def _generator(pkg, trace):
    def dependency():
        trace.append('opened')
        yield 'resource'
        trace.append('closed')

    @pkg.depends.inject(pkg.depends.Provider())
    def function(resource=pkg.depends.Depends(dependency)):
        trace.append(f'call {resource}')
        return resource
    return function()


def _override(pkg, trace):
    provider = pkg.depends.Provider()

    def dependency():
        raise NotImplementedError

    def replacement():
        yield 'late-bound'
        trace.append('closed')

    provider.override(dependency, replacement)

    @pkg.depends.inject(provider)
    def function(value=pkg.depends.Depends(dependency)):
        return value
    return function()


def _explicit(pkg, trace):
    @pkg.depends.inject(pkg.depends.Provider())
    def function(value=pkg.depends.Depends(lambda: 'injected')):
        return value
    return function('explicit'), function()


def _nested(pkg, trace):
    provider = pkg.depends.Provider()

    def config():
        return {'device_count': 8}

    def device(cfg=pkg.depends.Depends(config)):
        return f"device[{cfg['device_count']}]"

    @pkg.depends.inject(provider)
    def function(d=pkg.depends.Depends(device)):
        return d

    first = function()
    provider.override(config, lambda: {'device_count': 2})
    return first, function()


def _memoized(pkg, trace):
    def shared():
        trace.append('shared')
        return object()

    def left(s=pkg.depends.Depends(shared)):
        return s

    def right(s=pkg.depends.Depends(shared)):
        return s

    @pkg.depends.inject(pkg.depends.Provider())
    def function(a=pkg.depends.Depends(left), b=pkg.depends.Depends(right)):
        return a is b
    return function(), function()


def _teardown_order(pkg, trace):
    def outer():
        trace.append('open outer')
        yield 'outer'
        trace.append('close outer')

    def inner(o=pkg.depends.Depends(outer)):
        trace.append('open inner')
        yield f'inner({o})'
        trace.append('close inner')

    @pkg.depends.inject(pkg.depends.Provider())
    def function(value=pkg.depends.Depends(inner)):
        trace.append(f'call {value}')
        raise ValueError('the call failed')
    return function()


@pytest.mark.parametrize('scenario', [
    _plain, _generator, _override, _explicit, _nested, _memoized,
    _teardown_order], ids=lambda f: f.__name__.strip('_'))
def test_depends_twins(scenario):
    _twin(scenario)


def test_depends_generator_tears_down_after_the_call():
    trace, result = _twin(_teardown_order)
    assert trace == ['open outer', 'open inner', 'call inner(outer)',
                     'close inner', 'close outer']
    assert result == ('raised', 'ValueError', 'the call failed')


# --- domain events ------------------------------------------------------

def _event_types(pkg):
    class Occurred(pkg.domain_events.Event):
        def __init__(self, payload):
            self.payload = payload

    class Marker(pkg.domain_events.Event):
        ...
    return Occurred, Marker


def _unhandled_class(pkg, trace):
    events = pkg.domain_events.Events()
    events.enqueue(StopIteration)
    events.commit()


def _unhandled_instance(pkg, trace):
    events = pkg.domain_events.Events()
    events.enqueue(ValueError('epoch regression'))
    events.commit()


def _handled_exception(pkg, trace):
    events = pkg.domain_events.Events()
    events.handlers[StopIteration] = lambda: trace.append('stop handled')
    events.enqueue(StopIteration)
    events.commit()


def _plain_dropped(pkg, trace):
    Occurred, Marker = _event_types(pkg)
    events = pkg.domain_events.Events()
    events.enqueue(Marker)
    events.enqueue(Occurred('x'))
    events.commit()
    return len(events.queue)


def _arity_and_order(pkg, trace):
    Occurred, Marker = _event_types(pkg)
    events = pkg.domain_events.Events()
    events.handlers[Occurred] = lambda event: trace.append(event.payload)
    events.handlers[Marker] = [lambda: trace.append('marker'),
                               lambda: trace.append('marker again')]
    events.enqueue(Occurred(1))
    events.enqueue(Marker)
    events.enqueue(Occurred(2))
    events.commit()
    return events.dequeue()


@pytest.mark.parametrize('scenario', [
    _unhandled_class, _unhandled_instance, _handled_exception,
    _plain_dropped, _arity_and_order], ids=lambda f: f.__name__.strip('_'))
def test_domain_event_twins(scenario):
    _twin(scenario)


# --- aggregate ----------------------------------------------------------

def _model(pkg, trace):
    class Model(pkg.domain.Aggregate):
        def __init__(self):
            super().__init__()
            self.epoch = 0

        @property
        def id(self):
            return 'model-under-test'

        def onphase(self):
            trace.append(('phase', self.phase))

        def onepoch(self):
            trace.append(('epoch', self.epoch))
            self.events.commit()
    return Model()


def _epoch_hook(pkg, trace):
    model = _model(pkg, trace)
    trace.append(('after init', model.epoch))
    model.epoch += 1
    return model.epoch, model.id


def _phase_machine(pkg, trace):
    model = _model(pkg, trace)
    seen = [model.phase]
    model.phase = 'evaluation'
    seen.append(model.phase)
    model.phase = 'train'
    seen.append(model.phase)
    return seen


def _early_stop(pkg, trace):
    model = _model(pkg, trace)
    model.events.enqueue(StopIteration)
    try:
        model.epoch += 1
    finally:
        trace.append(('unwound at', model.epoch))


def _abstract_id(pkg, trace):
    class NoId(pkg.domain.Aggregate):
        ...
    NoId()


@pytest.mark.parametrize('scenario', [
    _epoch_hook, _phase_machine, _early_stop, _abstract_id],
    ids=lambda f: f.__name__.strip('_'))
def test_aggregate_twins(scenario):
    _twin(scenario)


def test_aggregate_early_stop_unwinds_out_of_the_epoch_assignment():
    trace, result = _twin(_early_stop)
    assert trace == [('epoch', 1), ('unwound at', 1)]
    assert result[:2] == ('raised', 'StopIteration')


# --- producer / consumer ------------------------------------------------

@dataclasses.dataclass
class ModelTrained:
    model: object
    metrics: list


@dataclasses.dataclass
class ModelEvaluated:
    model: object
    metrics: list


@dataclasses.dataclass
class Iterated:
    epoch: int


def _union(pkg, trace):
    consumer = pkg.services_prodcon.Consumer()

    @consumer.handler
    def on_either(event: ModelTrained | ModelEvaluated):
        trace.append(type(event).__name__)

    consumer.consume(ModelTrained('m', []))
    consumer.consume(ModelEvaluated('m', []))
    consumer.consume(Iterated(1))                 # no handler: ignored
    return sorted(consumer.handlers)


def _typing_union(pkg, trace):
    consumer = pkg.services_prodcon.Consumer()

    @consumer.handler
    def on_any(event: typing.Union[ModelTrained, Iterated]):
        trace.append(type(event).__name__)

    consumer.consume(Iterated(3))
    consumer.consume(ModelTrained('m', []))
    return sorted(consumer.handlers)


def _stringized(pkg, trace):
    """``from __future__ import annotations`` turns the routing annotation
    into a string, resolved in the handler's module."""
    consumer = pkg.services_prodcon.Consumer()

    def on_either(event, label='x'):
        trace.append((type(event).__name__, label))
    on_either.__annotations__ = {'event': 'ModelTrained | ModelEvaluated',
                                 'label': 'NotResolvable'}
    consumer.handler(on_either)
    consumer.consume(ModelEvaluated('m', []))
    return sorted(consumer.handlers)


def _unannotated(pkg, trace):
    consumer = pkg.services_prodcon.Consumer()

    def bare(event):
        pass
    consumer.handler(bare)


def _injected_handler(pkg, trace):
    consumer = pkg.services_prodcon.Consumer()

    def store():
        raise NotImplementedError

    def session():
        trace.append('open session')
        yield 'session'
        trace.append('close session')

    @consumer.handler
    def persist(event: Iterated, db=pkg.depends.Depends(store),
                tx=pkg.depends.Depends(session)):
        db.append((event.epoch, tx))
        trace.append('persist')

    database = []
    consumer.dependency_overrides[store] = lambda: database
    consumer.consume(Iterated(7))
    return database


def _fan_out(pkg, trace):
    first, second = (pkg.services_prodcon.Consumer(),
                     pkg.services_prodcon.Consumer())

    @first.handler
    def one(event: Iterated):
        trace.append(('first one', event.epoch))

    @first.handler
    def two(event: Iterated):
        trace.append(('first two', event.epoch))

    @second.handler
    def three(event: Iterated):
        trace.append(('second', event.epoch))

    producer = pkg.services_prodcon.Producer()
    producer.taps.append(lambda message: trace.append(('tap', message)))
    producer.register(first, second)
    producer.dispatch(Iterated(1))


def _kebab(pkg, trace):
    consumer = pkg.services_prodcon.Consumer()
    names = [consumer.generator(name) for name in (
        'ModelTrained', 'Trained', 'RecsysEvaluated', 'StepTimed')]
    event = pkg.services_prodcon.event

    @event
    class Probe:
        value: int
    return names, dataclasses.is_dataclass(Probe), dataclasses.asdict(
        Probe(3))


@pytest.mark.parametrize('scenario', [
    _union, _typing_union, _stringized, _unannotated, _injected_handler,
    _fan_out, _kebab], ids=lambda f: f.__name__.strip('_'))
def test_prodcon_twins(scenario):
    _twin(scenario)


def test_prodcon_routes_by_kebab_names():
    _, result = _twin(_union)
    assert result == ('returned', ['model-evaluated', 'model-trained'])
    _, result = _twin(_kebab)
    assert result[1][0] == ['model-trained', 'trained', 'recsys-evaluated',
                            'step-timed']


# --- publisher / subscriber ---------------------------------------------

def _topics(pkg, trace):
    subscriber = pkg.services.Subscriber()

    def metrics():
        raise NotImplementedError

    @subscriber.subscribe('loss', 'accuracy')
    def store(metric, metrics=pkg.depends.Depends(metrics)):
        metrics.append(metric)

    subscriber.dependency_overrides[metrics] = lambda: trace
    publisher = pkg.services.Publisher()
    publisher.register(subscriber)
    publisher.publish(0.1, 'loss')
    publisher.publish(0.9, 'accuracy')
    publisher.publish('ignored', 'other-topic')


def _early_stop_topic(pkg, trace):
    subscriber = pkg.services.Subscriber()

    @subscriber.subscribe('accuracy')
    def early_stop(metric):
        trace.append(metric)
        if metric > 0.99:
            raise StopIteration('target accuracy')

    publisher = pkg.services.Publisher()
    publisher.register(subscriber)
    publisher.publish(0.5, 'accuracy')
    publisher.publish(1.0, 'accuracy')


def _reentrant(pkg, trace):
    subscriber = pkg.services.Subscriber()

    @subscriber.subscribe('raw')
    def reroute(message):
        trace.append(('raw', message))
        subscriber.receive(message * 2, 'derived')

    @subscriber.subscribe('derived')
    def collect(message):
        trace.append(('derived', message))

    subscriber.receive(21, 'raw')


@pytest.mark.parametrize('scenario', [_topics, _early_stop_topic, _reentrant],
                         ids=lambda f: f.__name__.strip('_'))
def test_pubsub_twins(scenario):
    _twin(scenario)


# --- service ------------------------------------------------------------

def _service_override(pkg, trace):
    service = pkg.services.Service()

    def device():
        raise NotImplementedError

    @service.handler
    def train_model(model, device=pkg.depends.Depends(device)):
        trace.append((model, device))
        return device

    service.dependency_overrides[device] = lambda: 'cuda:0'
    return sorted(service.handlers), service.handle('train-model', 'm')


def _service_direct(pkg, trace):
    service = pkg.services.Service()

    @service.handler
    def validate(model):
        return ('validated', model)
    return validate('m'), service.handle('validate', 'm')


def _service_unknown(pkg, trace):
    pkg.services.Service().handle('missing-action')


def _service_generator(pkg, trace):
    service = pkg.services.Service(generator=str.upper)

    @service.handler
    def iterate():
        return 'ok'
    return service.handle('ITERATE')


@pytest.mark.parametrize('scenario', [
    _service_override, _service_direct, _service_unknown, _service_generator],
    ids=lambda f: f.__name__.strip('_'))
def test_service_twins(scenario):
    _twin(scenario)


def test_unknown_service_action_raises_key_error():
    _, result = _twin(_service_unknown)
    assert result[:2] == ('raised', 'KeyError')
    assert 'missing-action' in result[2]


# --- compiler -----------------------------------------------------------

def _pipeline(pkg, trace):
    compiler = pkg.compiler.Compiler()

    def epochs():
        raise NotImplementedError

    @compiler.step
    def build(a, b):
        trace.append('build')
        return a + b

    @compiler.step
    def annotate(total, epochs=pkg.depends.Depends(epochs)):
        trace.append('annotate')
        return (total, epochs)

    @compiler.step
    def finish(total, epochs):
        trace.append('finish')
        return {'total': total, 'epochs': epochs}

    compiler.dependency_overrides[epochs] = lambda: 10
    return compiler.compile(2, 3)


def _side_effects(pkg, trace):
    compiler = pkg.compiler.Compiler()

    @compiler.step
    def log_arguments(x, scale=1):
        trace.append(('arguments', x, scale))     # None: pass them on

    @compiler.step
    def produce(x, scale=1):
        return x * 2 * scale

    @compiler.step
    def log(value):
        trace.append(('value', value))

    @compiler.step
    def falsy(value):
        return 0                                  # not None: carried on

    @compiler.step
    def consume(value):
        return value + 1

    return compiler.compile(10, scale=3)


def _empty(pkg, trace):
    return pkg.compiler.Compiler().compile(1, 2)


@pytest.mark.parametrize('scenario', [_pipeline, _side_effects, _empty],
                         ids=lambda f: f.__name__.strip('_'))
def test_compiler_twins(scenario):
    _twin(scenario)


def test_compiler_passes_none_through_and_keeps_falsy_results():
    trace, result = _twin(_side_effects)
    assert trace == [('arguments', 10, 3), ('value', 60)]
    assert result == ('returned', 1)


# --- storage ------------------------------------------------------------

def _storage_operations(pkg, path):
    """The reference's DAO scenarios (``tests/test_storage.py``) in one
    store: every adapter's CRUD and both upserts. Returns what the reads
    gave back."""
    storage = pkg.storage
    store = storage.DocumentStore(path)
    where = pkg.storage_documents.where
    reads = []
    table = store.table('things')
    reads.append(table.insert({'name': 'a', 'value': 1}))
    table.insert_many([{'name': 'b', 'value': 2}, {'name': 'c', 'value': 3}])
    table.update({'value': 10}, where(name='a'))
    reads.append(table.update_last({'value': 11}, where(value=10)))
    table.remove(where(name='b'))
    reads.append((len(table), table.all()))
    experiments = storage.DocumentExperiments(store)
    reads.append(experiments.create(storage.Experiment(name='mnist')))
    reads.append(experiments.create(storage.Experiment(name='mnist')))
    experiments.create(storage.Experiment(name='gone'))
    experiments.remove('gone')
    models = storage.DocumentModels(store)
    models.create(storage.Model(hash='abc', experiment='mnist'))
    models.create(storage.Model(hash='abc', experiment='mnist'))
    models.update(storage.Model(hash='abc', experiment='mnist', epoch=5))
    models.update(storage.Model(hash='abc', experiment='other', epoch=1))
    models.delete('abc', 'other')
    modules = storage.DocumentModules(store)
    for kind, digest, name, epoch in (('nn', 'h1', 'MLP', 0),
                                      ('nn', 'h1', 'MLP', 3),
                                      ('nn', 'h2', 'MLP', 4),
                                      ('nn', 'h1', 'MLP', 5),
                                      ('optimizer', 'h1', 'Adam', 4)):
        modules.put(storage.Module(model='m', kind=kind, hash=digest,
                                   name=name, arguments={'lr': 0.1},
                                   epoch=epoch))
    iterations = storage.DocumentIterations(store)
    for phase, digest, epoch in (('train', 'l1', 0), ('train', 'l1', 2),
                                 ('evaluation', 'l1', 2),
                                 ('train', 'l2', 3)):
        iterations.put(storage.Iteration(model='m', phase=phase, hash=digest,
                                         name='Loader', epoch=epoch))
    metrics = storage.DocumentMetrics(store)
    for epoch in range(3):
        metrics.add(storage.Metric(model='m', name='loss',
                                   value=1.0 / (epoch + 1), epoch=epoch,
                                   phase='train'))
    metrics.add(storage.Metric(model='other', name='loss', value=9.9,
                               epoch=0, phase='train'))
    metrics.clear('other')
    store.close()
    reopened = storage.DocumentStore(path)
    reads.append(reopened.table('things').insert({'name': 'd'}))
    for records in (storage.DocumentExperiments(reopened).list(),
                    storage.DocumentModels(reopened).list('mnist'),
                    storage.DocumentModules(reopened).list('m'),
                    storage.DocumentIterations(reopened).list('m'),
                    storage.DocumentMetrics(reopened).list('m')):
        reads.append([(type(record).__name__, dataclasses.asdict(record))
                      for record in records])
    reads.append(storage.unstructure(storage.structure(
        {'hash': 'x', 'experiment': 'e', 'unknown': 1}, storage.Model)))
    return reads


def test_document_store_files_are_byte_identical(tmp_path):
    reads, files = [], []
    for root in PACKAGES:
        path = tmp_path / root / 'db.json'
        reads.append(_storage_operations(_package(root), path))
        files.append(path.read_bytes())
    assert reads[1] == reads[0]
    assert files[1] == files[0]
    modules = reads[1][-4]
    assert [row[1]['epoch'] for row in modules] == [3, 4, 5, 4]


# --- config -------------------------------------------------------------

def test_config_snapshot_of_a_dlrm_equals_the_reference():
    from tpusystem.models import DLRM as JaxDLRM
    from tpusystem_torch.models import DLRM
    reference, port = _package('tpusystem'), _package('tpusystem_torch')
    arguments = dict(vocabs=(1460, 583, 10), dim=16, dense_features=13,
                     bottom=(64, 32), top=(64, 32))
    want = reference.config.snapshot(JaxDLRM(**arguments))
    got = port.config.snapshot(DLRM(**arguments, device='cpu'))
    assert got == want
    assert got['name'] == 'DLRM' and 'device' not in got['arguments']


def _config_roundtrip(pkg, trace, directory):
    registry = pkg.registry.Registry()

    @registry.register
    class Tokenizer:
        def __init__(self, vocab: int = 256):
            self.vocab = vocab

    @registry.register
    class Normalizer:
        def __init__(self):
            pass

    @registry.register
    class Model:
        def __init__(self, dim: int, tokenizer=None, normalizer=None,
                     tags=None):
            self.dim, self.tokenizer = dim, tokenizer
            self.normalizer, self.tags = normalizer, tags

    path = directory / f'{pkg.root}.toml'
    path.write_text('name = "Model"\n[arguments]\ndim = 4\n'
                    'normalizer = "Normalizer"\ntags = ["a", "Tokenizer"]\n'
                    '[arguments.tokenizer]\nname = "Tokenizer"\n'
                    '[arguments.tokenizer.arguments]\nvocab = 512\n')
    model = pkg.config.build(pkg.config.load(path), registry)
    spec = pkg.config.snapshot(model)
    rebuilt = pkg.config.build(spec, registry)
    trace.append(spec)
    trace.append(type(model.normalizer).__name__)
    trace.append([getattr(tag, 'vocab', tag) for tag in model.tags])
    trace.append(pkg.registry.gethash(rebuilt) == pkg.registry.gethash(model))
    pkg.config.build({'name': 'Mystery', 'arguments': {}}, registry)


def test_config_build_and_snapshot_twins(tmp_path):
    trace, result = _twin(lambda pkg, trace: _config_roundtrip(pkg, trace,
                                                               tmp_path))
    assert trace[-1] is True
    assert result[:2] == ('raised', 'KeyError')


# --- the event ledger ---------------------------------------------------

def _event_stream(pkg):
    events, multihost = pkg.observe_events, pkg.parallel_multihost
    model = object()
    return [events.Trained(model, {'loss': 0.5}),
            events.StepTimed(model, 'train', 12, 3.25),
            events.RecsysEvaluated(model, {'auc': 0.75, 'loss': 0.5}),
            events.AnomalyDetected('m', 7, 'spike', 1.5, 2.5, 4.0),
            multihost.WorkerLost(rank=2, last_seen=12.5),
            multihost.WorkerJoined(rank=3),
            events.Validated(model, {'accuracy': 0.25}), 'not-a-dataclass']


def _ledger(pkg, trace, strict):
    producer = pkg.services_prodcon.Producer()
    ledger = pkg.observe_ledger.EventLedger(strict=strict).tap(producer)
    for message in _event_stream(pkg):
        producer.dispatch(message)
        trace.append(ledger.digest)

    class Peers:
        rank = 1

        def gather(self, value):
            return [value, (0, ledger.count - 1, ledger.digest)]
    try:
        ledger.verify(Peers())
    finally:
        trace.append(ledger.verify(pkg.parallel_multihost.Loopback()))
        trace.append(ledger.count)


@pytest.mark.parametrize('strict', [False, True])
def test_ledger_digests_of_one_event_stream_are_equal(strict):
    trace, result = _twin(lambda pkg, trace: _ledger(pkg, trace, strict))
    assert trace[-1] == 8 and len(set(trace[:8])) == 8
    assert result[:2] == ('raised', 'LedgerDivergence')


# --- the one-process runtime, its buses and recovery --------------------

@pytest.fixture()
def _no_job(monkeypatch):
    for name in ('TPUSYSTEM_COORDINATOR', 'TPUSYSTEM_CONTROL'):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize('environ,arguments', [
    ({'TPUSYSTEM_CONTROL': '10.0.0.5:9000'}, ('other:1234', None)),
    ({}, ('head:8476', None)), ({}, ('head:8476', 7000)),
    ({}, ('head', 7000)), ({}, (None, None)), ({}, ('head-no-port', None)),
    ({'TPUSYSTEM_CONTROL': 'no-port'}, ('head:1', None))])
def test_control_address_twins(_no_job, environ, arguments):
    for name, value in environ.items():
        _no_job.setenv(name, value)
    _twin(lambda pkg, trace: pkg.runtime._control_address(*arguments))


class _Model:
    id = 'model-id'
    epoch = 0


def _runtime_housekeeping(pkg, trace):
    events, multihost = pkg.observe_events, pkg.parallel_multihost
    with pkg.runtime.Runtime(ledger=True) as runtime:
        trace.append((runtime.world.process_index,
                      runtime.world.process_count, runtime.is_primary,
                      type(runtime.transport).__name__))
        consumer = pkg.services_prodcon.Consumer()

        @consumer.handler
        def seen(event: events.Trained | multihost.WorkerJoined):
            trace.append(type(event).__name__)
        runtime.producer.register(consumer, primary_only=True)
        runtime.producer.wire(events.Trained)
        runtime.producer.dispatch(events.Trained(_Model(), {'loss': 0.1}))
        runtime.producer.transport.on_control(('joined', 4))
        trace.append('before sync')
        runtime.sync()
        trace.append((runtime.ledger.count, runtime.ledger.digest))
        trace.append([runtime.should_stop(flag) for flag in (False, True)])
        runtime.barrier()
        stopped_at = None
        for epoch in range(10):
            runtime.sync()
            if runtime.should_stop(epoch >= 3):
                stopped_at = epoch
                break
        return stopped_at


def _runtime_worker_loss(pkg, trace):
    recovery = pkg.parallel_recovery
    runtime = pkg.runtime.Runtime()
    try:
        runtime.producer.register(recovery.recovery_consumer())
        runtime.producer.transport.on_control(('lost', 2, 12.5, 'heartbeat'))
        runtime.sync()
    finally:
        runtime.close()


def _runtime_preempted(pkg, trace):
    with pkg.runtime.Runtime(preemption=True) as runtime:
        trace.append(runtime.preempted)
        signal.raise_signal(signal.SIGTERM)
        trace.append(runtime.preempted)
        runtime.sync()


def _publisher_buses(pkg, trace):
    multihost = pkg.parallel_multihost
    transport = multihost.Loopback()
    publisher = multihost.DistributedPublisher(transport)
    subscriber = pkg.services.Subscriber()
    subscriber.register('loss', lambda value: trace.append(('loss', value)))
    publisher.register(subscriber, primary_only=True)
    publisher.wire('loss')
    publisher.publish(0.5, 'loss')
    publisher._inbox.put(('loss', 0.25))
    delivered = publisher.drain()
    blobs = []
    transport.on_blob = lambda peer, key, data: blobs.append((peer, key, data))
    transport.send_blob(0, 'state', bytearray(b'abc'))
    trace.append(blobs)
    trace.append([multihost.agree(transport, flag, op)
                  for flag in (False, True) for op in ('or', 'and')])
    trace.append([transport.allreduce(3, op) for op in ('sum', 'min', 'max')])
    trace.append(transport.gather('x'))
    try:
        transport.fetch_blob(1, 'missing')
    finally:
        trace.append(delivered)


def _exit_codes(pkg, trace):
    recovery = pkg.parallel_recovery

    class Fenced(RuntimeError):
        exit_code = 47
    reasons = [recovery.WorkerLostError(3, 1.5, 'heartbeat'),
               recovery.Preempted(signal.SIGTERM),
               recovery.WorldResizedError(2, (0, 2, 1)),
               recovery.DivergenceError('diverged', step=9), Fenced(),
               ValueError('a bug')]
    for reason in reasons:
        trace.append((str(reason), recovery.exit_for_restart(reason).code))
    return (sorted(recovery.RESTART_EXITS), recovery.CRASH_LOOP_EXIT,
            recovery.ROUTER_FENCED_EXIT, recovery.FAILURE_EXIT)


def _recovery_policy(pkg, trace):
    recovery, multihost = pkg.parallel_recovery, pkg.parallel_multihost
    observe = recovery.recovery_consumer('observe')
    observe.consume(multihost.WorkerLost(rank=1, last_seen=2.0))
    observe.consume(multihost.WorkerJoined(rank=1))
    trace.append(sorted(observe.handlers))
    recovery.recovery_consumer('ignore')


@pytest.mark.parametrize('scenario', [
    _runtime_housekeeping, _runtime_worker_loss, _runtime_preempted,
    _publisher_buses, _exit_codes, _recovery_policy],
    ids=lambda f: f.__name__.strip('_'))
def test_runtime_twins(_no_job, scenario):
    _twin(scenario)


def test_runtime_housekeeping_delivers_in_order_and_stops_together(_no_job):
    trace, result = _twin(_runtime_housekeeping)
    assert trace[0] == (0, 1, True, 'Loopback')
    assert trace[1:4] == ['Trained', 'before sync', 'WorkerJoined']
    assert trace[4][0] == 2 and trace[5] == [False, True]
    assert result == ('returned', 3)
    trace, result = _twin(_runtime_worker_loss)
    assert result[:2] == ('raised', 'WorkerLostError')
    trace, result = _twin(_runtime_preempted)
    assert trace == [False, True] and result[:2] == ('raised', 'Preempted')


# --- the port's own contracts -------------------------------------------

def test_the_package_exports_the_reference_surface():
    import tpusystem
    import tpusystem_torch
    assert set(tpusystem.__all__) <= set(tpusystem_torch.__all__)
    for name in tpusystem.__all__:
        assert getattr(tpusystem_torch, name).__name__ == name


def test_the_aggregate_is_a_module_whose_phase_moves_its_children():
    from tpusystem_torch import Aggregate

    class Classifier(Aggregate):
        def __init__(self):
            super().__init__()
            self.network = nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.5))
            self.epoch = 0

        @property
        def id(self):
            return 'classifier'

    model = Classifier()
    dropout = model.network[1]
    assert isinstance(model, nn.Module) and model.training
    assert dict(model.named_children()) == {'network': model.network}
    assert [name for name, _ in model.named_parameters()] == [
        'network.0.weight', 'network.0.bias']
    model.phase = 'evaluation'
    assert not dropout.training and model.phase == 'evaluation'
    inputs = torch.ones(2, 4)
    assert torch.equal(model.network(inputs), model.network(inputs))
    model.phase = 'train'
    assert dropout.training and model.phase == 'train'
    model.eval()
    assert model.phase == 'evaluation' and not dropout.training


def test_compile_is_the_identity():
    from tpusystem_torch.compiler import compile

    def step(x):
        return x + 1
    assert compile(step) is step


@pytest.mark.parametrize('how', ['argument', 'environment', 'processes'])
def test_the_runtime_refuses_a_second_process(_no_job, how):
    """A job of more than one process joins the TCP control plane
    (``tests/test_torch_multihost.py`` drives it); one named only by a
    coordinator or a process count, without this process's rank, is
    refused before anything is dialed, and the world stays one process."""
    from tpusystem_torch import Runtime
    from tpusystem_torch.parallel import world
    for name in ('TPUSYSTEM_PROCESS_ID', 'TPUSYSTEM_NUM_PROCESSES'):
        _no_job.delenv(name, raising=False)
    if how == 'environment':
        _no_job.setenv('TPUSYSTEM_COORDINATOR', 'head:8476')
    arguments = {'argument': dict(coordinator='head:8476'),
                 'environment': {}, 'processes': dict(num_processes=2)}[how]
    with pytest.raises(ValueError, match='process_id'):
        Runtime(**arguments)
    _no_job.delenv('TPUSYSTEM_COORDINATOR', raising=False)
    assert world().process_count == 1
    assert Runtime(num_processes=1).world.process_count == 1
