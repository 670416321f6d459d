"""The port's observability consumers, profiler and token datasets.

First the twins of ``tests/test_observe.py`` (each named as its reference
test): forge events directly, point DI overrides at test fixtures, assert
the stored state — the framework itself is never mocked. The two profiler
twins replace the port's :func:`~tpusystem_torch.observe.profile.start_trace`
and ``stop_trace`` as the reference's replace ``jax.profiler``'s. Then the
port against the reference: ``observe.__all__``, ``SummaryWriter`` event
files byte for byte with the clock pinned, ``MemmapTokens`` windows and
``TorchDataset`` arrays bitwise; and the real ``torch.profiler`` on the
CPU under ``trace``/``step_span`` and ``StepTimer``.
"""

import dataclasses
import logging
import pathlib

import numpy as np
import pytest
import torch

from tpusystem_torch.checkpoint import Repository
from tpusystem_torch.observe import (
    Iterated, StepTimed, SummaryWriter, Trained, Validated,
    checkpoint_consumer, logging_consumer, tensorboard_consumer,
    tracking_consumer,
)
from tpusystem_torch.observe import tensorboard as tensorboard_module
from tpusystem_torch.observe import tracking
from tpusystem_torch.storage import (
    DocumentIterations, DocumentMetrics, DocumentModels, DocumentModules,
    DocumentStore,
)
from tests.tb import parse_scalars, read_records, read_scalars


class Model:
    """Host-side stand-in satisfying the aggregate surface consumers use."""

    def __init__(self, identity='hash-1', epoch=3):
        self.id = identity
        self.epoch = epoch
        self.state = {'w': torch.tensor([1.0, 2.0])}
        self._parts = {}

    def modules(self):
        return self._parts


def test_logging_consumer_reports_each_event(caplog):
    consumer = logging_consumer()
    model = Model()
    with caplog.at_level(logging.INFO, logger='tpusystem_torch'):
        consumer.consume(Trained(model, {'loss': 0.5}))
        consumer.consume(Validated(model, {'accuracy': 0.9}))
        consumer.consume(Iterated(model))
        consumer.consume(StepTimed(model, 'train', steps=100, seconds=2.0))
    text = caplog.text
    assert 'loss: 0.5000' in text and 'accuracy: 0.9000' in text
    assert 'hash-1' in text and '50.0 steps/s' in text


def test_summary_writer_emits_valid_tfrecord_events(tmp_path):
    writer = SummaryWriter(tmp_path / 'run')
    writer.add_scalar('loss', 0.25, step=7)
    writer.add_scalars('metrics', {'a': 1.0, 'b': 2.0}, step=8)
    writer.close()
    (event_file,) = list((tmp_path / 'run').iterdir())
    records = read_records(event_file)
    assert len(records) == 4                      # version + 3 scalars
    assert b'brain.Event:2' in records[0]
    scalars = {}
    for record in records[1:]:
        scalars.update(parse_scalars(record))
    assert scalars['loss'] == (0.25, 7)
    assert scalars['metrics/a'] == (1.0, 8) and scalars['metrics/b'] == (2.0, 8)


def test_tensorboard_consumer_charts_per_phase(tmp_path):
    consumer = tensorboard_consumer()
    writer = SummaryWriter(tmp_path / 'run')
    consumer.dependency_overrides[tensorboard_module.writer] = lambda: writer
    model = Model(identity='m1', epoch=2)
    consumer.consume(Trained(model, {'loss': 0.5}))
    consumer.consume(Validated(model, {'loss': 0.4}))
    writer.close()
    (event_file,) = list((tmp_path / 'run').iterdir())
    scalars = {}
    for record in read_records(event_file)[1:]:
        scalars.update(parse_scalars(record))
    assert scalars['m1/loss/train'] == (0.5, 2)
    value, step = scalars['m1/loss/evaluation']
    assert value == pytest.approx(0.4) and step == 2


@pytest.fixture()
def tracked(tmp_path):
    store = DocumentStore(tmp_path / 'db.json')
    consumer = tracking_consumer()
    saver = checkpoint_consumer()
    fixtures = {
        'metrics': DocumentMetrics(store),
        'models': DocumentModels(store),
        'modules': DocumentModules(store),
        'iterations': DocumentIterations(store),
        'repository': Repository(tmp_path / 'weights', async_save=False),
    }
    overrides = consumer.dependency_overrides
    overrides[tracking.metrics_store] = lambda: fixtures['metrics']
    overrides[tracking.models_store] = lambda: fixtures['models']
    overrides[tracking.modules_store] = lambda: fixtures['modules']
    overrides[tracking.iterations_store] = lambda: fixtures['iterations']
    overrides[tracking.repository] = lambda: fixtures['repository']
    overrides[tracking.experiment] = lambda: 'exp-test'
    saver.dependency_overrides[tracking.repository] = \
        lambda: fixtures['repository']
    yield (consumer, saver), fixtures
    fixtures['repository'].close()


def test_tracking_consumer_persists_metrics_and_epoch(tracked):
    (consumer, _), fixtures = tracked
    model = Model(identity='m1', epoch=4)
    consumer.consume(Trained(model, {'loss': 0.33}))
    consumer.consume(Validated(model, {'loss': 0.44, 'accuracy': 0.9}))
    rows = fixtures['metrics'].list('m1')
    assert {(r.name, r.phase) for r in rows} == {
        ('loss', 'train'), ('loss', 'evaluation'), ('accuracy', 'evaluation')}
    assert all(r.epoch == 4 for r in rows)

    consumer.consume(Iterated(model))
    assert fixtures['models'].read('m1', 'exp-test').epoch == 4


def test_tracking_consumer_persists_module_metadata_and_weights(tracked):
    from tpusystem_torch.data import Loader, SyntheticDigits
    from tpusystem_torch.models import MLP

    (consumer, saver), fixtures = tracked
    model = Model(identity='m2', epoch=1)
    network = MLP(features=(8,), classes=4, device='cpu')
    model._parts = {'nn': network, 'criterion': object()}
    loader = Loader(SyntheticDigits(samples=16, seed=0), batch_size=4,
                    device='cpu')
    event = Iterated(model, loaders={'train': loader})
    consumer.consume(event)
    saver.consume(event)   # all-hosts consumer

    by_kind = {row.kind: row for row in fixtures['modules'].list('m2')}
    assert by_kind['nn'].name == 'MLP'
    assert by_kind['nn'].arguments == {'features': (8,), 'classes': 4}
    assert by_kind['criterion'].hash is None   # unregistered degrades to name

    (iteration,) = fixtures['iterations'].list('m2')
    assert iteration.phase == 'train' and iteration.name == 'Loader'

    # weights snapshotted under the aggregate id at its epoch
    assert fixtures['repository'].latest(model) == 1


# --- the event-inventory drift guard (the reference's exemption list) ----

TB_EXEMPT = {
    'Iterated', 'StepTimed', 'RequestEvicted', 'RequestReplayed',
    'TokenStreamed', 'RouterDeposed', 'WorkerRelaunched',
    'WorldResizeProposed',
}


def _event_classes():
    from tpusystem_torch.observe import events as events_module
    return [value for value in vars(events_module).values()
            if dataclasses.is_dataclass(value) and isinstance(value, type)
            and value.__module__ == events_module.__name__]


def test_every_event_has_a_tb_handler_or_an_explicit_exemption():
    from tests.test_observe import TB_EXEMPT as REFERENCE_EXEMPT
    from tpusystem_torch.observe.metrics import serve_metrics_consumer
    assert TB_EXEMPT == REFERENCE_EXEMPT
    consumer = tensorboard_consumer()
    charted = {cls.__name__ for cls in consumer.types.values()}
    charted |= {cls.__name__
                for cls in serve_metrics_consumer().types.values()}
    classes = _event_classes()
    assert classes, 'found no event dataclasses'
    missing = [cls.__name__ for cls in classes
               if cls.__name__ not in charted
               and cls.__name__ not in TB_EXEMPT]
    assert not missing, missing
    stale = sorted(TB_EXEMPT & charted)
    assert not stale, f'exempted events that ARE charted now: {stale}'


def test_every_event_is_documented_in_observability_md():
    docs = (pathlib.Path(__file__).parent.parent / 'docs'
            / 'observability.md').read_text()
    missing = [cls.__name__ for cls in _event_classes()
               if cls.__name__ not in docs]
    assert not missing, missing


# --- profile.trace: only stop what was started ---------------------------

def test_trace_refuses_double_start_with_typed_error(monkeypatch):
    """A failed start (a profiler already active) surfaces as the typed
    ProfilerBusy carrying the ORIGINAL error, and stops nothing."""
    from tpusystem_torch.observe import ProfilerBusy, trace
    from tpusystem_torch.observe import profile

    calls = []
    monkeypatch.setattr(
        profile, 'start_trace',
        lambda logdir: (_ for _ in ()).throw(
            RuntimeError('Only one profile may be run at a time.')))
    monkeypatch.setattr(profile, 'stop_trace',
                        lambda profiler: calls.append('stop'))
    with pytest.raises(ProfilerBusy, match='already active') as caught:
        with trace('/tmp/unused'):
            raise AssertionError('body must not run on a failed start')
    assert 'Only one profile' in str(caught.value.__cause__)
    assert calls == [], 'stop_trace ran for a trace that never started'


def test_trace_stops_what_it_started(monkeypatch):
    from tpusystem_torch.observe import trace
    from tpusystem_torch.observe import profile

    calls = []
    monkeypatch.setattr(profile, 'start_trace',
                        lambda logdir: calls.append(('start', logdir))
                        or 'profiler')
    monkeypatch.setattr(profile, 'stop_trace',
                        lambda profiler: calls.append(('stop', profiler)))
    with trace('/tmp/logs'):
        pass
    assert calls == [('start', '/tmp/logs'), ('stop', 'profiler')]
    # the body's own exception still stops the trace it started
    calls.clear()
    with pytest.raises(ValueError):
        with trace('/tmp/logs'):
            raise ValueError('body failed')
    assert calls == [('start', '/tmp/logs'), ('stop', 'profiler')]


# --- fleet/* charts, parsed back -----------------------------------------

def test_tensorboard_fleet_charts_parse_back(tmp_path):
    from tpusystem_torch.observe.events import (FleetResized,
                                                ReplicaUnhealthy,
                                                RequestRerouted)

    consumer = tensorboard_consumer()
    writer = SummaryWriter(tmp_path / 'run')
    consumer.dependency_overrides[tensorboard_module.writer] = lambda: writer
    consumer.consume(ReplicaUnhealthy(name='rep0', cause='died mid-step',
                                      routed=3))
    consumer.consume(RequestRerouted(id='a', origin='rep0', target='rep1',
                                     where='hot', prefix=4,
                                     cause='failover'))
    consumer.consume(RequestRerouted(id='b', origin='rep0', target='rep2',
                                     where='cold', prefix=0,
                                     cause='failover'))
    consumer.consume(FleetResized(action='grow', replicas=4,
                                  cause='backpressure', name='rep3'))
    writer.close()
    scalars = read_scalars(tmp_path / 'run', history=True)
    assert scalars['fleet/unhealthy_total'] == [(1.0, 1)]
    assert scalars['fleet/rehomed_requests'] == [(3.0, 1)]
    assert scalars['fleet/rerouted_total'] == [(1.0, 1), (2.0, 2)]
    assert scalars['fleet/reroute_prefix'] == [(4.0, 1), (0.0, 2)]
    assert scalars['fleet/replicas'] == [(4.0, 1)]


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_observe_exports_the_references_names_in_order():
    import tpusystem.observe as reference

    import tpusystem_torch.observe as port
    assert port.__all__ == reference.__all__
    assert all(hasattr(port, name) for name in port.__all__)
    # the profiler function keeps the package attribute, as on the
    # reference
    assert callable(port.trace) and not hasattr(port.trace, 'Tracer')


def _write_events(package, logdir):
    writer = package.SummaryWriter(logdir)
    writer.add_scalar('loss', 0.25, step=7)
    writer.add_scalar('loss', float('nan'), step=8)
    writer.add_scalars('metrics', {'a': 1.0, 'b': -2.5e-7}, step=2 ** 40)
    writer.add_scalar('negative', -1.0, step=-3)
    writer.close()
    (event_file,) = list(pathlib.Path(logdir).iterdir())
    return event_file.name, event_file.read_bytes()


def test_summary_writer_files_are_byte_equal_to_the_references(
        tmp_path, monkeypatch):
    """The same scalars at the same pinned wall time: the port's event file
    has the reference's name and bytes."""
    import time

    import tpusystem.observe as reference

    import tpusystem_torch.observe as port
    monkeypatch.setattr(time, 'time', lambda: 1_700_000_000.125)
    want = _write_events(reference, tmp_path / 'reference')
    got = _write_events(port, tmp_path / 'port')
    assert got == want


def test_tensorboard_consumer_files_are_byte_equal_to_the_references(
        tmp_path, monkeypatch):
    """The whole consumer (per-phase metrics, sentinel and serving charts)
    on the same events writes the reference's bytes."""
    import time

    from tpusystem.observe import events as reference_events
    from tpusystem.observe import tensorboard as reference_board

    from tpusystem_torch.observe import events as port_events
    monkeypatch.setattr(time, 'time', lambda: 1_700_000_000.5)
    files = []
    for board, events, root in ((reference_board, reference_events, 'ref'),
                                (tensorboard_module, port_events, 'port')):
        consumer = board.tensorboard_consumer()
        writer = board.SummaryWriter(tmp_path / root)
        consumer.dependency_overrides[board.writer] = lambda: writer
        model = Model(identity='m1', epoch=2)
        consumer.consume(events.Trained(model, {'loss': 0.5}))
        consumer.consume(events.Validated(model, {'loss': 0.4,
                                                  'accuracy': 0.75}))
        consumer.consume(events.RequestAdmitted(
            id='r0', row=1, prompt_tokens=5, ttft=0.01, queue_depth=2))
        consumer.consume(events.ServeStepped(
            step=3, active=2, queue_depth=1, emitted=2,
            tokens_per_sec=120.5))
        writer.close()
        (event_file,) = list((tmp_path / root).iterdir())
        files.append(event_file.read_bytes())
    assert files[0] == files[1]


def _token_file(tmp_path, tokens: int = 4000, seed: int = 3):
    path = tmp_path / 'corpus.bin'
    values = np.random.default_rng(seed).integers(0, 50304, tokens)
    path.write_bytes(values.astype(np.uint16).tobytes())
    return path


@pytest.mark.parametrize('stride', [None, 7, 64])
def test_memmap_tokens_windows_are_bitwise_the_references(tmp_path, stride):
    from tpusystem.data import MemmapTokens as ReferenceTokens
    from tpusystem.registry import gethash as reference_gethash

    from tpusystem_torch.data import MemmapTokens
    from tpusystem_torch.registry import gethash
    path = _token_file(tmp_path)
    reference = ReferenceTokens(path, sequence_length=63, stride=stride)
    port = MemmapTokens(path, sequence_length=63, stride=stride)
    assert len(port) == len(reference) > 8
    assert gethash(port) == reference_gethash(reference)
    index = np.random.default_rng(0).permutation(len(port))[:16]
    for key in (index, index[::-1].copy(), np.arange(len(port)), 0,
                len(port) - 1):
        (want,), (got,) = reference[key], port[key]
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_memmap_tokens_feed_the_ports_loader(tmp_path):
    """Batches of the port's ``Loader`` over ``MemmapTokens`` are the
    reference loader's batches, bitwise (the epoch's order is the
    reference's)."""
    from tpusystem.data import Loader as ReferenceLoader
    from tpusystem.data import MemmapTokens as ReferenceTokens

    from tpusystem_torch.data import Loader, MemmapTokens
    path = _token_file(tmp_path)
    reference = ReferenceLoader(ReferenceTokens(path, sequence_length=31),
                                batch_size=8, shuffle=True, seed=2)
    port = Loader(MemmapTokens(path, sequence_length=31), batch_size=8,
                  shuffle=True, seed=2, device='cpu')
    pairs = list(zip(reference, port))
    assert len(pairs) == len(port) > 4
    for (want,), (got,) in pairs:
        assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_memmap_tokens_refuses_a_file_shorter_than_a_window(tmp_path):
    from tpusystem_torch.data import MemmapTokens
    path = tmp_path / 'short.bin'
    path.write_bytes(np.arange(10, dtype=np.uint16).tobytes())
    with pytest.raises(ValueError, match='one window'):
        MemmapTokens(path, sequence_length=10)


def test_torch_dataset_arrays_are_bitwise_the_references():
    from tpusystem.data import TorchDataset as ReferenceDataset

    from tpusystem_torch.data import TorchDataset
    generator = torch.Generator().manual_seed(0)
    items = [(torch.randn(3, 4, generator=generator), index % 5)
             for index in range(12)]
    reference, port = ReferenceDataset(items), TorchDataset(items)
    assert len(port) == len(reference) == 12
    for want, got in zip(reference.arrays, port.arrays):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    single = TorchDataset([torch.arange(3) + index for index in range(4)])
    assert len(single.arrays) == 1 and single.arrays[0].shape == (4, 3)


# ---------------------------------------------------------------------------
# the real profiler on the CPU, and the step timer
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_the_step_ranges(tmp_path):
    import json

    from tpusystem_torch.observe import annotate, step_span, trace
    with trace(str(tmp_path)):
        for step in (1, 2):
            with step_span('train', step):
                with annotate('work'):
                    torch.ones(8).add_(1)
    (path,) = list(tmp_path.glob('*.pt.trace.json'))
    names = {event.get('name')
             for event in json.loads(path.read_text())['traceEvents']}
    assert {'ProfilerStep#1', 'ProfilerStep#2', 'work'} <= names


def test_trace_refuses_to_nest_a_real_profiler(tmp_path):
    from tpusystem_torch.observe import ProfilerBusy, trace
    with trace(str(tmp_path / 'outer')):
        with pytest.raises(ProfilerBusy, match='already active'):
            with trace(str(tmp_path / 'inner')):
                raise AssertionError('the nested body must not run')
    assert list((tmp_path / 'outer').glob('*.pt.trace.json'))
    assert not (tmp_path / 'inner').exists() or not list(
        (tmp_path / 'inner').glob('*.pt.trace.json'))


def test_step_span_names_the_profilers_own_step_ranges():
    """``step_span`` names its range as ``torch.profiler.profile.step()``
    names its steps."""
    import inspect

    import torch.profiler.profiler as profiler_module

    from tpusystem_torch.observe.profile import STEP_RANGE
    assert '"ProfilerStep#"' in inspect.getsource(profiler_module)
    assert STEP_RANGE.format(7) == 'ProfilerStep#7'


def test_step_timer_dispatches_step_timed(monkeypatch):
    from tpusystem_torch.observe import StepTimer
    from tpusystem_torch.services.prodcon import Consumer, Producer
    producer, seen = Producer(), []
    consumer = Consumer('probe')
    consumer.register(StepTimed, seen.append)
    producer.register(consumer)
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize', synced.append)
    timer = StepTimer(producer).start()
    timed = timer.stop('model', 'train', steps=4,
                       result={'loss': torch.ones(2)})
    assert seen == [timed] and timed.steps == 4 and timed.seconds >= 0
    assert synced == []               # nothing on a card to wait for
    with pytest.raises(RuntimeError, match='without start'):
        timer.stop('model', 'train', steps=1)
