"""Device work put down to the program's ranges (``portbench/attribution.py``)
on synthetic traces: the innermost range of a launch, backward work through
the sequence link, the loader's copies, the ranges' own device copies left
out, and the idle gaps named by range."""

import dataclasses
import importlib
import types

import pytest
import torch

from portbench import attribution, harness
from portbench.attribution import BACKWARD_EVENT, attribute

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
MAIN, WORKER, LOADER = 1, 2, 3


@dataclasses.dataclass
class Event:
    """The methods of a profiler's raw event that the reduction reads;
    times in microseconds."""
    label: str
    start: float
    end: float
    thread: int = MAIN
    device: object = CPU
    correlation: int = 0
    linked: int = 0
    sequence: int = -1
    forward_thread: int = 0

    def name(self):
        return self.label

    def device_type(self):
        return self.device

    def start_ns(self):
        return int(self.start * 1000)

    def end_ns(self):
        return int(self.end * 1000)

    def start_thread_id(self):
        return self.thread

    def correlation_id(self):
        return self.correlation

    def linked_correlation_id(self):
        return self.linked

    def sequence_nr(self):
        return self.sequence

    def fwd_thread_id(self):
        return self.forward_thread


def kernel(name, start, end, correlation, thread=MAIN):
    """A device activity; its launch shares its correlation id."""
    return Event(name, start, end, thread, device=CUDA,
                 correlation=correlation)


def launch(start, correlation, operator, thread=MAIN):
    """The runtime call that launched device activity ``correlation``
    inside the host operator whose correlation id is ``operator``."""
    return Event('cudaLaunchKernel', start, start + 1, thread,
                 correlation=correlation, linked=operator)


def program(name, start, end, thread=MAIN):
    return Event('tpusystem_torch.' + name, start, end, thread)


def step_events():
    """One step: a forward holding the flash call, a backward whose engine
    runs on a worker thread, the loader's copy and a stray kernel."""
    return [
        Event('portbench.window', 0, 1000),
        Event('portbench.step', 0, 900),
        program('train.forward', 10, 100),
        program('attention', 20, 60),
        Event('_FlashAttention', 25, 55, correlation=101, sequence=7),
        launch(26, 11, 101),
        Event('aten::mm', 70, 80, correlation=102, sequence=8),
        launch(71, 12, 102),
        program('train.backward', 200, 400),
        Event(BACKWARD_EVENT + '_FlashAttentionBackward', 210, 260, WORKER,
              sequence=7, forward_thread=MAIN),
        Event('_FlashAttentionBackward', 212, 258, WORKER, correlation=201,
              sequence=7),
        launch(213, 13, 201, WORKER),
        Event(BACKWARD_EVENT + 'torch::autograd::AccumulateGrad', 300, 320,
              WORKER, sequence=-1, forward_thread=MAIN),
        Event('aten::copy_', 302, 318, WORKER, correlation=202),
        launch(303, 14, 202, WORKER),
        # the loader's thread, which the profiler does not see: its runtime
        # calls link to no operator, and a profiler event of its own may
        # share an operator's correlation id
        Event('cudaMemcpyAsync', 495, 496, LOADER, correlation=15),
        Event('Activity Buffer Request', 40, 41, correlation=101),
        # the device's timeline: a range's copy there, and the activities
        Event('tpusystem_torch.attention', 20, 600, 0, device=CUDA),
        kernel('void flash_fwd_kernel<64>', 30, 50, 11),
        kernel('gemm', 72, 90, 12),
        kernel('void flash_bwd_fused_kernel<64>', 220, 255, 13, WORKER),
        kernel('add_kernel', 305, 315, 14, WORKER),
        kernel('Memcpy HtoD (Pinned -> Device)', 500, 510, 15, LOADER),
        kernel('Memcpy HtoD (Pinned -> Device)', 520, 530, 16, LOADER),
        kernel('stray_kernel', 600, 620, 17),
    ]


@pytest.fixture
def attributed():
    return attribute(step_events(), CUDA)


def where(attributed):
    return {(name, start): found
            for start, _, name, found in attributed.activities}


def test_the_ranges_device_copies_are_left_out_of_busy(attributed):
    assert all(not name.startswith('tpusystem_torch.')
               for _, _, name, _ in attributed.activities)
    assert attributed.busy_s == pytest.approx(
        (20 + 18 + 35 + 10 + 10 + 10 + 20) / 1e6)


def test_an_activity_takes_its_launchs_innermost_range(attributed):
    found = where(attributed)
    assert found[('void flash_fwd_kernel<64>', 30)] == 'attention'
    assert found[('gemm', 72)] == 'train.forward'


def test_backward_work_takes_its_forward_range(attributed):
    found = where(attributed)
    assert found[('void flash_bwd_fused_kernel<64>', 220)] == \
        'attention.backward'
    # AccumulateGrad has no forward operator: the step's backward range
    assert found[('add_kernel', 305)] == 'train.backward'


def test_a_copy_outside_every_range_is_the_loaders(attributed):
    found = where(attributed)
    assert found[('Memcpy HtoD (Pinned -> Device)', 500)] == 'data.copy'
    assert found[('Memcpy HtoD (Pinned -> Device)', 520)] == 'data.copy'
    assert found[('stray_kernel', 600)] == 'unattributed'


def test_attributed_and_unattributed_seconds_make_up_busy(attributed):
    every = {where for _, _, _, where in attributed.activities}
    assert every == {'attention', 'train.forward', 'attention.backward',
                     'train.backward', 'data.copy', 'unattributed'}
    assert attributed.seconds(every) == pytest.approx(attributed.busy_s)
    assert attributed.seconds(('unattributed',)) == pytest.approx(20 / 1e6)


def test_overlapping_activities_count_once_in_each_range():
    events = [Event('portbench.window', 0, 100),
              program('train.forward', 0, 50),
              Event('aten::mm', 1, 3, correlation=5), launch(2, 1, 5),
              Event('aten::mm', 4, 6, correlation=6), launch(5, 2, 6),
              kernel('gemm', 10, 30, 1), kernel('gemm', 20, 35, 2),
              kernel('Memcpy HtoD (Pinned -> Device)', 20, 40, 3)]
    found = attribute(events, CUDA)
    assert found.busy_s == pytest.approx(30 / 1e6)
    assert found.seconds(('train.forward',)) == pytest.approx(25 / 1e6)
    assert found.seconds(('data.copy',)) == pytest.approx(20 / 1e6)
    assert found.count(('train.forward',)) == 2


def test_seconds_and_counts_by_range(attributed):
    assert attributed.seconds(('attention', 'attention.backward')) == \
        pytest.approx(55 / 1e6)
    assert attributed.seconds(('train.loss',)) is None
    assert attributed.count(attribution.with_backward(
        *attribution.STEP_RANGES)) == 4
    assert [name for _, _, name in attributed.ranges] == [
        'train.forward', 'attention', 'train.backward']


def test_idle_gaps_take_the_range_that_ends_them(attributed):
    gaps = dict((round(seconds * 1e6), name)
                for name, seconds in attributed.idle_gaps(top=20))
    assert gaps[130] == 'attention.backward'     # 90 to 220
    assert gaps[30] == 'attention'               # 0 to 30
    assert gaps[380] == 'step'                   # 620 to 1000: none after
    assert gaps[70] == 'unattributed'            # 530 to 600: a stray kernel
    assert gaps[185] == 'data.copy'              # 315 to 500


def _reduced(events):
    """``harness.reduce_trace`` of the events, as a profiler holds them."""
    results = types.SimpleNamespace(events=lambda: events)
    profiler = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    fake_torch = types.SimpleNamespace(autograd=torch.autograd)
    return harness.reduce_trace(fake_torch, profiler)


def test_a_trace_without_program_ranges_reads_nothing():
    events = [event for event in step_events()
              if not event.label.startswith('tpusystem_torch.')]
    assert attribute(events, CUDA) is None
    trace = _reduced(events)
    assert trace.busy_s == pytest.approx(attribute(step_events(),
                                                   CUDA).busy_s)


def test_the_gap_no_activity_ends_reads_as_the_harness_reads_it():
    events = [Event('portbench.window', 0, 1000),
              Event('portbench.step', 100, 900),
              Event('portbench.data_wait', 400, 500),
              program('train.optimizer', 950, 990),
              kernel('gemm', 200, 300, 1), kernel('gemm', 450, 600, 2),
              kernel('gemm', 700, 710, 3)]
    harness_gaps = _reduced(events).idle_gaps()
    assert attribute(events, CUDA).idle_gaps() == [
        [name if start == 710 else 'unattributed', seconds]
        for (name, seconds), start in zip(harness_gaps, (710, 0, 300, 600))]


def _traced_run():
    """A real CPU profiler over a range and the harness's window span,
    reduced as ``run.py`` reduces it, the profiler still alive."""
    holder, spans = {}, harness.Spans()
    with harness.profiled(torch, spans, holder):
        with spans.span('window'):
            with torch._C._profiler._RecordFunctionFast(
                    'tpusystem_torch.train.forward'):
                torch.ones(4).add_(1)
    trace = harness.reduce_trace(torch, holder['profiler'])
    run = types.SimpleNamespace(trace=trace, counts={'steps': 1})
    return holder, run


def test_of_finds_the_profiler_that_traced_the_run():
    holder, run = _traced_run()
    found = attribution.of(run)
    assert found is not None and found.window == run.trace.window
    assert [name for _, _, name in found.ranges] == ['train.forward']
    assert attribution.of(run) is found
    del holder


@pytest.mark.parametrize('name', [
    'lm.loss_device_share', 'lm.optimizer_device_share',
    'lm.attention_roofline', 'dlrm.optimizer_device_share',
    'dlrm.embedding_tier_roofline', 'dlrm.launches_per_step'])
def test_the_readers_read_nothing_without_device_work(name):
    holder, run = _traced_run()
    run.counts.update(attention_flops=1.0, attention_bytes=1.0,
                      lookup_bytes=1.0)
    reader = harness.load_module('metrics', name)
    assert reader.read(run) is None
    assert reader.read(types.SimpleNamespace(trace=None,
                                             counts=run.counts)) is None
    del holder


def test_the_readers_read_the_attributed_device_time(monkeypatch,
                                                     attributed):
    run = types.SimpleNamespace(trace=object(), counts={
        'steps': 2, 'attention_flops': 0.0, 'attention_bytes': 0.0,
        'lookup_bytes': 0.0})
    monkeypatch.setattr(attribution, '_LAST', {'trace': run.trace,
                                               'attribution': attributed})
    share = harness.load_module('metrics', 'lm.optimizer_device_share')
    assert share.read(run) is None
    launches = harness.load_module('metrics', 'dlrm.launches_per_step')
    assert launches.read(run) == 2.0
    peaks = importlib.import_module('portbench.counts.peaks')
    run.counts['lookup_bytes'] = 55e-6 * peaks.HBM_BYTES_PER_S / 2
    tier = harness.load_module('metrics', 'dlrm.embedding_tier_roofline')
    assert tier.read(run) is None               # no embedding range here
    roof = harness.load_module('metrics', 'lm.attention_roofline')
    assert roof.read(run) == 0.0
