"""Tracing/profiling subsystem: the port of :mod:`tpusystem.observe.profile`.

Two faces, as in the reference:

- **device plane** — :func:`trace` / :func:`annotate` / :func:`step_span`
  wrap ``torch.profiler`` (the reference wraps ``jax.profiler``): a trace
  records the host's operators and, when a card is present, its kernels
  (CUPTI), and writes a Chrome trace into a TensorBoard-readable logdir
  (``tensorboard_trace_handler``). Annotations are host ranges that cost
  one check when no profiler is active, so they stay in production code;
  the program's own ranges are named in :data:`RANGES`.
- **bus plane** — :class:`StepTimer` measures host wall-clock around step
  spans and emits :class:`~tpusystem_torch.observe.events.StepTimed`
  events; any consumer (logging, storage, TensorBoard) observes throughput
  without the trainer knowing its observers.

The profiler's start and stop are the module-level :func:`start_trace` and
:func:`stop_trace`, the one seam a test replaces (as the reference's tests
replace ``jax.profiler.start_trace``/``stop_trace``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

import torch

from tpusystem_torch.observe.events import StepTimed
from tpusystem_torch.services.prodcon import Producer

# the name torch.profiler.profile.step() gives its step ranges
STEP_RANGE = 'ProfilerStep#{}'

# The program's ranges (:func:`annotate`), every name under one prefix. The
# ranges mark forward code only: the autograd engine's backward events carry
# the sequence number of the forward operator whose node they run, so a
# trace's reader puts backward work down to the forward range that made it.
RANGE_PREFIX = 'tpusystem_torch.'
TRAIN_FORWARD = RANGE_PREFIX + 'train.forward'      # the model's forward
TRAIN_LOSS = RANGE_PREFIX + 'train.loss'            # the criterion (LM head)
TRAIN_BACKWARD = RANGE_PREFIX + 'train.backward'    # torch.autograd.grad
TRAIN_OPTIMIZER = RANGE_PREFIX + 'train.optimizer'  # the update, step count
ATTENTION = RANGE_PREFIX + 'attention'              # the flash call
EMBEDDING = RANGE_PREFIX + 'embedding'              # a table's lookup
RANGES = (TRAIN_FORWARD, TRAIN_LOSS, TRAIN_BACKWARD, TRAIN_OPTIMIZER,
          ATTENTION, EMBEDDING)

_UNTRACED = contextlib.nullcontext()


class ProfilerBusy(RuntimeError):
    """:func:`start_trace` refused — almost always because a profiler is
    already active (nested :func:`trace`, or one that never stopped).
    Typed so callers can skip-or-queue instead of crashing, and so the
    ORIGINAL error is what surfaces: a failed start stops nothing."""


def start_trace(logdir: str) -> Any:
    """Start a ``torch.profiler.profile`` writing its Chrome trace into
    ``logdir`` on stop; returns the profiler. Activities follow the devices
    present: the CPU always, CUDA when a card is present. Raises
    ``RuntimeError`` when a profiler is already active in this process."""
    if torch.autograd._profiler_enabled():
        raise RuntimeError('a profiler is already active in this process')
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)))
    profiler.start()
    return profiler


def stop_trace(profiler: Any) -> None:
    """Stop a profiler :func:`start_trace` started; its trace is written."""
    profiler.stop()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device trace for the enclosed span into ``logdir`` (a
    ``*.pt.trace.json`` file that TensorBoard's profile plugin, Perfetto
    and ``chrome://tracing`` open).

    Only a trace this context actually *started* is stopped on exit: a
    failed start (e.g. a profiler already active) raises the typed
    :exc:`ProfilerBusy` and leaves the pre-existing profiler untouched."""
    try:
        profiler = start_trace(logdir)
    except RuntimeError as error:
        raise ProfilerBusy(
            f'start_trace({logdir!r}) refused: {error} — a device trace is '
            f'already active; stop it (or nest annotate()/step_span() '
            f'instead, which compose)') from error
    try:
        yield
    finally:
        stop_trace(profiler)


def annotate(name: str) -> Any:
    """Named range on the host timeline of an active trace; with no profiler
    active, one shared context that does nothing.

    The range is a ``RecordFunction`` of the operators' kind, not a
    ``record_function`` user annotation: it encloses on the host's timeline
    the operators and runtime calls made inside it, as an operator does,
    and the profiler draws no copy of it on the device's timeline, where a
    trace's reader would count it as device work."""
    if not torch.autograd._profiler_enabled():
        return _UNTRACED
    return torch._C._profiler._RecordFunctionFast(name)


def step_span(name: str, step: int) -> Any:
    """Step-correlated range: named as ``torch.profiler.profile.step()``
    names its steps (``ProfilerStep#<step>``), so trace viewers group the
    step's operators and kernels under it. ``name`` is the reference's
    argument (``StepTraceAnnotation(name, step_num=step)``); the range
    carries the step number only."""
    del name
    return torch.profiler.record_function(STEP_RANGE.format(int(step)))


def _synchronize(result: Any) -> None:
    """Block until the work behind ``result`` (a tensor or a nest of them)
    is done: synchronize the streams of every card that holds one of its
    tensors — the port's ``block_until_ready``."""
    devices = set()

    def visit(value):
        if isinstance(value, torch.Tensor):
            if value.device.type == 'cuda':
                devices.add(value.device)
        elif isinstance(value, dict):
            for item in value.values():
                visit(item)
        elif isinstance(value, (tuple, list)):
            for item in value:
                visit(item)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock throughput measurement around step spans.

    The timer brackets a *span* of steps — never a single one; timing a
    single step would force a device sync per step (SURVEY.md §7.3
    "keeping the bus off the hot path"). ``stop`` blocks on ``result`` (any
    tensor from the last step) so the measurement covers the card's work
    rather than the host's asynchronous launches.

    Example::

        timer = StepTimer(producer)
        timer.start()
        for batch in loader:
            state, out = step(state, batch)
        timer.stop(model, 'train', steps=len(loader), result=out)
    """

    def __init__(self, producer: Producer | None = None) -> None:
        self.producer = producer
        self._started: float | None = None

    def start(self) -> 'StepTimer':
        self._started = time.perf_counter()
        return self

    def stop(self, model: Any, phase: str, steps: int,
             result: Any = None) -> StepTimed:
        if self._started is None:
            raise RuntimeError('StepTimer.stop() without start()')
        if result is not None:
            _synchronize(result)
        timed = StepTimed(model=model, phase=phase, steps=steps,
                          seconds=time.perf_counter() - self._started)
        self._started = None
        if self.producer is not None:
            self.producer.dispatch(timed)
        return timed
