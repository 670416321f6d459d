"""Device work put down to the program's ranges, read from a traced run's
raw profiler events.

The program marks its forward code with host ranges named under one
prefix (:data:`PROGRAM_PREFIX`; ``tpusystem_torch.observe.profile``
``RANGES``): the train step's forward, loss, backward and optimizer, the
attention call and the embedding lookup. Each device activity (a kernel, a
copy, a fill) is put down to one of them:

* the profiler links the activity, by its correlation id, to the runtime
  call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
  ``cuLaunchKernelEx``, ...: a kernel launched through ctypes has a launch
  like any other, and no aten operator); the activity takes the innermost
  program range open on the launching thread at the launch;
* where the launch falls inside an autograd engine's ``evaluate_function``
  event nested in that range (or in none), the activity is backward work:
  it takes the range that held the forward operator with the event's
  sequence number, on the event's forward thread, with ``.backward``
  added; backward work that no forward operator claims
  (``AccumulateGrad``) takes the range open on the forward thread while the
  backward ran (the step's ``train.backward``);
* a host-to-device copy outside every range is ``data.copy`` (the loader's
  prefetch thread, which started before the profiler and records nothing);
* the rest is ``unattributed``.

The ranges are operator-kind ``RecordFunction`` events, so the profiler
draws no copy of them on the device's timeline; copies that another
profiler draws anyway (of user annotations under either prefix) are left
out here, as the harness leaves out its own spans' copies.

The harness hands a metric's reader the reduced trace only, not the
profiler (``harness.Run.trace``). The stopped profiler is still held by
``run.py`` while the readers run, and :func:`of` finds it among the live
objects by the window it traced. Nothing here imports the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import gc

from portbench.harness import SPAN_PREFIX, WINDOW_SPAN, covered, merge

PROGRAM_PREFIX = 'tpusystem_torch.'
BACKWARD_EVENT = 'autograd::engine::evaluate_function: '
BACKWARD = '.backward'
DATA_COPY = 'data.copy'
UNATTRIBUTED = 'unattributed'
HOST_TO_DEVICE = 'Memcpy HtoD'
# the step's ranges and the layers' ranges that launch counts cover
STEP_RANGES = ('train.forward', 'train.loss', 'train.backward',
               'train.optimizer', 'attention', 'embedding')


@dataclasses.dataclass
class Attribution:
    """A traced window's device activities, each with its range (the range's
    name without :data:`PROGRAM_PREFIX`, ``data.copy`` or
    ``unattributed``), and the program ranges' host intervals; times in
    microseconds on the profiler's clock."""
    activities: list        # [(start_us, end_us, name, range)]
    ranges: list            # [(start_us, end_us, range)] on the host
    spans: list             # the harness's spans, as harness.Trace has them
    window: tuple           # (start_us, end_us)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @functools.cached_property
    def inside(self) -> list:
        """The activities that run inside the window, in order of start."""
        low, high = self.window
        return sorted(activity for activity in self.activities
                      if activity[1] > low and activity[0] < high)

    @functools.cached_property
    def _by_range(self) -> dict:
        found: dict[str, list] = {}
        for start, end, _, where in self.inside:
            found.setdefault(where, []).append((start, end))
        return found

    @property
    def busy_s(self) -> float:
        return covered([(s, e) for s, e, _, _ in self.inside],
                       *self.window) / 1e6

    def seconds(self, ranges) -> float | None:
        """Device seconds, inside the window, of the activities put down to
        ``ranges`` (overlaps counted once); None where none ran."""
        chosen = [pair for where in ranges
                  for pair in self._by_range.get(where, ())]
        if not chosen:
            return None
        return covered(chosen, *self.window) / 1e6

    def count(self, ranges) -> int:
        """Device activities inside the window put down to ``ranges``."""
        return sum(len(self._by_range.get(where, ())) for where in ranges)

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps in the device's activity inside the window, each
        named by the range of the activity that ends it, which the host was
        in while the device waited; the gap that no activity ends takes the
        harness's rule (the innermost harness span open when it began,
        ``idle`` where none was)."""
        low, high = self.window
        inside = self.inside
        busy = merge((max(s, low), min(e, high)) for s, e, _, _ in inside)
        starts = [activity[0] for activity in inside]
        gaps, cursor = [], low
        for start, end in busy:
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if high > cursor:
            gaps.append((cursor, high))
        gaps.sort(key=lambda gap: gap[0] - gap[1])
        named = []
        for start, end in gaps[:top]:
            index = bisect.bisect_left(starts, end)
            where = (inside[index][3] if index < len(inside)
                     else _span_at(self.spans, start))
            named.append([where, (end - start) / 1e6])
        return named


def _span_at(spans, time: float) -> str:
    """The harness's name for a gap that begins at ``time``."""
    inner, name = None, 'idle'
    for start, end, span in spans:
        if start <= time <= end and (inner is None or end - start < inner):
            inner, name = end - start, span
    return name


class _Nest:
    """One host thread's ranges and backward events, properly nested:
    :meth:`around` gives the innermost range and backward event open at a
    time."""

    def __init__(self, markers) -> None:
        self.markers = sorted(markers, key=lambda m: (m[0], -m[1]))
        self.starts = [marker[0] for marker in self.markers]
        self.parents, stack = [], []
        for index, (start, end, _, _) in enumerate(self.markers):
            while stack and self.markers[stack[-1]][1] < start:
                stack.pop()
            self.parents.append(stack[-1] if stack else None)
            stack.append(index)

    def around(self, time: float) -> tuple:
        """``(range, backward)``: the innermost program range open at
        ``time`` and the innermost backward event open inside it (or in
        none), each a marker or None."""
        index = bisect.bisect_right(self.starts, time) - 1
        found_range, found_backward = None, None
        while index is not None and index >= 0:
            start, end, kind, _ = marker = self.markers[index]
            if start <= time <= end:
                if kind == 'range':
                    found_range = marker
                    break
                if found_backward is None:
                    found_backward = marker
            index = self.parents[index]
        return found_range, found_backward


def attribute(events, cuda) -> Attribution | None:
    """Put the device activities of a profiler's raw events (``kineto_results
    .events()``, or objects with the same methods) down to the program's
    ranges; ``cuda`` is the device type of the device's events. None where
    the events hold no window span or no program range.

    One pass over the events, which a window of many steps holds by the
    million: each accessor is a call into the profiler's results, so an
    event is asked only what its kind needs."""
    activities, markers, spans, window = [], {}, [], None
    launches, numbered = {}, {}
    for event in events:
        if event.device_type() == cuda:
            name = event.name()
            if not name.startswith((PROGRAM_PREFIX, SPAN_PREFIX)):
                activities.append((event.start_ns(), event.end_ns(), name,
                                   event.correlation_id()))
            continue
        if event.linked_correlation_id():
            # a runtime call made inside a host operator: the launch of the
            # device activity that shares its correlation id
            launches[event.correlation_id()] = event
            continue
        name = event.name()
        if name.startswith(PROGRAM_PREFIX):
            markers.setdefault(event.start_thread_id(), []).append(
                (event.start_ns(), event.end_ns(), 'range',
                 name[len(PROGRAM_PREFIX):]))
        elif name.startswith(BACKWARD_EVENT):
            markers.setdefault(event.start_thread_id(), []).append(
                (event.start_ns(), event.end_ns(), 'backward',
                 (event.sequence_nr(), event.fwd_thread_id())))
        elif name.startswith(SPAN_PREFIX):
            if name == WINDOW_SPAN:
                window = (event.start_ns(), event.end_ns())
            else:
                spans.append((event.start_ns() / 1e3, event.end_ns() / 1e3,
                              name[len(SPAN_PREFIX):]))
        sequence = event.sequence_nr()
        if sequence >= 0:
            # the first event of the number on its thread is the forward
            # operator, which comes before the backward's own events
            key = (sequence, event.start_thread_id())
            seen = numbered.get(key)
            if seen is None or event.start_ns() < seen.start_ns():
                numbered[key] = event
    ranges = [(start / 1e3, end / 1e3, where) for found in markers.values()
              for start, end, kind, where in found if kind == 'range']
    if window is None or not ranges:
        return None
    nests = {thread: _Nest(found) for thread, found in markers.items()}

    def open_range(thread, time):
        nest = nests.get(thread)
        return nest.around(time) if nest else (None, None)

    def decide(correlation):
        launch = launches.get(correlation)
        if launch is None:
            return None
        inner, engine = open_range(launch.start_thread_id(),
                                   launch.start_ns())
        if engine is None:
            return inner[3] if inner else None
        made = numbered.get(engine[3])
        if made is not None:
            holder, _ = open_range(engine[3][1], made.start_ns())
            if holder is not None:
                return holder[3] + BACKWARD
        running, _ = open_range(engine[3][1], engine[0])
        return running[3] if running else (inner[3] if inner else None)

    attributed = [(start / 1e3, end / 1e3, name, decide(correlation) or (
        DATA_COPY if name.startswith(HOST_TO_DEVICE) else UNATTRIBUTED))
        for start, end, name, correlation in activities]
    return Attribution(activities=attributed, ranges=sorted(ranges),
                       spans=spans,
                       window=(window[0] / 1e3, window[1] / 1e3))


_LAST: dict = {}


def of(run) -> Attribution | None:
    """The attribution of a traced run's window, from the stopped profiler
    that traced it; None where the run was not traced or its trace holds no
    program range (as at a commit whose program marks none). Computed once
    a run, for every reader."""
    trace = run.trace
    if trace is None:
        return None
    if _LAST.get('trace') is trace:
        return _LAST['attribution']
    import torch
    found = None
    for candidate in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # of the process's objects answer with a deprecation warning
        if type(candidate) is not torch.profiler.profile:
            continue
        results = getattr(getattr(candidate, 'profiler', None),
                          'kineto_results', None)
        if results is None:
            continue
        attribution = attribute(results.events(),
                                torch.autograd.DeviceType.CUDA)
        if attribution is not None and attribution.window == trace.window:
            found = attribution
            break
    _LAST.update(trace=trace, attribution=found)
    return found


def share(run, ranges) -> float | None:
    """Percent of the traced window's seconds in which activities put down
    to ``ranges`` ran."""
    attribution = of(run)
    if attribution is None:
        return None
    seconds = attribution.seconds(ranges)
    if seconds is None:
        return None
    return 100.0 * seconds / attribution.window_s


def roofline(run, ranges, least_seconds: float) -> float | None:
    """Percent of the device seconds put down to ``ranges`` that their
    least time (``counts/``) is."""
    attribution = of(run)
    if attribution is None:
        return None
    seconds = attribution.seconds(ranges)
    if not seconds:
        return None
    return 100.0 * least_seconds / seconds


def with_backward(*ranges) -> tuple:
    return tuple(ranges) + tuple(name + BACKWARD for name in ranges)
