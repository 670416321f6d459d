"""The benchmark's shared machinery: finding a cell's files by name, the
host clock's spans, the device trace's reduction, exact percentiles, and
the result line.

Nothing here imports the program (``tpusystem_torch``): the drivers under
``drivers/`` are the only files that drive it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that may not be loaded in a run's process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'tpusystem')
SPAN_PREFIX = 'portbench.'
WINDOW_SPAN = SPAN_PREFIX + 'window'


def read_json(path: pathlib.Path):
    return json.loads(path.read_text())


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return read_json(root / 'BENCHMARK.json')


def find(entries: list, name: str, kind: str) -> dict:
    for entry in entries:
        if entry['name'] == name:
            return entry
    raise KeyError(f'no {kind} named {name!r} in BENCHMARK.json')


def data_file(kind: str, name: str, bench: pathlib.Path = BENCH) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return read_json(bench / kind / f'{name}.json')


def load_module(kind: str, name: str, bench: pathlib.Path = BENCH):
    """The module ``<kind>/<name>.py`` under the benchmark's folder, loaded
    from its path: a driver, a generator or a metric's reader."""
    path = bench / kind / f'{name}.py'
    if not path.is_file():
        raise KeyError(f'no {kind[:-1]} file {path.relative_to(bench)}')
    tag = hashlib.blake2b(str(path).encode(), digest_size=6).hexdigest()
    name = f'portbench_{kind}_{tag}'
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> list:
    """The loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted({name.split('.')[0] for name in names}
                  & set(FORBIDDEN))


def quantile(values, share: float) -> float:
    """The exact ``share`` quantile of ``values``, interpolated linearly
    between the two nearest ranks (numpy's default rule)."""
    ranked = sorted(values)
    if not ranked:
        raise ValueError('no samples')
    position = share * (len(ranked) - 1)
    low = int(position)
    high = min(low + 1, len(ranked) - 1)
    return ranked[low] + (ranked[high] - ranked[low]) * (position - low)


def merge(intervals) -> list:
    """Sorted, disjoint ``(start, end)`` intervals covering ``intervals``."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [tuple(pair) for pair in merged]


def covered(intervals, low: float, high: float) -> float:
    """The length of ``[low, high]`` that the union of ``intervals`` covers:
    overlapping intervals count once."""
    total = 0.0
    for start, end in merge(intervals):
        start, end = max(start, low), min(end, high)
        if end > start:
            total += end - start
    return total


class Spans:
    """Named intervals on the host clock (``time.perf_counter``), kept in
    memory. Under a trace each span is also a ``record_function`` range, so
    the trace's reduction can tell what the host was doing while the device
    waited."""

    def __init__(self) -> None:
        self.intervals: dict[str, list] = {}
        self.ranges = None              # torch.profiler.record_function

    @contextlib.contextmanager
    def span(self, name: str):
        marker = (self.ranges(SPAN_PREFIX + name) if self.ranges
                  else contextlib.nullcontext())
        with marker:
            started = time.perf_counter()
            try:
                yield
            finally:
                self.intervals.setdefault(name, []).append(
                    (started, time.perf_counter()))

    def seconds(self, name: str, low: float, high: float) -> float:
        """Seconds of ``[low, high]`` inside spans called ``name``."""
        return covered(self.intervals.get(name, ()), low, high)


@dataclasses.dataclass
class Trace:
    """A traced window reduced to intervals on one clock (microseconds):
    every device activity (kernels, copies, fills) and the harness's own
    host spans."""
    device: list            # [(start_us, end_us, name)]
    spans: list             # [(start_us, end_us, name)] without the prefix
    window: tuple           # (start_us, end_us)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return covered([(s, e) for s, e, _ in self.device],
                       *self.window) / 1e6

    def kernel_seconds(self, names) -> float | None:
        """Device seconds, inside the window, of the activities whose name
        holds one of ``names``; None where none ran."""
        chosen = [(s, e) for s, e, name in self.device
                  if any(part in name for part in names)]
        if not chosen:
            return None
        return covered(chosen, *self.window) / 1e6

    def device_ops(self, top: int = 10) -> list:
        totals: dict[str, float] = {}
        low, high = self.window
        for start, end, name in self.device:
            start, end = max(start, low), min(end, high)
            if end > start:
                totals[name] = totals.get(name, 0.0) + (end - start) / 1e6
        ranked = sorted(totals.items(), key=lambda item: -item[1])[:top]
        return [[name[:120], seconds] for name, seconds in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps in the device's activity inside the window,
        each named by the innermost harness span open on the host when it
        began (``idle`` where none was)."""
        low, high = self.window
        busy = merge((max(s, low), min(e, high)) for s, e, _ in self.device
                     if e > low and s < high)
        gaps, cursor = [], low
        for start, end in busy:
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if high > cursor:
            gaps.append((cursor, high))
        gaps.sort(key=lambda gap: gap[0] - gap[1])
        spans = sorted(self.spans)
        starts = [span[0] for span in spans]
        named = []
        for start, end in gaps[:top]:
            inner, name = None, 'idle'
            for span in spans[:bisect.bisect_right(starts, start)]:
                if span[1] >= start and (inner is None
                                         or span[1] - span[0] < inner):
                    inner, name = span[1] - span[0], span[2]
            named.append([name, (end - start) / 1e6])
        return named


@contextlib.contextmanager
def profiled(torch, spans: Spans, holder: dict):
    """Trace the body with ``torch.profiler`` (host and device activity);
    ``holder['profiler']`` holds the stopped profiler, for
    :func:`reduce_trace` once the run no longer waits on the clock. The
    body is expected to open the window span itself."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    spans.ranges = torch.profiler.record_function
    profiler.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        profiler.stop()
        spans.ranges = None
        holder['profiler'] = profiler


def reduce_trace(torch, profiler) -> Trace:
    """The stopped profiler's raw events as a :class:`Trace`, read without
    building the profiler's own tree of events, which takes minutes for a
    window of many steps."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for event in profiler.profiler.kineto_results.events():
        name = event.name()
        start, end = event.start_ns() / 1e3, event.end_ns() / 1e3
        if event.device_type() == cuda:
            if not name.startswith(SPAN_PREFIX):
                device.append((start, end, name))
        elif name.startswith(SPAN_PREFIX):
            if name == WINDOW_SPAN:
                window = (start, end)
            else:
                host.append((start, end, name[len(SPAN_PREFIX):]))
    if window is None:
        raise RuntimeError('the trace holds no window span')
    return Trace(device=device, spans=host, window=window)


@dataclasses.dataclass
class Run:
    """What one run measured, as the metric readers see it.

    ``counts`` holds the driver's counts over the window (steps, tokens,
    samples, requests, and the operations and bytes from ``counts/``);
    ``samples`` its lists of exact samples (times to first token, queue
    waits, step times); ``trace`` the reduced device trace of a traced
    run, else None."""
    workload: dict
    config: dict
    traffic: dict
    window: tuple               # (start, end) on the host clock
    spans: Spans
    counts: dict
    samples: dict
    peak_memory_bytes: int
    trace: Trace | None = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span_share(self, name: str) -> float | None:
        """Percent of the window inside the harness's ``name`` spans."""
        if name not in self.spans.intervals:
            return None
        return 100.0 * self.spans.seconds(name, *self.window) / self.window_s


def idle_share(run: Run) -> float | None:
    """Percent of the traced window in which no device activity ran."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def kernel_share(run: Run, names, least_seconds: float) -> float | None:
    """Percent of the named kernels' device time that their least time
    (``counts/``) is; None where the trace holds none of them."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(names)
    if not seconds:
        return None
    return 100.0 * least_seconds / seconds


def metric_entry(value: float, unit: str) -> dict:
    return {'value': value, 'unit': unit}


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` comes last."""
    line = {'correct': correct, 'attempted': attempted, 'failed': failed,
            'metrics': metrics, 'device': device}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = checks
    return json.dumps(line)


class Feed:
    """The batches a train handler iterates: a loader's, epoch after epoch,
    each ``next()`` inside a ``data_wait`` span. :meth:`take` ends after
    ``count`` batches or, with a ``deadline``, at the first ``next()`` after
    it, so the last step of a window starts before the deadline and ends
    after it."""

    def __init__(self, loader, spans: Spans) -> None:
        self.loader, self.spans = loader, spans
        self._iterator = None

    def _next(self):
        while True:
            if self._iterator is None:
                self._iterator = iter(self.loader)
            try:
                return next(self._iterator)
            except StopIteration:
                self._iterator = None

    def take(self, count: int | None = None,
             deadline: float | None = None):
        taken = 0
        while ((count is None or taken < count)
               and (deadline is None or time.perf_counter() < deadline)):
            with self.spans.span('data_wait'):
                batch = self._next()
            taken += 1
            yield batch

    def close(self) -> None:
        """Stop the loader's prefetch thread."""
        if self._iterator is not None:
            self._iterator.close()
            self._iterator = None


def median(values) -> float:
    return quantile(values, 0.5)


def _worst(program: dict, reference: dict, key: str) -> tuple:
    """``(gap, leaf)`` of the worst leaf: the gap between the program's
    norm and the reference's, over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    norms = reference[key]
    typical = median(norms.values())
    return max((abs(program[key][name] - norm) / max(norm, typical), name)
               for name, norm in norms.items())


def train_checks(program: dict, reference: dict) -> dict:
    """The three numbers a training cell compares, each a gap between the
    program's reading and the reference's over the first steps:

    * ``loss_gap``: the largest of the steps' relative loss gaps;
    * ``grad_gap``: by the worst leaf, the norms of the first gradient as
      the optimizer got it (:func:`_worst`);
    * ``change_gap``: the same of the norms of each leaf's change over the
      steps, over the leaves (or elements) the driver kept: those whose
      reference gradient is not nought to rounding.
    """
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program['losses'],
                                                          reference['losses']))
    return {'loss_gap': loss_gap,
            'grad_gap': _worst(program, reference, 'grads')[0],
            'change_gap': _worst(program, reference, 'changes')[0]}


def worst_leaves(program: dict, reference: dict) -> dict:
    """The leaves that set :func:`train_checks`' gradient and change gaps."""
    return {'grad_leaf': _worst(program, reference, 'grads')[1],
            'change_leaf': _worst(program, reference, 'changes')[1]}
