"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); the
mix names its generator (``generators/<kind>.py``) and its driver
(``drivers/<kind>.py``), and ``limits/<cell>.json`` holds the limits of the
cell's correctness check. Every metric is read by ``metrics/<name>.py``.
The driver builds the program from the seed, runs its first steps (set-up),
then the measured window; with ``--trace 1`` the window runs under the
profiler and the per-layer metrics are printed instead of the end-to-end
ones. After the window the program is freed and the plain reference
(``reference/``) judges what the program produced.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each with its limit.
Without a CUDA card the run prints no result and exits with 2.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse                                     # noqa: E402
import contextlib                                   # noqa: E402
import gc                                           # noqa: E402
import math                                         # noqa: E402
import pathlib                                      # noqa: E402
import sys                                          # noqa: E402
import types                                        # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness                       # noqa: E402


def arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def cell(name: str, bench: pathlib.Path = harness.BENCH,
         root: pathlib.Path = harness.ROOT) -> types.SimpleNamespace:
    """Everything a cell names, found by name."""
    spec = harness.benchmark(root)
    workload = harness.find(spec['workloads'], name, 'workload')
    config = harness.data_file('configs', workload['config'], bench)
    traffic = harness.data_file('traffic', workload['traffic'], bench)

    def listed(metrics):
        return [metric for metric in metrics
                if name in metric.get('workloads', [name])]
    return types.SimpleNamespace(
        workload=workload, config=config, traffic=traffic,
        driver=harness.load_module('drivers', traffic['driver'], bench),
        limits=harness.data_file('limits', name, bench),
        end_to_end=listed(spec['end_to_end']),
        per_layer=listed(spec['per_layer']), bench=bench)


def card(torch, chips: int) -> str | None:
    """Why the run cannot measure, or None."""
    if not torch.cuda.is_available():
        return 'no CUDA card: the benchmark measures only on the card'
    if torch.cuda.device_count() < chips:
        return (f'the cell asks for {chips} cards, '
                f'{torch.cuda.device_count()} present')
    return None


def read_metrics(chosen, run, bench) -> dict:
    values = {}
    for metric in chosen:
        value = harness.load_module('metrics', metric['name'], bench).read(
            run)
        if value is not None:
            values[metric['name']] = harness.metric_entry(value,
                                                          metric['unit'])
    return values


def main(argv=None, *, device: str = 'cuda',
         bench: pathlib.Path = harness.BENCH,
         root: pathlib.Path = harness.ROOT) -> int:
    args = arguments(argv)
    import torch

    chosen = cell(args.workload, bench, root)
    chips = chosen.workload['chips']
    if device == 'cuda':
        reason = card(torch, chips)
        if reason:
            print(reason, file=sys.stderr)
            return 2
    spans = harness.Spans()
    ctx = types.SimpleNamespace(
        config=chosen.config, traffic=chosen.traffic, seed=args.seed,
        device=torch.device(device), spans=spans, bench=bench)
    driver = chosen.driver
    session = driver.prepare(ctx)
    prepared = time.perf_counter()
    program = driver.warm(session)
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    holder = {}
    tracing = (harness.profiled(torch, spans, holder) if args.trace
               else contextlib.nullcontext())
    with tracing:
        with spans.span('window'):
            opened = time.perf_counter()
            outcome = driver.window(session, opened + args.seconds)
            if cuda:
                torch.cuda.synchronize()
            closed = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    drain = getattr(driver, 'drain', None)
    if drain is not None:
        drain(session, outcome)
    peak = (max(setup_peak, torch.cuda.max_memory_allocated()) if cuda
            else 0)
    outcome['counts']['setup_s'] = opened - STARTED
    print(f'set-up: {prepared - STARTED:.2f} s to build the program and '
          f'its traffic, {opened - prepared:.2f} s of first steps',
          file=sys.stderr)
    trace = (harness.reduce_trace(torch, holder['profiler'])
             if args.trace else None)
    run = harness.Run(
        workload=chosen.workload, config=chosen.config,
        traffic=chosen.traffic, window=(opened, closed), spans=spans,
        counts=outcome['counts'], samples=outcome.get('samples', {}),
        peak_memory_bytes=window_peak, trace=trace)
    metrics = read_metrics(chosen.per_layer if args.trace
                           else chosen.end_to_end, run, bench)
    driver.release(session)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.reference(session, program)
    checks = {name: {'value': value, 'limit': chosen.limits[name]}
              for name, value in driver.checks(program, readings).items()}
    correct = all(math.isfinite(check['value'])
                  and check['value'] <= check['limit']
                  for check in checks.values())
    found = harness.forbidden_modules()
    if found:
        print(f'modules loaded that the benchmark forbids: {found}',
              file=sys.stderr)
        return 3
    platform = 'gpu' if cuda else device
    kind = torch.cuda.get_device_name(0) if cuda else device
    device_line = {'platform': platform, 'kind': kind, 'count': chips,
                   'memory_peak_bytes': peak}
    breakdown = None
    if run.trace is not None:
        device_line.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        breakdown = {'device_ops': run.trace.device_ops(),
                     'idle_gaps': run.trace.idle_gaps()}
    for name, check in checks.items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
        if not math.isfinite(check['value']):       # JSON has no inf or nan
            check['value'] = repr(check['value'])
    print(harness.result_line(
        correct=correct, attempted=outcome['attempted'],
        failed=outcome['failed'], metrics=metrics, device=device_line,
        checks=checks, breakdown=breakdown), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
