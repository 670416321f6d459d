"""The steps' least time (``counts/dlrm.py``: the larger of the model's
operations over the compute type's peak and its least bytes, the touched
table rows read and written once, over the memory's bandwidth) as a
percent of the window's seconds."""

from portbench.counts.peaks import least_seconds


def read(run):
    counts = run.counts
    least = least_seconds(counts['flops'], counts['bytes'], counts['dtype'])
    return 100.0 * least / run.window_s
