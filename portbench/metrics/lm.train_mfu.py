"""The step's model operations (``counts/gpt2.py``: 3 x the forward) over
the window, as a percent of what the card's peak for the compute type
would do in the window's seconds."""

from portbench.counts.peaks import FLOPS_PER_S


def read(run):
    rate = run.counts['flops'] / run.window_s
    return 100.0 * rate / FLOPS_PER_S[run.counts['dtype']]
