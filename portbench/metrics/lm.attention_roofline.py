"""Attention's least time in the window (``counts/gpt2.py``, as
``lm.flash_roofline`` counts it) as a percent of the device time put down
to the attention range and its backward, whatever kernels ran there
(``portbench/attribution.py``)."""

from portbench.attribution import roofline, with_backward
from portbench.counts.peaks import least_seconds


def read(run):
    counts = run.counts
    least = least_seconds(counts['attention_flops'],
                          counts['attention_bytes'], 'bfloat16')
    return roofline(run, with_backward('attention'), least)
