"""Percent of the traced window in which the device ran work put down to
the train step's loss range and its backward: GPT-2's chunked
cross-entropy over the float32 tied head (``portbench/attribution.py``)."""

from portbench.attribution import share, with_backward


def read(run):
    return share(run, with_backward('train.loss'))
