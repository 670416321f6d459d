"""Percent of the traced window in which the device ran nothing: one
minus the union of its activities' intervals over the window."""

from portbench.harness import idle_share


def read(run):
    return idle_share(run)
