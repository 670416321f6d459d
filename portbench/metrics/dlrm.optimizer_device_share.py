"""Percent of the traced window in which the device ran work put down to
the train step's optimizer range: SGD's passes over the whole tables
(``portbench/attribution.py``)."""

from portbench.attribution import share


def read(run):
    return share(run, ('train.optimizer',))
