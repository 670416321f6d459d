"""The embedding tier's least time in the window (``counts/dlrm.py``, as
``dlrm.embedding_roofline`` counts it) as a percent of the device time put
down to the lookup range and its backward: the dedup's sort, the gather,
the expansion, the table gradient's fill and the folds
(``portbench/attribution.py``)."""

from portbench.attribution import roofline, with_backward
from portbench.counts.peaks import HBM_BYTES_PER_S


def read(run):
    least = run.counts['lookup_bytes'] / HBM_BYTES_PER_S
    return roofline(run, with_backward('embedding'), least)
