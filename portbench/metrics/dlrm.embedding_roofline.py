"""The embedding tier's least time in the window (``counts/dlrm.py``: each
touched row read once and its gradient written once, the pooled rows and
their gradients once, over the memory's bandwidth) as a percent of the
device time of its kernels: K8 (the row gather) and K9 (the staged
products and the ordered folds)."""

from portbench.counts.peaks import HBM_BYTES_PER_S
from portbench.harness import kernel_share

KERNELS = ('gather_rows_kernel', 'stage_products_kernel',
           'segment_fold_kernel')


def read(run):
    least = run.counts['lookup_bytes'] / HBM_BYTES_PER_S
    return kernel_share(run, KERNELS, least)
