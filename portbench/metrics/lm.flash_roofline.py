"""Attention's least time in the window (``counts/gpt2.py``: 4 x head_dim
operations a visible pair forward and 10 x head_dim backward, or its
bytes, whichever bounds) as a percent of the device time of the flash
kernels: K1 forward and K2b, the fused backward."""

from portbench.counts.peaks import least_seconds
from portbench.harness import kernel_share

KERNELS = ('flash_fwd_kernel', 'flash_bwd_fused_kernel')


def read(run):
    counts = run.counts
    least = least_seconds(counts['attention_flops'],
                          counts['attention_bytes'], 'bfloat16')
    return kernel_share(run, KERNELS, least)
