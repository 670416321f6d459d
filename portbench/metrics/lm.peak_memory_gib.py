"""The device allocator's peak over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    return run.peak_memory_bytes / 2 ** 30
