"""Samples of every step completed in the window over the window's
seconds (the window ends after a device synchronise)."""


def read(run):
    return run.counts['samples'] / run.window_s
