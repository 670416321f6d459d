"""Process start to the first timed step: loading, weights, traffic pool,
the first steps (and, in a checkout's first run, the kernels' build)."""


def read(run):
    return run.counts['setup_s']
