"""Percent of the window the train handler waited in ``next()`` on the
loader's batches (the harness's ``data_wait`` spans)."""


def read(run):
    return run.span_share('data_wait')
