"""Device activities (kernels, copies, fills) in the traced window put down
to the train step's ranges and the layers' ranges, with their backward,
over the window's steps (``portbench/attribution.py``)."""

from portbench.attribution import STEP_RANGES, of, with_backward


def read(run):
    attribution = of(run)
    if attribution is None or not run.counts['steps']:
        return None
    launches = attribution.count(with_backward(*STEP_RANGES))
    return launches / run.counts['steps'] if launches else None
