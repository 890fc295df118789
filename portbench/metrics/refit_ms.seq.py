"""Milliseconds per iteration in the GP refit: the span around
``BayesGPR.sample`` inside ``tell`` (the warm chain and the consensus),
summed over the window, over its iterations."""


def read(trace):
    seconds = trace.span_seconds("span.refit")
    return None if seconds is None or not trace.units else 1e3 * seconds / trace.units
