"""Milliseconds per ask in ``BayesGPR.thompson_argmin_pathwise`` (the
rows' grams and factorizations, the pathwise draws and their top-k),
summed over the window, over its asks."""


def read(trace):
    seconds = trace.span_seconds("span.draws")
    return None if seconds is None or not trace.units else 1e3 * seconds / trace.units
