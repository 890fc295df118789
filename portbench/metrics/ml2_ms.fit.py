"""Milliseconds per fit in the ML-II warm start (``BayesGPR._ml2_optimize``:
SciPy's L-BFGS-B on the host, one LML and its gradient on the card per
evaluation), summed over the window, over its fits."""


def read(trace):
    seconds = trace.span_seconds("span.ml2")
    return None if seconds is None or not trace.units else 1e3 * seconds / trace.units
