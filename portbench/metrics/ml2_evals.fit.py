"""Evaluations per fit of the ML-II objective (``span.gp.objective``: one
LML and its gradient on the card for SciPy's L-BFGS-B), over the profiled
fits."""

from portbench import program_spans


def read(trace):
    spans = program_spans.of(trace)
    return None if spans is None else spans.count_per_unit("span.gp.objective")
