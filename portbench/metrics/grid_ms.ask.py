"""Milliseconds per ask in ``Optimizer._candidate_grid`` (the host's
candidate grid), summed over the window, over its asks."""


def read(trace):
    seconds = trace.span_seconds("span.grid")
    return None if seconds is None or not trace.units else 1e3 * seconds / trace.units
