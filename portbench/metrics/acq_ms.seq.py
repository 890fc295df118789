"""Milliseconds per iteration in the acquisition: the spans around
``Optimizer._candidate_grid`` and ``evaluate_acquisitions_fused``, summed
over the window, over its iterations."""


def read(trace):
    parts = [trace.span_seconds(s) for s in ("span.grid", "span.acquisition")]
    if any(p is None for p in parts) or not trace.units:
        return None
    return 1e3 * sum(parts) / trace.units
