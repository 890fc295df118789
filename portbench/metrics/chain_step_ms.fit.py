"""Milliseconds per chain step of the fits: the span around
``run_ensemble`` over the steps it ran, summed over the window. Every fit
has to run exactly the mix's ``steps`` steps in one call."""


def read(trace):
    seconds = trace.span_seconds("span.chain")
    if seconds is None:
        return None
    steps, calls = trace.counts.get("chain_steps", 0), trace.spans["span.chain"][1]
    if calls != trace.units or steps != trace.mix["steps"] * calls:
        raise RuntimeError(f"{steps} chain steps in {calls} chains for {trace.units} fits, "
                           f"not {trace.mix['steps']} each")
    return 1e3 * seconds / steps
