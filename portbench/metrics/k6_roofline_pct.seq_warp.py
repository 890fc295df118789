"""K6's share of its roofline at the warped chain's launches: its bound
(``roofline/k6.py``) at the shape the program captured into the chain's
graphs for the training bucket of the profiled stretch (each half-step
warps the shared training points by each walker's warp), over the median
device time of the profiled K6 launches, most of which are the chain's
replays (the others, each a tell: the chain's eager start at all walkers,
the consensus warp of the training points and of the candidate grid).
Nothing to read where the program launched no K6 (an unwarped cell)."""

import statistics

from portbench.roofline import k6


def read(trace):
    times = [b - a for name, a, b in sorted(trace.device_ops, key=lambda op: op[1])
             if k6.is_kernel(name)]
    if not trace.launched("K6") and not times:
        return None
    if not times:
        raise RuntimeError("the profiler recorded no K6 launch in the traced stretch")
    buckets = {x["n_pad"] for x in trace.launched("K1", profiled=True, captured=False)}
    shapes = {(x["B"], x["n"], x["d"], x["shared"], x["pdf"], x["itemsize"])
              for x in trace.launched("K6", captured=True) if x["n"] in buckets}
    if len(buckets) != 1 or len(shapes) != 1:
        raise RuntimeError(f"K6's chain launches are not of one shape: buckets {buckets}, "
                           f"captured {shapes}")
    return 100.0 * 1e3 * k6.bound_ms(*shapes.pop()) / statistics.median(times)
