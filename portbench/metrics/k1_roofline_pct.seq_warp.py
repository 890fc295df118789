"""K1's share of its roofline at the warped chain's launches: its bound
(``roofline/k1.py``, per-walker X) at the shape the program captured into
the chain's graphs for the training bucket of the profiled stretch, over
the median device time of the profiled K1 launches, most of which are the
chain's replays (the others: one a tell at all walkers, the chain's eager
start). Nothing to read where the program launched no K1 (an unwarped
chain's grams are K4's)."""

import statistics

from portbench.roofline import k1


def read(trace):
    times = [b - a for name, a, b in sorted(trace.device_ops, key=lambda op: op[1])
             if k1.is_kernel(name)]
    if not trace.launched("K1") and not times:
        return None
    trace.require("chol_inv_kernel")
    if not times:
        raise RuntimeError("the profiler recorded no K1 launch in the traced stretch")
    buckets = {(x["n_pad"], x["d"]) for x in trace.launched("K1", profiled=True, captured=False)}
    shapes = {(x["B"], x["n_pad"], x["d"], x["per_walker"])
              for x in trace.launched("K1", captured=True) if (x["n_pad"], x["d"]) in buckets}
    if len(buckets) != 1 or len(shapes) != 1:
        raise RuntimeError(f"K1's chain launches are not of one shape: buckets {buckets}, "
                           f"captured {shapes}")
    return 100.0 * k1.bound_us(*shapes.pop()) / statistics.median(times)
