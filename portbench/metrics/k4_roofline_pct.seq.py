"""K4's share of its roofline at the chain's launches: its bound
(``roofline/k4.py``) at the shape the program captured into the chain's
graphs for the training bucket of the profiled stretch, over the median
device time of the profiled K4 launches, most of which are the chain's
replays (the others: one a tell at all walkers, before the chain)."""

import statistics

from portbench.roofline import k4


def read(trace):
    trace.require(k4.KERNEL, "chol_inv_kernel")
    buckets = {(x["n_pad"], x["d"]) for x in trace.launched("K4", profiled=True, captured=False)}
    shapes = {(x["B"], x["n_pad"], x["d"]) for x in trace.launched("K4", captured=True)
              if (x["n_pad"], x["d"]) in buckets}
    if len(buckets) != 1 or len(shapes) != 1:
        raise RuntimeError(f"K4's chain launches are not of one shape: buckets {buckets}, "
                           f"captured {shapes}")
    return 100.0 * k4.bound_us(*shapes.pop()) / statistics.median(trace.kernel_us(k4.KERNEL))
