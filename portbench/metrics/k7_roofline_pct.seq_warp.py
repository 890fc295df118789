"""K7's share of its roofline at the warped loop's candidate grids: each
launch's bound (``roofline/k7.py``, at the shape and bracket the program
launched it with) over its profiled device time, the median over the
float32 launches over the grid (one a tell). Nothing to read in an
unwarped cell."""

import statistics

from portbench.roofline import k7


def read(trace):
    calls = trace.launched("K7", profiled=True)
    times = trace.kernel_us(k7.KERNEL)
    if not calls and not times:
        return None
    if len(calls) != len(times):
        raise RuntimeError(f"{len(times)} profiled K7 launches for {len(calls)} noted calls")
    grid = trace.cfg["optimizer_kwargs"]["n_points"]
    shares = [1e3 * k7.bound_ms(c["n"], c["d"], c["n_iter"]) / t
              for c, t in zip(calls, times) if c["n"] == grid and c["itemsize"] == 4]
    if not shares:
        raise RuntimeError(f"no profiled float32 K7 launch over the {grid}-point grid")
    return 100.0 * statistics.median(shares)
