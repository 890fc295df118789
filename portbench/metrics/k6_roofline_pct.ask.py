"""K6's share of its roofline at the warped ask's query launches: each
launch's bound (``roofline/k6.py``, at the shape the program launched it
with) over its profiled device time, the median over the float32 launches
that warp the candidate grid (each warped ask launches K6 twice: the
training points, then the grid). Nothing to read in an unwarped cell."""

import statistics

from portbench.roofline import k6


def read(trace):
    calls = trace.launched("K6", profiled=True)
    times = [b - a for name, a, b in sorted(trace.device_ops, key=lambda op: op[1])
             if k6.is_kernel(name)]
    if not calls and not times:
        return None
    if len(calls) != len(times):
        raise RuntimeError(f"{len(times)} profiled K6 launches for {len(calls)} noted calls")
    grid = trace.cfg["optimizer_kwargs"]["n_points"]
    shares = [1e3 * k6.bound_ms(c["B"], c["n"], c["d"], c["shared"], c["pdf"]) / t
              for c, t in zip(calls, times) if c["n"] == grid and c["itemsize"] == 4]
    if not shares:
        raise RuntimeError(f"no profiled float32 K6 launch over the {grid}-point grid")
    return 100.0 * statistics.median(shares)
