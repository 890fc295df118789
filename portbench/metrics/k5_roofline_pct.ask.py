"""K5's share of its roofline at the ask's query launches: each launch's
bound (``roofline/k5.py``, at the shape the program launched it with)
over its profiled device time, the median over the launches that add the
kernel term at the candidates (each ask launches K5 twice: f0 at the
training points, then the queries)."""

import statistics

from portbench.roofline import k5


def read(trace):
    trace.require(k5.KERNEL)
    calls, times = trace.launched("K5", profiled=True), trace.kernel_us(k5.KERNEL)
    if len(calls) != len(times):
        raise RuntimeError(f"{len(times)} profiled K5 launches for {len(calls)} noted calls")
    shares = [1e3 * k5.bound_ms(c["B"], c["m"], c["M"], c["n"], c["n_pad"], c["d"], c["R"]) / t
              for c, t in zip(calls, times) if c["query"]]
    return 100.0 * statistics.median(shares)
