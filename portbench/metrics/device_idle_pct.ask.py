"""The share of the profiled stretch (the first asks) in which
no operation ran on the card: 100 (1 - union of device intervals / wall)."""


def read(trace):
    trace.require("pathwise_mma_kernel")
    return trace.idle_pct()
