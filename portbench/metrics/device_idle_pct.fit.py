"""The share of the profiled stretch (the first fit) in which
no operation ran on the card: 100 (1 - union of device intervals / wall)."""


def read(trace):
    trace.require("gram_wb_kernel", "chol_inv_kernel")
    return trace.idle_pct()
