"""The share of the profiled stretch (one round of the warped studies) in
which no operation ran on the card: 100 (1 - union of device intervals /
wall). The warped chain's grams are K1's, not K4's: nothing to read where
the program launched no K1 (an unwarped cell)."""


def read(trace):
    if not trace.launched("K1"):
        return None
    trace.require("gram_kernel", "chol_inv_kernel")
    return trace.idle_pct()
