"""K6 (``warp_kernel``, the Beta-CDF input warp): the least time of one
launch, frozen here from ``ops.warp_values.k6_operations`` as of PR 15.

Per output entry the function needs the clamp (2 operations) and one Beta
CDF: the 48 continued-fraction terms at 3 operations each, with their
coefficients made once per column, and 16 around them (the flip, the
front's logs and exp, the division), 160 in all; the pdf beside it adds
5. Bytes: X read once (shared, or one per warp), the B rows of d log-alphas
and d log-betas, the (B, n, d) warp (and pdf) written once. At the batch
ask's query launch ((256, 65,536, 15), X shared, float32) the float32
operations bound it: 4.08e10, 0.608 ms; the bytes 1.01 GB, 0.30 ms."""

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNEL = "warp_kernel"
CDF_OPERATIONS = 3 * 48 + 16


def is_kernel(name: str) -> bool:
    """A profiled device operation of K6 (K7 is ``unwarp_kernel``)."""
    return KERNEL in name and "unwarp_kernel" not in name


def operations(B: int, n: int, d: int, pdf: bool = False) -> float:
    return float(B) * n * d * (2 + CDF_OPERATIONS + (5 if pdf else 0))


def bytes_moved(B: int, n: int, d: int, shared: bool = True, pdf: bool = False,
                itemsize: int = 4) -> float:
    read = (1 if shared else B) * n * d + 2 * B * d
    return float(itemsize) * (read + B * n * d * (2 if pdf else 1))


def bound_ms(B: int, n: int, d: int, shared: bool = True, pdf: bool = False,
             itemsize: int = 4) -> float:
    return 1e3 * max(bytes_moved(B, n, d, shared, pdf, itemsize) / HBM_BYTES_PER_S,
                     operations(B, n, d, pdf) / FP32_FLOPS)
