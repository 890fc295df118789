"""K7 (``unwarp_kernel``, the Beta PPF, the warp's inverse): the least
time of one launch, frozen here from ``ops.warp_values.k7_operations`` as
of PR 15.

A bracket of 2^-n_iter around each root needs n_iter bisection steps, each
a Beta CDF (:data:`k6.CDF_OPERATIONS`, 160) and 3 operations (the midpoint,
the comparison, the update), after the clamp of z (2): 60 CDFs an entry at
the default n_iter of 60. Bytes: z read and x written once, the d
log-alphas and d log-betas. At the batch ask's candidate grid ((65,536,
15), float32) the operations bound it: 9.62e9, 0.144 ms."""

from .k6 import CDF_OPERATIONS
from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNEL = "unwarp_kernel"


def operations(n: int, d: int, n_iter: int = 60) -> float:
    return float(n) * d * (2 + n_iter * (CDF_OPERATIONS + 3))


def bytes_moved(n: int, d: int, itemsize: int = 4) -> float:
    return float(itemsize) * (2 * n * d + 2 * d)


def bound_ms(n: int, d: int, n_iter: int = 60, itemsize: int = 4) -> float:
    return 1e3 * max(bytes_moved(n, d, itemsize) / HBM_BYTES_PER_S,
                     operations(n, d, n_iter) / FP32_FLOPS)
