"""K5 (``pathwise_mma_kernel``, the pathwise draws' values): the least
time of one launch, frozen here from ``ops.pathwise_values.k5_operations``
and ``chip_smoke.k5_costs`` as of PR 11.

For B draws of R columns at m queries, with M features and n real
training points in d dimensions, the function needs
B m (M (2d + 2 + 2R) + n (2d + 6 + 2R)) operations, of which the depth-d
products, 2d for each (query, feature) and (query, point) pair, can run on
the tensor cores (TF32) and the rest on the float32 pipes, the two units
at once. At the batch ask's query launch (256 x 65,536, M 1,024, n 1,000,
d 15, R 1) the float32 part bounds it: 2.03e11 operations, 3.03 ms."""

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS

KERNEL = "pathwise_mma_kernel"


def operations(B: int, m: int, M: int, n: int, d: int, R: int = 1) -> float:
    return float(B) * m * (M * (2 * d + 2 + 2 * R) + n * (2 * d + 6 + 2 * R))


def tensor_core_operations(B: int, m: int, M: int, n: int, d: int) -> float:
    return float(B) * m * (M + n) * 2 * d


def bytes_moved(B: int, m: int, M: int, n_pad: int, d: int, R: int = 1) -> float:
    """The queries, frequencies, phases, weights, the training points, the
    scales and the solved residuals read once; the values written once
    (float32)."""
    read = m * d + B * M * d + B * M + B * M * R + B + n_pad * d + B * d + B * n_pad * R + B
    return 4.0 * (read + B * m * R)


def bound_ms(B: int, m: int, M: int, n: int, n_pad: int, d: int, R: int = 1) -> float:
    products = tensor_core_operations(B, m, M, n, d)
    other = operations(B, m, M, n, d, R) - products
    return 1e3 * max(bytes_moved(B, m, M, n_pad, d, R) / HBM_BYTES_PER_S,
                     products / TF32_FLOPS, other / FP32_FLOPS)
