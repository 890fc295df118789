"""The operation counts that define the bounds of K5, K6 and K7, and K5's
least time on one H100: the cost models that ``chip_smoke.py`` and
``scripts/warp_ab.py`` hold the kernels' timings against.

``ops/pathwise_values.py`` and ``ops/warp_values.py`` explain each count
beside the kernel it bounds. Import from the repository root as
``scripts/kernel_costs.py`` (``chip_smoke._load_script("kernel_costs")``),
or from a script beside it as ``kernel_costs``.
"""

from __future__ import annotations

from bask_tpu_torch.ops.warp_values import CF_TERMS

__all__ = ["k5_operations", "k5_operations_split", "k5_bound_ms", "CDF_OPERATIONS",
           "k6_operations", "k7_operations"]

# published dense peaks of one H100 SXM at 700 W (NVIDIA's datasheet)
_TF32_FLOPS, _F32_FLOPS, _HBM_BYTES_PER_S = 495e12, 67e12, 3.35e12


def k5_operations(B: int, m: int, n_features: int, n_points: int, d: int, r: int = 1) -> float:
    """Float32 operations of one call, the count that defines K5's bound:
    ``B m (n_features (2d + 2 + 2r) + n_points (2d + 6 + 2r))`` for ``r``
    columns and the ``n_points`` the mask keeps (0 without the cross
    term)."""
    return float(B) * m * (n_features * (2 * d + 2 + 2 * r) + n_points * (2 * d + 6 + 2 * r))


def k5_operations_split(B: int, m: int, n_features: int, n_points: int, d: int,
                        r: int = 1) -> tuple:
    """:func:`k5_operations` split by the unit that can do the work:
    ``(depth-d products, everything else)``, the products ``2d`` per pair
    (tensor cores), the rest on the FP32 pipes; they sum to
    :func:`k5_operations`."""
    products = float(B) * m * (n_features + n_points) * 2 * d
    return products, k5_operations(B, m, n_features, n_points, d, r) - products


def k5_bound_ms(B: int, m: int, n_features: int, n_points: int, d: int, r: int,
                n_bytes: float) -> tuple:
    """(the least milliseconds of one call, what bounds it): the larger
    of ``n_bytes`` over the HBM rate, the depth-d products over the TF32
    tensor-core rate and the other operations over the FP32 rate (the
    units run at once)."""
    products, other = k5_operations_split(B, m, n_features, n_points, d, r)
    t_bytes = n_bytes / _HBM_BYTES_PER_S
    t_ops = max(products / _TF32_FLOPS, other / _F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# a Beta CDF: 3 per continued-fraction term, 16 around them
CDF_OPERATIONS = 3 * CF_TERMS + 16


def k6_operations(entries: int, with_pdf: bool = False) -> float:
    """K6's operations for ``entries`` outputs: the clamp and one CDF
    each, and with the pdf its 5 (two products, two sums, the exp, on the
    CDF's logs)."""
    return float(entries) * (2 + CDF_OPERATIONS + (5 if with_pdf else 0))


def k7_operations(entries: int, steps: int) -> float:
    """K7's operations for ``entries`` outputs and ``steps`` bisection
    steps: the clamp of z, and each step a CDF and 3 (the midpoint, the
    comparison, the update)."""
    return float(entries) * (2 + steps * (CDF_OPERATIONS + 3))
