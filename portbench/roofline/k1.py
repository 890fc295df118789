"""K1 (``gram_kernel``, the gram of per-walker X; K2 is the same kernel
with its ``lower`` flag, ``gram_kernel<true, ...>``): the least time of one
launch, frozen here from ``bask_tpu_torch.ops.gram``.

The function's own need, as K4's (``k4.py``) but with X read once per
walker: X (B, n_pad, d), the B rows of d + 2 packed hyperparameters and
the jitter read once, the (B, n_pad, n_pad) float32 gram written once; per
entry 2d operations of distance and about 12 of the Matern, mask and
diagonal. At a warped chain's half-step (50, 512, 512), d = 15, the write
bounds it: 54.0 MB over 3.35 TB/s, 16.1 us."""

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNEL = "gram_kernel"


def is_kernel(name: str) -> bool:
    """A profiled device operation of K1 (not K2, not K4's ``gram_wb_kernel``)."""
    return KERNEL in name and "gram_kernel<true" not in name


def bytes_moved(B: int, n_pad: int, d: int, per_walker: bool = True) -> float:
    return 4.0 * (B * n_pad * n_pad + (B if per_walker else 1) * n_pad * d + B * (d + 2) + n_pad)


def operations(B: int, n_pad: int, d: int) -> float:
    return float(B) * n_pad * n_pad * (2 * d + 12)


def bound_us(B: int, n_pad: int, d: int, per_walker: bool = True) -> float:
    return 1e6 * max(bytes_moved(B, n_pad, d, per_walker) / HBM_BYTES_PER_S,
                     operations(B, n_pad, d) / FP32_FLOPS)
