"""K4 (``gram_wb_kernel``, the gram of shared X): the least time of one
launch, frozen here from ``bask_tpu_torch.ops`` as measured since PR 8.

The function's own need: X (n_pad, d), the B rows of d + 2 packed
hyperparameters and the jitter read once, the (B, n_pad, n_pad) float32
gram written once; per entry 2d operations of distance and about 12 of
the Matern, mask and diagonal. At (50, 512, 512), d = 15, the write
bounds it: 52.4 MB over 3.35 TB/s, 15.7 us."""

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNEL = "gram_wb_kernel"


def bytes_moved(B: int, n_pad: int, d: int) -> float:
    return 4.0 * (B * n_pad * n_pad + n_pad * d + B * (d + 2) + n_pad)


def operations(B: int, n_pad: int, d: int) -> float:
    return float(B) * n_pad * n_pad * (2 * d + 12)


def bound_us(B: int, n_pad: int, d: int) -> float:
    return 1e6 * max(bytes_moved(B, n_pad, d) / HBM_BYTES_PER_S,
                     operations(B, n_pad, d) / FP32_FLOPS)
