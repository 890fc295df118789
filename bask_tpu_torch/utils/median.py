"""Geometric median (Weiszfeld with the Vardi-Zhang correction).

PyTorch counterpart of :mod:`bask_tpu.utils.median`. The JAX package
runs a ``while_loop`` until the step drops below ``eps``; here every
iteration is branchless on the device and a converged iterate is frozen
with ``torch.where``, so the result equals the early-stopping loop. The
host looks at the stop flag only every ``_CHECK_EVERY`` iterations, to
keep device-to-host syncs out of the loop body.
"""

from __future__ import annotations

import math

import torch

__all__ = ["geometric_median"]

_CHECK_EVERY = 25


def geometric_median(X, eps: float = 1e-5, max_iter: int = 200):
    """Point minimizing the sum of Euclidean distances to the rows of X:
    (n, d) -> (d,)."""
    n = X.shape[0]
    y = X.mean(dim=0)
    delta = torch.full((), math.inf, dtype=X.dtype, device=X.device)
    for it in range(max_iter):
        if it and it % _CHECK_EVERY == 0 and not bool(delta >= eps):
            break
        d = torch.linalg.vector_norm(X - y[None, :], dim=1)
        nonzero = d > 0.0
        dinv = torch.where(nonzero, 1.0 / torch.where(nonzero, d, 1.0), 0.0)
        dinv_sum = dinv.sum()
        T = (dinv @ X) / dinv_sum
        num_zeros = n - nonzero.sum()
        R = (T - y) * dinv_sum
        r = torch.linalg.vector_norm(R)
        rinv = torch.where(r > 0, num_zeros / torch.where(r > 0, r, 1.0), 0.0)
        y_vz = (
            torch.clamp(1.0 - rinv, min=0.0) * T
            + torch.clamp(rinv, max=1.0) * y
        )
        y1 = torch.where(num_zeros == 0, T, y_vz)
        y1 = torch.where(num_zeros == n, y, y1)
        active = delta >= eps
        delta = torch.where(active, torch.linalg.vector_norm(y1 - y), delta)
        y = torch.where(active, y1, y)
    return y
