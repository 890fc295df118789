"""Optimization result container (copy of ``create_result`` from
:mod:`bask_tpu.utils.result`, which is NumPy/SciPy only; importing it
would import the JAX package)."""

from __future__ import annotations

import numpy as np
from scipy.optimize import OptimizeResult

__all__ = ["create_result"]


def create_result(Xi, yi, space=None, rng=None, models=None) -> OptimizeResult:
    """Bundle observations + model into a scipy OptimizeResult."""
    yi = np.asarray(yi, dtype=float)
    res = OptimizeResult()
    if len(yi):
        best = int(np.argmin(yi))
        res.x = Xi[best]
        res.fun = yi[best]
    else:
        res.x, res.fun = None, None
    res.func_vals = yi
    res.x_iters = list(Xi)
    res.models = list(models) if models else []
    res.space = space
    res.random_state = rng
    res.specs = {}
    return res
