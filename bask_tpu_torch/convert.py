"""Carry state of the JAX package (``bask_tpu``) into the PyTorch port.

Plain values in, port objects out; nothing here imports JAX. A kernel
spec tree of ``bask_tpu.ops.kernels`` is read by class name and field;
arrays come as NumPy. With these conversions both packages compute the
consensus, predictions and acquisition values from one fitted state.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import gp as gpc
from .models.bayesgpr import BayesGPR
from .ops import kernels as bk

__all__ = ["kernel_spec", "gp_data", "fitted_bayesgpr"]


def kernel_spec(kernel) -> bk.Kernel:
    """A ``bask_tpu.ops.kernels`` spec tree -> the port's spec (same theta
    order, values and bounds). Raises for kernels the port lacks."""
    name = type(kernel).__name__
    if name in ("Sum", "Product"):
        cls = bk.Sum if name == "Sum" else bk.Product
        return cls(kernel_spec(kernel.k1), kernel_spec(kernel.k2))
    if name == "ConstantKernel":
        return bk.ConstantKernel(kernel.constant_value, kernel.constant_value_bounds)
    if name == "WhiteKernel":
        return bk.WhiteKernel(kernel.noise_level, kernel.noise_level_bounds)
    if name == "RBF":
        return bk.RBF(kernel.length_scale, kernel.length_scale_bounds)
    if name == "Matern":
        return bk.Matern(kernel.length_scale, kernel.length_scale_bounds, nu=kernel.nu)
    raise NotImplementedError(f"kernel {name} is not ported")


def gp_data(X, y, alpha_diag, mask, y_mean=0.0, y_std=1.0, device="cpu", dtype=torch.float64):
    """Padded GPData arrays (NumPy) -> the port's :class:`GPData`."""

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return gpc.make_data(
        t(X), t(y), t(alpha_diag), np.asarray(mask, dtype=bool), y_mean, y_std
    )


def fitted_bayesgpr(
    *,
    kernel,
    theta,
    chain,
    pos,
    X,
    y,
    noise=None,
    y_mean=0.0,
    y_std=1.0,
    alpha=1e-10,
    noise_vector=None,
    device="cpu",
    dtype=torch.float64,
    random_state=None,
) -> BayesGPR:
    """A fitted JAX ``BayesGPR``'s state -> a fitted port ``BayesGPR``.

    ``kernel`` is the fitted spec (``gp._spec``, White included),
    ``theta`` the consensus, ``chain``/``pos`` the flat chain and the
    final ensemble, ``X``/``y`` the unpadded raw data with its
    normalization ``y_mean``/``y_std``, and ``noise_vector`` the
    per-point noise in normalized units (``gp._noise_vector``). The
    consensus posterior and LML are recomputed by the port.
    """
    spec = kernel_spec(kernel)
    gpr = BayesGPR(
        kernel=spec, alpha=alpha, noise=None, random_state=random_state,
        device=device, dtype=dtype,
    )
    gpr._spec = spec
    gpr.y_train_mean_ = float(y_mean)
    gpr.y_train_std_ = float(y_std)
    gpr._X_orig = np.atleast_2d(np.asarray(X, dtype=float))
    gpr._y_orig = np.asarray(y, dtype=float).ravel()
    gpr._noise_vector = None if noise_vector is None else np.asarray(noise_vector, dtype=float)
    gpr._upload()
    # copies: arrays read from JAX are read-only, and torch warns on those
    gpr.chain_ = np.array(chain, dtype=float)
    gpr.pos_ = np.array(pos, dtype=float)
    gpr.noise_ = None if noise is None else float(noise)
    gpr.theta = theta  # refreshes the consensus posterior and its LML
    gpr.log_marginal_likelihood_value_ = float(gpr._consensus_lml_)
    return gpr
