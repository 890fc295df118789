"""Hyperparameter priors on log-space theta, and the prior-guessing logic.

PyTorch counterpart of :mod:`bask_tpu.utils.priors`: the half-normal
amplitude prior for Constant/White parameters and the round-flat
lengthscale prior, each a plain function of a log-theta tensor (any
shape, evaluated elementwise), so the batched MCMC log-probability stays
on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import kernels as bk

__all__ = [
    "make_roundflat",
    "guess_priors",
    "construct_default_kernel",
    "signal_variance_prior",
    "lengthscale_prior",
]


def _halfnorm_logpdf(x, scale):
    z = x / scale
    return (
        0.5 * math.log(2.0 / math.pi)
        - math.log(scale)
        - 0.5 * z * z
        + torch.where(x >= 0, 0.0, -math.inf)
    )


def make_roundflat(
    lower_bound: float = 0.1,
    upper_bound: float = 0.6,
    lower_steepness: float = 2.0,
    upper_steepness: float = 8.0,
    integration_bounds=(0.0, 10.0),
):
    """Log-density that is ~flat on (lower_bound, upper_bound) and drops
    steeply outside, normalized over ``integration_bounds`` with the same
    512-node Gauss-Legendre rule as the JAX package."""

    lo, hi = integration_bounds
    nodes, weights = np.polynomial.legendre.leggauss(512)
    xs = 0.5 * (hi - lo) * nodes + 0.5 * (hi + lo)
    with np.errstate(divide="ignore", over="ignore"):
        vals = np.exp(
            -2.0
            * (
                (xs / lower_bound) ** (-2.0 * lower_steepness)
                + (xs / upper_bound) ** (2.0 * upper_steepness)
            )
        )
    log_norm = math.log(float(np.sum(weights * vals) * 0.5 * (hi - lo)))

    def prior(x):
        return (
            -2.0
            * (
                (x / lower_bound) ** (-2.0 * lower_steepness)
                + (x / upper_bound) ** (2.0 * upper_steepness)
            )
            - log_norm
        )

    return prior


def signal_variance_prior(x):
    """Half-normal(scale=2) prior on the amplitude sqrt(exp(x)), with the
    log-space change of variables."""
    return (
        _halfnorm_logpdf(torch.sqrt(torch.exp(x)), 2.0)
        + x / 2.0
        - math.log(2.0)
    )


_DEFAULT_ROUNDFLAT = make_roundflat()


def lengthscale_prior(x):
    """Round-flat prior on a lengthscale given in log space."""
    return _DEFAULT_ROUNDFLAT(torch.exp(x)) + x


def guess_priors(kernel):
    """One log-prior callable per free theta entry of ``kernel``, in theta
    order: half-normal amplitude priors for Constant/White, round-flat
    for every RBF/Matern lengthscale."""
    priors = []
    for leaf in bk.iter_leaves(kernel):
        if leaf.n_theta == 0:
            continue
        if isinstance(leaf, (bk.ConstantKernel, bk.WhiteKernel)):
            priors.append(signal_variance_prior)
        elif isinstance(leaf, bk.RBF):  # Matern subclasses RBF
            priors.extend([lengthscale_prior] * leaf.n_theta)
        else:
            raise NotImplementedError(
                f"No default prior for kernel leaf {type(leaf).__name__}"
            )
    return priors


def construct_default_kernel(dimensions):
    """Default BO kernel: scaled anisotropic Matern-5/2."""
    n = len(dimensions)
    return bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * n), (0.2, 0.5), nu=2.5
    )
