"""Plain PyTorch reference of bayes-skopt's default hyperparameter priors
(``bask.utils.guess_priors``), on log-space theta: a half-normal of scale
2 on the square root of every variance (the amplitude and the noise),
and a round-flat density on every lengthscale, each with the change of
variables to log space. Written from those definitions; the
normalization of the round-flat density is integrated here, by SciPy's
adaptive quadrature."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# the round-flat density exp(-2 ((v / LOW)^-2a + (v / HIGH)^2b)) / Z on (0, 10)
LOW, HIGH, LOW_STEEP, HIGH_STEEP, SPAN = 0.1, 0.6, 2.0, 8.0, (0.0, 10.0)
HALFNORM_SCALE = 2.0


def _roundflat_exponent(v):
    return -2.0 * ((v / LOW) ** (-2.0 * LOW_STEEP) + (v / HIGH) ** (2.0 * HIGH_STEEP))


@functools.lru_cache(maxsize=None)
def roundflat_log_norm() -> float:
    from scipy.integrate import quad

    with np.errstate(divide="ignore", over="ignore"):
        z, _ = quad(lambda v: math.exp(_roundflat_exponent(v)) if v > 0 else 0.0, *SPAN,
                    points=(0.5 * LOW, LOW, HIGH, 1.2 * HIGH), limit=500,
                    epsabs=0.0, epsrel=1e-13)
    return math.log(z)


def variance_prior(x):
    """Log-density of log-variance ``x`` whose square root is half-normal."""
    sd = torch.exp(0.5 * x)
    return (0.5 * math.log(2.0 / math.pi) - math.log(HALFNORM_SCALE)
            - 0.5 * (sd / HALFNORM_SCALE) ** 2 + 0.5 * x - math.log(2.0))


def lengthscale_prior(x):
    """Log-density of log-lengthscale ``x`` under the round-flat density."""
    return _roundflat_exponent(torch.exp(x)) - roundflat_log_norm() + x


def log_prior(thetas, d: int):
    """Summed log-prior of (W, n_theta) thetas [log c, log l_1 .. log l_d,
    (log noise)]: (W,)."""
    lp = variance_prior(thetas[:, 0]) + lengthscale_prior(thetas[:, 1 : 1 + d]).sum(1)
    if thetas.shape[1] > 1 + d:
        lp = lp + variance_prior(thetas[:, 1 + d])
    return lp
