"""Distribution helpers: torch densities for priors and acquisitions, and
the highest-density interval of the stopping diagnostics.

PyTorch counterpart of :mod:`bask_tpu.utils.stats`. The densities are
torch functions of tensors; :func:`hdi` and its helpers are host NumPy,
copied from the JAX package (they never touched JAX there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "norm_logpdf",
    "norm_pdf",
    "norm_cdf",
    "norm_logcdf",
    "halfnorm_logpdf",
    "invgamma_logpdf",
    "hdi",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_SQRT_HALF = math.sqrt(0.5)


def norm_logpdf(x, loc=0.0, scale=1.0):
    """log N(x; loc, scale^2), elementwise; ``scale`` a float or tensor.
    A float scale stays on the host: copying it to the card would make
    the host wait for the device on every call."""
    z = (x - loc) / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z * z - _LOG_SQRT_2PI - log_scale


def norm_pdf(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def norm_cdf(x):
    """Phi(x) as erfc(-x / sqrt 2) / 2, accurate in the left tail, as
    JAX's and scipy's ndtr are: ``torch.special.ndtr`` computes
    (1 + erf) / 2 there and is 0 below x = -8.3 in float64 and below
    x = -5.4 in float32, which made log Phi -inf."""
    return 0.5 * torch.special.erfc(-x * _SQRT_HALF)


def norm_logcdf(x):
    """log Phi(x): log(Phi) above -10, the asymptotic log(phi(x) / -x)
    below."""
    safe = norm_cdf(torch.clamp(x, min=-10.0))
    left = -0.5 * x * x - _LOG_SQRT_2PI - torch.log(-torch.clamp(x, max=-10.0))
    return torch.where(x > -10.0, torch.log(safe), left)


def halfnorm_logpdf(x, scale=1.0):
    """log pdf of |N(0, scale^2)| at x >= 0 (-inf below 0)."""
    z = x / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return (
        0.5 * math.log(2.0 / math.pi) - log_scale - 0.5 * z * z
        + torch.where(x >= 0, 0.0, -math.inf)
    )


def invgamma_logpdf(x, a, scale=1.0):
    """log pdf of the inverse-gamma distribution (-inf at x <= 0)."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return (
        a * torch.log(scale) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - scale / x
        + torch.where(x > 0, 0.0, -math.inf)
    )


# ---------------------------------------------------------------------------
# Highest-density intervals (host NumPy; replaces arviz.hdi)
# ---------------------------------------------------------------------------


def _hdi_unimodal(samples: np.ndarray, hdi_prob: float) -> np.ndarray:
    x = np.sort(samples)
    n = len(x)
    k = max(int(np.floor(hdi_prob * n)), 1)
    if k >= n:
        return np.array([x[0], x[-1]])
    widths = x[k:] - np.asarray(x[: n - k])
    i = int(np.argmin(widths))
    return np.array([x[i], x[i + k]])


def _silverman_bw(x: np.ndarray) -> float:
    n = len(x)
    s = np.std(x)
    iqr = np.subtract(*np.percentile(x, [75, 25])) / 1.34
    a = min(s, iqr) if iqr > 0 else s
    # floor the bandwidth: optimum samples often sit on a finite candidate
    # grid, where many coincident values would otherwise collapse the KDE
    span = np.ptp(x)
    floor = max(span * 1e-3, 1e-9)
    return max(0.9 * a * n ** (-0.2), floor)


def _hdi_multimodal(samples: np.ndarray, hdi_prob: float, n_grid: int = 1024) -> np.ndarray:
    """KDE-based multimodal HDI: the density super-level set covering
    ``hdi_prob`` of the mass, reported as a list of intervals."""
    x = np.asarray(samples, dtype=float)
    bw = _silverman_bw(x)
    lo, hi = x.min() - 3 * bw, x.max() + 3 * bw
    grid = np.linspace(lo, hi, n_grid)
    dens = np.exp(-0.5 * ((grid[:, None] - x[None, :]) / bw) ** 2).sum(axis=1) / (
        len(x) * bw * math.sqrt(2 * math.pi)
    )
    dens_n = dens / dens.sum()
    order = np.argsort(dens_n)[::-1]
    csum = np.cumsum(dens_n[order])
    cutoff_idx = np.searchsorted(csum, hdi_prob)
    level = dens_n[order[min(cutoff_idx, n_grid - 1)]]
    above = dens_n >= level
    intervals = []
    start = None
    for i, flag in enumerate(above):
        if flag and start is None:
            start = i
        elif not flag and start is not None:
            intervals.append([grid[start], grid[i - 1]])
            start = None
    if start is not None:
        intervals.append([grid[start], grid[-1]])
    return np.array(intervals)


def hdi(samples, hdi_prob: float = 0.95, multimodal: bool = True):
    """Highest-density interval(s) of 1-D samples: shape (n_modes, 2)
    when ``multimodal``, else (2,)."""
    samples = np.asarray(samples, dtype=float).ravel()
    if multimodal:
        return _hdi_multimodal(samples, hdi_prob)
    return _hdi_unimodal(samples, hdi_prob)
