"""Lift frozen ``scipy.stats`` log-densities into torch code.

PyTorch counterpart of the exact lift in :mod:`bask_tpu.utils.scipy_lift`.
Reference users build hyperparameter priors from ``scipy.stats`` (e.g.
``priors=[halfnorm(scale=2).logpdf, ...]``). A SciPy callable cannot take
a CUDA tensor, and on a CPU tensor it returns a NumPy array, so the chain
would have to copy theta to the host at every log-probability. This
module recognizes the case where the prior *is* a frozen distribution's
``logpdf``/``pdf`` bound method (or the family's, with default
loc/scale) and returns the same density written in torch, so it runs on
the tensor's device.

Every lift is checked against the SciPy callable at probe points inside
the support, through a NumPy instantiation of the same formula, before it
is trusted; an unknown family, array-valued parameters or a mismatch
return ``None`` and the caller falls back to a host adapter. Outside the
support the lift is ``-inf`` as in SciPy; on a closed boundary point the
two may differ (a set of measure zero).

:func:`tabulate_prior` is the approximate way for any other scalar
callable (``BayesGPR(host_prior_mode="interp")``): a table of its values
on the device, interpolated linearly, so that the chain needs no host
adapter (and can be captured in a CUDA graph).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import betaln as _h_betaln
from scipy.special import gammaln as _h_gammaln

__all__ = ["lift_scipy_prior", "tabulate_prior"]

_SQRT2PI_LOG = 0.5 * math.log(2.0 * math.pi)


class _TorchNS:
    """The few NumPy names the density builders use, on torch tensors."""

    inf = math.inf

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    log = staticmethod(torch.log)
    log1p = staticmethod(torch.log1p)
    exp = staticmethod(torch.exp)
    abs = staticmethod(torch.abs)


def _norm(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        return -0.5 * y * y - _SQRT2PI_LOG - math.log(scale)

    return logpdf


def _halfnorm(shapes, loc, scale, xp):
    const = 0.5 * math.log(2.0 / math.pi) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        return xp.where(y >= 0, const - 0.5 * y * y, -xp.inf)

    return logpdf


def _uniform(shapes, loc, scale, xp):
    def logpdf(x):
        inside = (x >= loc) & (x <= loc + scale)
        return xp.where(inside, -math.log(scale) + 0.0 * x, -xp.inf)

    return logpdf


def _expon(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        return xp.where(y >= 0, -y - math.log(scale), -xp.inf)

    return logpdf


def _gamma(shapes, loc, scale, xp):
    (a,) = shapes
    const = -float(_h_gammaln(a)) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = (a - 1.0) * xp.log(ysafe) - ysafe + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _invgamma(shapes, loc, scale, xp):
    (a,) = shapes
    const = -float(_h_gammaln(a)) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = -(a + 1.0) * xp.log(ysafe) - 1.0 / ysafe + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _lognorm(shapes, loc, scale, xp):
    (s,) = shapes
    const = -math.log(s) - _SQRT2PI_LOG - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        ly = xp.log(ysafe)
        val = -ly * ly / (2.0 * s * s) - ly + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _beta(shapes, loc, scale, xp):
    a, b = shapes
    const = -float(_h_betaln(a, b)) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        inside = (y > 0) & (y < 1)
        ysafe = xp.where(inside, y, 0.5)
        val = (a - 1.0) * xp.log(ysafe) + (b - 1.0) * xp.log1p(-ysafe) + const
        return xp.where(inside, val, -xp.inf)

    return logpdf


def _cauchy(shapes, loc, scale, xp):
    const = -math.log(math.pi) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        return -xp.log1p(y * y) + const

    return logpdf


def _laplace(shapes, loc, scale, xp):
    const = -math.log(2.0) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        return -xp.abs(y) + const

    return logpdf


def _logistic(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        ay = xp.abs(y)
        return -ay - 2.0 * xp.log1p(xp.exp(-ay)) - math.log(scale)

    return logpdf


def _t(shapes, loc, scale, xp):
    (df,) = shapes
    const = (
        float(_h_gammaln(0.5 * (df + 1.0)) - _h_gammaln(0.5 * df))
        - 0.5 * math.log(df * math.pi)
        - math.log(scale)
    )

    def logpdf(x):
        y = (x - loc) / scale
        return const - 0.5 * (df + 1.0) * xp.log1p(y * y / df)

    return logpdf


def _chi2(shapes, loc, scale, xp):
    (df,) = shapes
    const = -float(_h_gammaln(0.5 * df)) - 0.5 * df * math.log(2.0) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = (0.5 * df - 1.0) * xp.log(ysafe) - 0.5 * ysafe + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _rayleigh(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = xp.log(ysafe) - 0.5 * ysafe * ysafe - math.log(scale)
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _gumbel_r(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        return -y - xp.exp(-y) - math.log(scale)

    return logpdf


def _weibull_min(shapes, loc, scale, xp):
    (c,) = shapes
    const = math.log(c) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = const + (c - 1.0) * xp.log(ysafe) - ysafe**c
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _pareto(shapes, loc, scale, xp):
    (b,) = shapes
    const = math.log(b) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y >= 1, y, 1.0)
        val = const - (b + 1.0) * xp.log(ysafe)
        return xp.where(y >= 1, val, -xp.inf)

    return logpdf


# Probe positions, as multiples of scale offset from loc: inside
# (loc, loc + scale) for every family but pareto, whose support starts at
# loc + scale (probing -inf against -inf verifies nothing).
_DEFAULT_PROBES = (0.2, 0.5, 0.8)

# family -> (builder, number of shape parameters, probe multipliers)
_FAMILIES = {
    "norm": (_norm, 0, _DEFAULT_PROBES),
    "halfnorm": (_halfnorm, 0, _DEFAULT_PROBES),
    "uniform": (_uniform, 0, _DEFAULT_PROBES),
    "expon": (_expon, 0, _DEFAULT_PROBES),
    "gamma": (_gamma, 1, _DEFAULT_PROBES),
    "invgamma": (_invgamma, 1, _DEFAULT_PROBES),
    "lognorm": (_lognorm, 1, _DEFAULT_PROBES),
    "beta": (_beta, 2, _DEFAULT_PROBES),
    "cauchy": (_cauchy, 0, _DEFAULT_PROBES),
    "laplace": (_laplace, 0, _DEFAULT_PROBES),
    "logistic": (_logistic, 0, _DEFAULT_PROBES),
    "t": (_t, 1, _DEFAULT_PROBES),
    "chi2": (_chi2, 1, _DEFAULT_PROBES),
    "rayleigh": (_rayleigh, 0, _DEFAULT_PROBES),
    "gumbel_r": (_gumbel_r, 0, _DEFAULT_PROBES),
    "weibull_min": (_weibull_min, 1, _DEFAULT_PROBES),
    "pareto": (_pareto, 1, (1.2, 1.7, 2.5)),
}


def _resolve_dist(p):
    """``(family, shapes, loc, scale, scipy_logpdf)`` for a recognized
    bound method, else ``None``."""
    name = getattr(p, "__name__", None)
    owner = getattr(p, "__self__", None)
    if owner is None or name not in ("logpdf", "pdf"):
        return None
    from scipy.stats._distn_infrastructure import rv_continuous, rv_continuous_frozen

    if isinstance(owner, rv_continuous_frozen):
        dist, args, kwds = owner.dist, owner.args, owner.kwds
    elif isinstance(owner, rv_continuous):
        dist, args, kwds = owner, (), {}
    else:
        return None
    family = getattr(dist, "name", None)
    if family not in _FAMILIES:
        return None
    try:
        shapes, loc, scale = dist._parse_args(*args, **kwds)
        shapes = tuple(float(s) for s in shapes)
        loc, scale = float(loc), float(scale)
    except (TypeError, ValueError):
        return None  # array-valued parameters: elementwise priors are scalar
    if not (scale > 0.0 and np.isfinite(loc) and np.isfinite(scale)):
        return None
    if not all(np.isfinite(s) for s in shapes):
        return None
    return family, shapes, loc, scale, owner.logpdf


def lift_scipy_prior(p):
    """A torch log-density equal to ``p``, or ``None``.

    ``p`` must be the ``logpdf`` (or ``pdf``) bound method of a frozen
    ``scipy.stats`` continuous distribution of a supported family. The
    result takes a tensor of any shape and device and is elementwise.
    """
    resolved = _resolve_dist(p)
    if resolved is None:
        return None
    family, shapes, loc, scale, ref_logpdf = resolved
    builder, n_shapes, mults = _FAMILIES[family]
    if len(shapes) != n_shapes:
        return None
    probes = np.asarray([loc + t * scale for t in mults])
    try:
        got = np.asarray(builder(shapes, loc, scale, np)(probes), dtype=np.float64)
        want = np.asarray(ref_logpdf(probes), dtype=np.float64)
    except (ValueError, ArithmeticError):  # shape parameters outside the family's domain
        return None
    if got.shape != want.shape or not np.allclose(got, want, rtol=1e-10, atol=1e-12):
        return None

    logpdf = builder(shapes, loc, scale, _TorchNS)
    if p.__name__ == "pdf":

        def lifted(x):
            return torch.exp(logpdf(x))

    else:
        lifted = logpdf
    lifted.__wrapped_scipy__ = (family, shapes, loc, scale, p.__name__)
    return lifted


# Log-densities below this are "effectively rejected" anyway (exp
# underflows long before); flooring -inf/NaN knots here keeps the
# interpolation finite while preserving MCMC rejection behavior (the JAX
# package's value).
_TABLE_FLOOR = -1e12


class _TabulatedPrior:
    """The piecewise-linear interpolant of :func:`tabulate_prior`: the
    float64 knot values, placed on a device in a dtype at first use there
    (:meth:`table`), or ahead of it by the model that resolves the prior,
    so that no host-to-device copy happens in a chain step."""

    def __init__(self, vals, lo, hi, n_knots, max_err):
        self.vals = vals
        self.lo, self.h, self.n_knots = lo, (hi - lo) / (n_knots - 1), n_knots
        self.__tabulated__ = (lo, hi, n_knots, max_err)
        self._tables = {}

    def table(self, device, dtype):
        key = (torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(self.vals, dtype=dtype, device=device)
        return self._tables[key]

    def __call__(self, x):
        dtype = x.dtype if x.is_floating_point() else torch.float32
        table = self.table(x.device, torch.promote_types(dtype, torch.float32))
        t = (x - self.lo) / self.h
        i = torch.clamp(torch.floor(t), 0, self.n_knots - 2)
        frac = t - i  # unbounded beyond the range: edge-slope extrapolation
        i = i.long()
        v0 = table[i]
        return v0 + frac * (table[i + 1] - v0)


def tabulate_prior(p, lo, hi, n_knots=16385):
    """Approximate an opaque scalar log-density by interpolation on the
    device.

    Samples ``p`` on the host over ``n_knots`` equispaced points of
    ``[lo, hi]`` and returns ``(interp, max_err)``: a torch function,
    piecewise linear between the knots and extrapolated linearly beyond
    the range with the edge segments' slopes, and the measured max absolute
    log-density error against ``p`` at segment midpoints (a subsample of
    512). ``-inf``/NaN knots are floored to a very negative finite value so
    the interpolation stays finite (the chain still rejects there).
    The JAX package's table, floor, error and extrapolation; approximate
    by construction, so opt in via ``BayesGPR(host_prior_mode="interp")``.
    """
    lo, hi = float(lo), float(hi)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(
            f"tabulate_prior needs finite bounds, got [{lo}, {hi}]: "
            "infinite kernel bounds (e.g. fixed-less parameters) must be "
            "clamped by the caller"
        )
    if not (hi > lo) or n_knots < 3:
        raise ValueError("tabulate_prior needs hi > lo and n_knots >= 3")
    xs = np.linspace(lo, hi, n_knots)
    vec = np.vectorize(p, otypes=[np.float64])
    vals = vec(xs)
    vals = np.where(np.isnan(vals), -np.inf, vals)
    vals = np.maximum(vals, _TABLE_FLOOR)
    h = (hi - lo) / (n_knots - 1)

    # measured error at a midpoint subsample (the worst case for
    # piecewise-linear interpolation of a smooth function)
    mid_idx = np.linspace(0, n_knots - 2, min(512, n_knots - 1)).astype(int)
    mids = xs[mid_idx] + 0.5 * h
    exact = vec(mids)
    exact = np.maximum(np.where(np.isnan(exact), -np.inf, exact), _TABLE_FLOOR)
    approx = 0.5 * (vals[mid_idx] + vals[mid_idx + 1])
    finite = np.isfinite(exact) & (exact > _TABLE_FLOOR / 2)
    max_err = float(np.max(np.abs(approx[finite] - exact[finite]))) if finite.any() else 0.0
    return _TabulatedPrior(vals, lo, hi, n_knots, max_err), max_err
