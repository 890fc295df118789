"""Modified Bessel K_nu of general real order, on torch tensors.

PyTorch counterpart of :mod:`bask_tpu.ops.bessel`, behind the general-nu
Matern kernel. The same two-regime scheme: Temme's series for x <= 2 and
Steed's continued fraction (CF2) for x > 2, on nu = mu + n with
|mu| <= 1/2, then the stable upward recurrence
K_{v+1} = K_{v-1} + (2v/x) K_v (Temme, J. Comput. Phys. 19 (1975) 324).
The order is a Python float, so its constants are Python scalars and the
recurrence unrolls.

Everything is exp-scaled (``kve(v, x) = e^x K_v(x)``, SciPy's ``kve``)
and computed in float64 whatever the input dtype, then cast back, as the
JAX package does on its float64 path; about 1e-13 relative against
``scipy.special.kve``.

Two differences from the JAX form, neither of which changes a value:
each regime runs only on the entries that take it (the JAX form
evaluates both everywhere on clamped inputs and selects), and CF2 stops
once every entry has converged. Its updates freeze per entry at
convergence in both forms, so further iterations would change nothing.
The iterations are plain differentiable torch operations, so autograd
differentiates through them, as JAX does through its loops.
"""

from __future__ import annotations

import math

import torch

__all__ = ["kve", "log_kve"]

_EULER_GAMMA = 0.5772156649015329
# odd-order Taylor coefficients of 1/Gamma(1+t) (A&S 6.1.34 c4/c6): the
# direct (1/G(1-mu) - 1/G(1+mu))/(2mu) formula cancels for tiny mu
_C4 = -0.04200263503409524
_C6 = -0.042197734555544306

_TEMME_ITERS = 64
_CF2_ITERS = 240
# CF2 checks for convergence of all entries every this many iterations
# (one host sync each)
_CF2_CHECK_EVERY = 8


def _gam12(mu: float):
    """Temme's Gamma1/Gamma2 of the fractional order |mu| <= 1/2."""
    gp = 1.0 / math.gamma(1.0 + mu)
    gm = 1.0 / math.gamma(1.0 - mu)
    if abs(mu) < 1e-2:
        gam1 = -(_EULER_GAMMA + _C4 * mu * mu + _C6 * mu**4)
    else:
        gam1 = (gm - gp) / (2.0 * mu)
    return gam1, (gm + gp) / 2.0


def _kve_temme(mu: float, x):
    """(kve_mu, kve_{mu+1}) for 0 < x <= 2, |mu| <= 1/2 (Temme series)."""
    gam1, gam2 = _gam12(mu)
    gamma_pl = math.gamma(1.0 + mu)
    gamma_mi = math.gamma(1.0 - mu)
    fact = 1.0 if mu == 0.0 else math.pi * mu / math.sin(math.pi * mu)

    d = -torch.log(0.5 * x)
    e = mu * d
    small_e = e.abs() < 1e-4
    # sinh(e)/e with a series switch at tiny e
    fact2 = torch.where(small_e, 1.0 + e * e / 6.0, torch.sinh(e) / torch.where(small_e, 1.0, e))
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ssum = ff
    # e^e = (x/2)^-mu: Temme's p0 = (x/2)^-mu Gamma(1+mu) / 2, q0 = (x/2)^mu Gamma(1-mu) / 2
    ee = torch.exp(e)
    p = 0.5 * ee * gamma_pl
    q = 0.5 / ee * gamma_mi
    c = torch.ones_like(x)
    d2 = 0.25 * x * x
    sum1 = p
    mu2 = mu * mu
    for i in range(1, _TEMME_ITERS + 1):
        ff = (i * ff + p + q) / (i * i - mu2)
        c = c * d2 / i
        p = p / (i - mu)
        q = q / (i + mu)
        ssum = ssum + c * ff
        sum1 = sum1 + c * (p - i * ff)
    scale = torch.exp(x)
    return ssum * scale, (sum1 * 2.0 / x) * scale


def _kve_cf2(mu: float, x):
    """(kve_mu, kve_{mu+1}) for x >= 2, |mu| <= 1/2 (Steed's CF2).

    Convergence-frozen updates: once |delta_s / s| is below machine
    precision an entry stops updating, which keeps its converged value
    and stops the auxiliary q-recursion from wandering. The loop ends
    when every entry has frozen, or after ``_CF2_ITERS`` iterations.
    """
    eps = 1e-16
    mu2 = mu * mu
    a1 = 0.25 - mu2

    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    q = torch.full_like(x, a1)
    c = torch.full_like(x, a1)
    a = torch.full_like(x, -a1)
    s = 1.0 + q * delh
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _CF2_ITERS + 2):
        a_n = a - 2.0 * (i - 1.0)
        c_n = -a_n * c / i
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        done_n = done | ((dels / s_n).abs() < eps)

        def keep(new, old, done=done):
            return torch.where(done, old, new)

        a, b, c, d = keep(a_n, a), keep(b_n, b), keep(c_n, c), keep(d_n, d)
        h, delh, q = keep(h_n, h), keep(delh_n, delh), keep(q_n, q)
        q1, q2, s = keep(q2, q1), keep(qnew, q2), keep(s_n, s)
        done = done_n
        if (i - 1) % _CF2_CHECK_EVERY == 0 and bool(done.all()):
            break
    h = a1 * h
    # scaled: kve_mu = sqrt(pi/(2x)) / s   (the e^-x is dropped)
    kmu = torch.sqrt(math.pi / 2.0 / x) / s
    kmu1 = kmu * (mu + x + 0.5 - h) / x
    return kmu, kmu1


def kve(nu: float, x):
    """Exponentially scaled modified Bessel K: ``e^x K_nu(x)``, x > 0.

    ``nu`` is a Python float (any real; K is even in its order). Float64
    inside; the result has the dtype of ``x``. Overflow at (tiny x, large
    nu) gives inf, which callers map to the r -> 0 kernel limit.
    """
    nu = abs(float(nu))
    n = int(nu + 0.5)
    mu = nu - n  # |mu| <= 1/2
    dt = x.dtype
    x64 = x.to(torch.float64)
    small = x64 <= 2.0
    kmu = torch.empty_like(x64)
    kmu1 = torch.empty_like(x64)
    # each regime on its own entries: index_put keeps autograd's graph
    if bool(small.any()):
        kt, kt1 = _kve_temme(mu, x64[small])
        kmu = kmu.index_put((small,), kt)
        kmu1 = kmu1.index_put((small,), kt1)
    large = ~small
    if bool(large.any()):
        kc, kc1 = _kve_cf2(mu, x64[large])
        kmu = kmu.index_put((large,), kc)
        kmu1 = kmu1.index_put((large,), kc1)
    # stable upward recurrence to order nu = mu + n
    xi2 = 2.0 / x64
    for i in range(1, n + 1):
        kmu, kmu1 = kmu1, (mu + i) * xi2 * kmu1 + kmu
    return kmu.to(dt)


def log_kve(nu: float, x):
    """log(e^x K_nu(x)); inf at the (tiny x, large nu) overflow corner."""
    return torch.log(kve(nu, x))
