"""Plain PyTorch reference of what the benchmark judges.

The model is ``ConstantKernel * Matern(nu, ARD) + WhiteKernel`` with the
hyperparameters in log space, theta = [log c, log l_1 .. log l_d,
log noise]. Everything here is written from the textbook formulas, in the
dtype of its inputs: float64 for the reference, float32 with TF32
matmuls for the precision control (:func:`precision`). Nothing here
imports the program under test; the harness hands in the data it made
and the program's outputs to be judged.

Squared distances go through a matmul of points centred on their mean
(``|a|^2 + |b|^2 - 2 a.b``), the step a TF32 matmul coarsens; the
features of a pathwise draw are a matmul too.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


@contextlib.contextmanager
def precision(name: str):
    """``"float64"`` changes nothing (the inputs carry the dtype);
    ``"tf32"`` lets float32 matmuls run in TF32 for the block."""
    if name == "float64":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def dtype_of(name: str):
    return torch.float64 if name == "float64" else torch.float32


def unpack(theta, d: int):
    """(amplitude, lengthscales (d,), noise variance) of one theta."""
    amp = torch.exp(theta[0])
    ls = torch.exp(theta[1 : 1 + d])
    noise = torch.exp(theta[1 + d]) if theta.shape[0] > 1 + d else torch.zeros_like(amp)
    return amp, ls, noise


def matern(d2, nu: float):
    """Matern correlation of squared scaled distances."""
    if math.isinf(nu):
        return torch.exp(-0.5 * d2)
    r = torch.sqrt(d2)
    if nu == 0.5:
        return torch.exp(-r)
    if nu == 1.5:
        s = math.sqrt(3.0) * r
        return (1.0 + s) * torch.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * r
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"no reference Matern for nu = {nu}")


def cross(A, B, amp, ls, nu, centre):
    """amp * k(A, B) (len(A), len(B)), the noise-free cross covariance."""
    a = (A - centre) / ls
    b = (B - centre) / ls
    d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
    return amp * matern(torch.clamp(d2, min=0.0), nu)


def factor(theta, X, jitter, nu):
    """(L, amp, ls, noise): the lower Cholesky factor of the noisy gram
    k(X, X) + (noise + jitter) I."""
    amp, ls, noise = unpack(theta, X.shape[1])
    K = cross(X, X, amp, ls, nu, X.mean(0))
    K = K + (noise + jitter) * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        L = torch.full_like(K, math.nan)
    return L, amp, ls, noise


def lml(theta, X, y, jitter, nu):
    """Log marginal likelihood of (normalized) ``y`` under ``theta``."""
    L, *_ = factor(theta, X, jitter, nu)
    a = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return -0.5 * (a * a).sum() - torch.log(torch.diagonal(L)).sum() - 0.5 * X.shape[0] * LOG_2PI


def normalize(y, on: bool):
    """(normalized y, mean, std) as the model normalizes its targets."""
    y = np.asarray(y, dtype=float)
    if not on:
        return y, 0.0, 1.0
    mean, std = float(np.mean(y)), float(np.std(y)) or 1.0
    return (y - mean) / std, mean, std


def geometric_median(P, tol: float = 1e-12, max_iter: int = 5000):
    """Weiszfeld's iteration to its fixed point: the point minimizing the
    summed Euclidean distance to the rows of ``P``."""
    y = P.mean(0)
    for _ in range(max_iter):
        dist = torch.linalg.vector_norm(P - y, dim=1)
        if bool((dist == 0).any()):  # on a row: nudge off it
            dist = torch.clamp(dist, min=1e-300)
        w = 1.0 / dist
        y_new = (w @ P) / w.sum()
        step = float(torch.linalg.vector_norm(y_new - y))
        y = y_new
        if step <= tol * max(1.0, float(torch.linalg.vector_norm(y))):
            break
    return y


def pvrs(theta, X, y, jitter, nu, Xc, P):
    """Predictive variance reduction scores of candidates ``Xc`` for probe
    points ``P``: the summed posterior variance at the probes that adding
    each candidate (with its noise) explains, plus the probes' own
    explained variance."""
    L, amp, ls, noise = factor(theta, X, jitter, nu)
    centre = X.mean(0)
    A_sol = torch.linalg.solve_triangular(L, cross(X, P, amp, ls, nu, centre), upper=False)
    l_c = torch.linalg.solve_triangular(L, cross(X, Xc, amp, ls, nu, centre), upper=False)
    d = torch.sqrt(torch.clamp(amp + noise - (l_c * l_c).sum(0), min=1e-16))
    resid = cross(P, Xc, amp, ls, nu, centre) - A_sol.T @ l_c
    return (A_sol * A_sol).sum() + ((resid / d[None, :]) ** 2).sum(0)


def _norm_cdf(z):
    return 0.5 * torch.erfc(-z / math.sqrt(2.0))


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def expected_improvement(rows, X, y, y_mean, y_std, jitter, nu, Xc, extra=None):
    """EI over ``Xc`` averaged over the chain ``rows`` (each row's own
    posterior, its incumbent the least predicted mean over ``Xc``; a row
    whose values are not all finite counts as zero). With ``extra``
    (k, d), also the averaged EI at those points, against the same
    incumbents."""
    pts = Xc if extra is None else torch.cat([Xc, extra])
    total = torch.zeros(pts.shape[0], dtype=X.dtype, device=X.device)
    for theta in rows:
        L, amp, ls, _ = factor(theta, X, jitter, nu)
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        Ks = cross(pts, X, amp, ls, nu, X.mean(0))
        mean = y_mean + y_std * (Ks @ alpha)
        v = torch.linalg.solve_triangular(L, Ks.T, upper=False)
        std = torch.sqrt(torch.clamp(amp - (v * v).sum(0), min=0.0)) * y_std
        y_opt = mean[: Xc.shape[0]].min()
        ok = std > 0
        safe = torch.where(ok, std, torch.ones_like(std))
        z = (y_opt - mean) / safe
        ei = torch.where(ok, (z * _norm_cdf(z) + _norm_pdf(z)) * safe, torch.zeros_like(std))
        if bool(torch.isfinite(ei).all()):
            total = total + ei
    total = total / len(rows)
    return (total, None) if extra is None else (total[: Xc.shape[0]], total[Xc.shape[0] :])


def pathwise_draw(theta, X, y, jitter, nu, Xq, z, u, phase, w, e, chunk: int = 8192):
    """One pathwise posterior draw (Wilson et al. 2020) at ``Xq``:
    f(x) = f0(x) + k(x, X) K^-1 (y - f0(X) - eps), f0 a random-feature
    prior draw with frequencies z sqrt(2 nu / u) / l, phases ``phase`` and
    weights ``w``; eps = sqrt(noise + jitter) e. ``z`` (M, d), ``u``
    (M, 1), ``phase`` (M,), ``w`` (M,), ``e`` (n,)."""
    L, amp, ls, noise = factor(theta, X, jitter, nu)
    M = z.shape[0]
    omega = z / ls if math.isinf(nu) else z * torch.sqrt(2.0 * nu / u) / ls
    coef = torch.sqrt(2.0 * amp / M)

    def prior(Q):
        return coef * (torch.cos(Q @ omega.T + phase) @ w)

    resid = y - prior(X) - torch.sqrt(noise + jitter) * e
    V = torch.cholesky_solve(resid[:, None], L)[:, 0]
    centre = X.mean(0)
    out = [prior(Xq[lo : lo + chunk]) + cross(Xq[lo : lo + chunk], X, amp, ls, nu, centre) @ V
           for lo in range(0, Xq.shape[0], chunk)]
    return torch.cat(out)
