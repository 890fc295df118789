"""Plain PyTorch reference of the warped GP of ``BayesGPR(warp_inputs=True)``
(bayes-skopt, ``bask/bayesgpr.py:249-316``; Snoek et al. 2014,
arXiv:1402.0929), composed from :mod:`.gp`, :mod:`.priors` and
:mod:`.warp`.

A row of the chain is [kernel theta, log-alphas (d), log-betas (d)]: the
kernel's log-hyperparameters, then the Beta-CDF warp of each input column.
The warped model is the kernel's GP on the warped inputs; its
log-posterior adds the warp prior to the kernel prior and the LML at the
inputs warped by the row's own warp. The warp prior is bayes-skopt's
default (``bask/bayesgpr.py:462-466``), written here from its definition:
Normal(0, 0.3) on each log-alpha and log-beta, centred on the identity
warp a = b = 1. Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import gp as ref
from . import priors
from . import warp

WARP_PRIOR_SCALE = 0.3


@contextlib.contextmanager
def precision(name: str):
    """``"float64"``: no float32 matmul may run in TF32 inside the block
    (both of torch's switches off, whatever they were); ``"tf32"``:
    :func:`.gp.precision`'s control."""
    if name != "float64":
        with ref.precision(name):
            yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def split(rows, d: int):
    """(kernel theta, log-alphas, log-betas) of rows (..., n_theta + 2d)."""
    n_theta = rows.shape[-1] - 2 * d
    return rows[..., :n_theta], rows[..., n_theta : n_theta + d], rows[..., n_theta + d :]


def warp_prior(log_alphas, log_betas, scale: float = WARP_PRIOR_SCALE):
    """Summed Normal(0, ``scale``) log-density of the log-alphas and
    log-betas over the last axis."""
    const = math.log(scale) + 0.5 * math.log(2.0 * math.pi)
    z = torch.cat([log_alphas, log_betas], dim=-1) / scale
    return (-0.5 * z * z - const).sum(-1)


def log_posterior(rows, X, y, jitter, nu, d: int):
    """Kernel prior, warp prior and LML at X warped by each row's own warp,
    for each of the (W, n_theta + 2d) ``rows``: (W,)."""
    theta, la, lb = split(rows, d)
    Xw = warp.warp(X, la, lb)  # (W, n, d)
    lml = torch.stack([ref.lml(t, x, y, jitter, nu) for t, x in zip(theta, Xw)])
    return priors.log_prior(theta, d) + warp_prior(la, lb) + lml


def consensus_lml(chain, X, y, jitter, nu, d: int):
    """The LML at the geometric median of the ``chain``'s rows, with X
    warped by that median's own warp."""
    theta, la, lb = split(ref.geometric_median(chain), d)
    return ref.lml(theta, warp.warp(X, la, lb), y, jitter, nu)


def pvrs(theta, log_alphas, log_betas, X, y, jitter, nu, Xc, P):
    """PVRS (:func:`.gp.pvrs`) of the candidates ``Xc`` with X and ``Xc``
    warped by one warp; the probes ``P`` are points of the warped space."""
    return ref.pvrs(theta, warp.warp(X, log_alphas, log_betas), y, jitter, nu,
                    warp.warp(Xc, log_alphas, log_betas), P)


def unwarp_gap(x, z, log_alphas, log_betas, dtype=torch.float32):
    """How far each uniform ``z`` lies outside the Beta CDF's image of
    ``x``'s cell in ``dtype`` (x and its two neighbours there; x and z
    both (n, d)): 0 where z lies inside, so where an inverse warp returned
    the best x the type holds. Where the CDF is steep (a or b well below 1)
    a cell's image is wide, and no x of the type comes nearer to z; where
    it is flat the gap is |CDF(x) - z| less the slope times a rounding of x."""
    x_t = x.to(dtype)
    lo = torch.nextafter(x_t, torch.zeros_like(x_t)).to(x.dtype)
    hi = torch.nextafter(x_t, torch.ones_like(x_t)).to(x.dtype)
    cdf_lo = warp.warp(lo.clamp(0.0, 1.0), log_alphas, log_betas)
    cdf_hi = warp.warp(hi.clamp(0.0, 1.0), log_alphas, log_betas)
    return torch.clamp(cdf_lo - z, min=0.0) + torch.clamp(z - cdf_hi, min=0.0)
