"""Acquisition functions over the hyperposterior, one batched pass each.

PyTorch counterpart of :mod:`bask_tpu.acquisition`: the eight
acquisitions under the same ABCs, and
:func:`evaluate_acquisitions_fused`, which evaluates one of them on a
candidate grid:

* a FullGP acquisition (PVRS, the Optimizer's default, and
  VarianceReduction) scores the consensus GP, through the rank-1 border
  of its shared factor;
* an uncertainty acquisition (EI, TopTwoEI, Expectation, LCB,
  MaxValueSearch) or a sample acquisition (ThompsonSampling) is averaged
  over hyperposterior draws: one batched gram (K1 on a CUDA float32
  model), one batched factorization (K3 bases), one batched prediction.

With input warping each draw warps the training inputs and the
candidates with its own warp parameters, and the FullGP acquisitions use
the consensus warp. The host RNG is consumed in the JAX package's order,
so one seed picks the same chain rows in both packages; the randoms
themselves (Thompson normals, MES uniforms) come from torch generators
seeded from it, and the tests hand JAX's draws to the port instead.

Not ported yet: the gradient polish and the legacy multi-acquisition
``evaluate_acquisitions``.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import numpy as np
import torch

from .models import gp as gpc
from .ops.linalg import augmented_quadform

__all__ = [
    "Acquisition",
    "UncertaintyAcquisition",
    "SampleAcquisition",
    "FullGPAcquisition",
    "ExpectedImprovement",
    "TopTwoEI",
    "Expectation",
    "LCB",
    "MaxValueSearch",
    "ThompsonSampling",
    "VarianceReduction",
    "PVRS",
    "evaluate_acquisitions_fused",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Acquisition(ABC):
    @abstractmethod
    def __call__(self, *args, **kwargs):
        ...


class UncertaintyAcquisition(Acquisition, ABC):
    """Evaluated from the predictive (mu, std) of hyperposterior draws;
    leading dims of ``mu``/``std`` are draws, the last is candidates."""

    @abstractmethod
    def __call__(self, mu, std, *args, **kwargs):
        ...


class SampleAcquisition(Acquisition, ABC):
    """Evaluated from joint posterior function draws (leading dims are
    draws, the last is candidates)."""

    @abstractmethod
    def __call__(self, gp_sample, *args, **kwargs):
        ...


class FullGPAcquisition(Acquisition, ABC):
    """Needs the full GP state (consensus model)."""

    @abstractmethod
    def __call__(self, X, gp, *args, **kwargs):
        ...


def _norm_pdf(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _norm_logcdf(x):
    """log Phi(x): log(ndtr) above -10, the asymptotic log(phi(x) / -x)
    below, as in the JAX package."""
    safe = torch.special.ndtr(torch.clamp(x, min=-10.0))
    left = -0.5 * x * x - _LOG_SQRT_2PI - torch.log(-torch.clamp(x, max=-10.0))
    return torch.where(x > -10.0, torch.log(safe), left)


def _ei_term(z):
    return z * torch.special.ndtr(z) + _norm_pdf(z)


class ExpectedImprovement(UncertaintyAcquisition):
    """EI over the current minimum (default: min of mu per draw)."""

    def __call__(self, mu, std, *args, y_opt=None, **kwargs):
        if y_opt is None:
            y_opt = mu.min(dim=-1, keepdim=True).values
        ok = std > 0
        safe_std = torch.where(ok, std, 1.0)
        z = (y_opt - mu) / safe_std
        return torch.where(ok, _ei_term(z) * safe_std, 0.0)


class TopTwoEI(ExpectedImprovement):
    """EI over the point of maximal EI (top-two criterion), per draw."""

    def __call__(self, mu, std, *args, y_opt=None, **kwargs):
        ei = super().__call__(mu, std, y_opt=y_opt)
        i_best = torch.argmax(ei, dim=-1, keepdim=True)
        ok = std > 0
        outer = torch.sqrt(std**2 + std.gather(-1, i_best) ** 2)
        safe_outer = torch.where(ok, outer, 1.0)
        z = (mu.gather(-1, i_best) - mu) / safe_outer
        return torch.where(ok, safe_outer * _ei_term(z), 0.0)


class Expectation(UncertaintyAcquisition):
    """Pure exploitation: argmax of -mu."""

    def __call__(self, mu, std, *args, **kwargs):
        return -mu


class LCB(UncertaintyAcquisition):
    """Lower confidence bound; ``alpha="inf"`` is pure exploration."""

    def __call__(self, mu, std, *args, alpha=1.96, **kwargs):
        if alpha == "inf":  # exact match, as in the reference
            return std
        return alpha * std - mu


class MaxValueSearch(UncertaintyAcquisition):
    """Max-value entropy search (Wang & Jegelka 2017) with a Gumbel
    approximation of the optimum-value distribution.

    The three quantiles of the Gumbel fit come from a 72-step bisection
    (fixed, as in the JAX package), all draws and quantiles in one batch.
    ``u`` (..., n_min_samples) are the uniforms of the Gumbel draws;
    without it they are drawn from ``generator`` in [1e-12, 1).
    """

    def __call__(self, mu, std, *args, n_min_samples=1000, u=None, generator=None, **kwargs):
        if u is None:
            r = torch.rand(
                mu.shape[:-1] + (n_min_samples,), generator=generator,
                dtype=mu.dtype, device=mu.device,
            )
            u = 1e-12 + (1.0 - 1e-12) * r
        mean = -mu
        std = torch.clamp(std, min=1e-12)
        q = 0.25 * torch.arange(1, 4, dtype=mu.dtype, device=mu.device)
        lo = (mean - 3.0 * std).min(dim=-1, keepdim=True).values.expand(mean.shape[:-1] + (3,))
        hi = (mean + 5.0 * std).max(dim=-1, keepdim=True).values.expand(lo.shape)
        mean_q, std_q = mean[..., None, :], std[..., None, :]
        for _ in range(72):
            mid = 0.5 * (lo + hi)
            cdf_max = torch.exp(_norm_logcdf((mid[..., None] - mean_q) / std_q).sum(-1))
            below = cdf_max < q
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        pct = 0.5 * (lo + hi)
        q1, med, q2 = pct[..., 0:1], pct[..., 1:2], pct[..., 2:3]
        beta = (q1 - q2) / (math.log(math.log(4.0 / 3.0)) - math.log(math.log(4.0)))
        alpha = med + beta * math.log(math.log(2.0))
        max_values = -torch.log(-torch.log(u)) * beta + alpha  # (..., n_min)
        gamma = (max_values[..., None, :] - mean[..., :, None]) / std[..., :, None]
        mi = (
            gamma * _norm_pdf(gamma) / (2.0 * torch.clamp(torch.special.ndtr(gamma), min=1e-16))
            - _norm_logcdf(gamma)
        )
        return mi.mean(-1)


class ThompsonSampling(SampleAcquisition):
    """Argmax of a negated joint posterior draw."""

    def __call__(self, gp_sample, *args, **kwargs):
        return -gp_sample


def _variance_explained_body(kernel, theta, post, data, X_cand, P):
    """Total predictive variance at probe points P explained by adding
    each candidate, through the rank-1 border of the shared factor
    (:func:`bask_tpu_torch.ops.linalg.augmented_quadform`)."""
    mask = data.mask
    A = kernel.eval(theta, P, data.X) * mask[None, :]  # (m, n_pad)
    A_sol = torch.linalg.solve_triangular(post.L, A.T, upper=False)
    k_c = kernel.eval(theta, data.X, X_cand) * mask[:, None]  # (n_pad, C)
    l_cand = torch.linalg.solve_triangular(post.L, k_c, upper=False)
    k_cc = kernel.diag(theta, X_cand)
    d2 = torch.clamp(k_cc - (l_cand * l_cand).sum(0), min=1e-16)
    b = kernel.eval(theta, P, X_cand)  # (m, C)
    return augmented_quadform(post.L, l_cand, torch.sqrt(d2), A_sol, b)


def _fused_fullgp_vals(kernel, theta, post, data, Xw, z, white_idx):
    """PVRS scores: Thompson draws of the noise-free consensus GP for the
    standard normals ``z`` (C, n_thompson), their argmins as probes, then
    the variance explained at the probes by each candidate. ``z=None``
    probes the whole grid (VarianceReduction). ``data`` and the
    candidates ``Xw`` are in the consensus-warped space."""
    if z is None:
        P = Xw
    else:
        theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
        ts = gpc.sample_y(kernel, theta_nf, post, data, Xw, z)
        P = Xw[torch.argmin(ts, dim=0)]
    return _variance_explained_body(kernel, theta, post, data, Xw, P)


class VarianceReduction(FullGPAcquisition):
    """Active-learning criterion: total variance explained over the whole
    candidate grid after adding each candidate."""

    @torch.no_grad()
    def __call__(self, X, gp, *args, **kwargs):
        vals = _fused_fullgp_vals(
            gp._spec, gp._tensor(gp._theta), gp._post, gp._post_data,
            gp._warp_tensor(gp._tensor(X)), None, gp.white_index_,
        )
        return vals.cpu().numpy()


class PVRS(FullGPAcquisition):
    """Predictive variance reduction search (Nguyen et al. 2017): minimize
    the summed predictive variance at Thompson-sampled minimizers."""

    @torch.no_grad()
    def __call__(self, X, gp, *args, n_thompson=10, random_state=None, **kwargs):
        seed = gp._seed(random_state)
        Xw = gp._warp_tensor(gp._tensor(X))
        z = gp._normals(seed, (Xw.shape[0], int(n_thompson)))
        vals = _fused_fullgp_vals(
            gp._spec, gp._tensor(gp._theta), gp._post, gp._post_data, Xw, z,
            gp.white_index_,
        )
        return vals.cpu().numpy()


def _per_draw_body(rows, data, X, kernel, white_idx, n_real, n_warp=0, z=None):
    """Per hyperposterior row: one batched gram (K1 on the device), one
    batched factorization, and the cross-gram solve through the cached
    block inverses where they exist. Returns the (S, m) predictive mean
    and std, or, given standard normals ``z`` (S, m, 1), one joint draw
    per row (S, m). With warping each row warps the training inputs and
    ``X`` by its own warp. A non-PD draw gives NaN, which the caller's
    finite filter drops."""
    theta, d, Xq = gpc.warped_draws(rows, data, n_warp, X)
    grams = gpc.fused_marginal_grams(kernel, theta, d, n_real=n_real)
    post, invs = gpc.posterior_and_invs(kernel, theta, d, Kp=grams)
    theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
    if z is not None:
        return gpc.sample_y(kernel, theta_nf, post, d, Xq, z, invs=invs)[..., 0]
    return gpc.predict(kernel, theta_nf, post, d, Xq, return_std=True, invs=invs)


def _fused_marginal_vals(rows, data, X, kernel, white_idx, n_real, acq, kwargs, n_warp=0, z=None):
    """(S, m) values of an uncertainty acquisition, or of a sample
    acquisition on the draws for the normals ``z``, one row per draw."""
    if isinstance(acq, SampleAcquisition):
        draws = _per_draw_body(rows, data, X, kernel, white_idx, n_real, n_warp, z)
        return acq(draws, **kwargs)
    mu_s, std_s = _per_draw_body(rows, data, X, kernel, white_idx, n_real, n_warp)
    return acq(mu_s, std_s, **kwargs)


@torch.no_grad()
def evaluate_acquisitions_fused(X, gpr, acq, n_samples: int = 10, random_state=None, **kwargs):
    """Evaluate ONE acquisition on the candidate grid X: (1, n_candidates).

    A FullGP acquisition scores the consensus model; an uncertainty or
    sample acquisition is averaged over ``n_samples`` distinct chain rows,
    with draws that give non-finite values dropped. The host RNG is
    consumed as in the JAX package: the row choice, then a seed for the
    per-draw function samples (Thompson sampling) and a seed for the
    acquisition's own randoms (the generator MES draws from).
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    rs = (
        random_state
        if isinstance(random_state, np.random.RandomState)
        else np.random.RandomState(random_state)
    )
    out = np.zeros((1, X.shape[0]))
    if isinstance(acq, FullGPAcquisition):
        vals = acq(X, gpr, random_state=rs, **kwargs)
        if np.all(np.isfinite(vals)):
            out[0] = vals
        return out
    if not isinstance(acq, (UncertaintyAcquisition, SampleAcquisition)):
        raise TypeError(f"unsupported acquisition {type(acq).__name__}")
    if n_samples <= 0:
        return out
    idx = rs.choice(len(gpr.chain_), replace=False, size=n_samples)
    sample_seed = rs.randint(0, 2**31 - 1)
    acq_seed = rs.randint(0, 2**31 - 1)
    z = None
    if isinstance(acq, SampleAcquisition):
        z = gpr._normals(sample_seed, (n_samples, X.shape[0], 1))
    else:
        gen = torch.Generator(device=gpr.device)
        gen.manual_seed(acq_seed)
        kwargs = {"generator": gen, **kwargs}
    vals = _fused_marginal_vals(
        gpr._tensor(gpr.chain_[idx]), gpr._data, gpr._tensor(X), gpr._spec,
        gpr.white_index_, len(gpr._y_orig), acq, kwargs, gpr._n_warp(), z,
    ).cpu().numpy()
    finite = np.all(np.isfinite(vals), axis=1)
    if finite.any():
        out[0] += vals[finite].sum(axis=0) / n_samples
    return out
