"""Acquisition functions over the hyperposterior, one batched pass each.

PyTorch counterpart of the default-path subset of
:mod:`bask_tpu.acquisition`: PVRS (the Optimizer's default) scored on the
consensus GP, and Expected Improvement marginalized over hyperposterior
draws, whose per-draw grams come from the K1 gram kernel and whose
factorizations use the K3 bases on a CUDA float32 model.
:func:`evaluate_acquisitions_fused` consumes the host RNG in the JAX
package's order, so one seed picks the same chain rows in both packages.

Not ported yet: TopTwoEI, Expectation, LCB, MaxValueSearch,
ThompsonSampling, VarianceReduction and the gradient polish.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from .models import gp as gpc
from .ops.linalg import augmented_quadform

__all__ = [
    "Acquisition",
    "UncertaintyAcquisition",
    "FullGPAcquisition",
    "ExpectedImprovement",
    "PVRS",
    "evaluate_acquisitions_fused",
]


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


class FullGPAcquisition(Acquisition, ABC):
    """Needs the full GP state (consensus model)."""

    @abstractmethod
    def __call__(self, X, gp, *args, **kwargs):
        ...


def _ei_term(z):
    return z * torch.special.ndtr(z) + torch.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


class ExpectedImprovement(UncertaintyAcquisition):
    """EI over the current minimum (default: min of mu per draw)."""

    def __call__(self, mu, std, *args, y_opt=None, **kwargs):
        if y_opt is None:
            y_opt = mu.min(dim=-1, keepdim=True).values
        ok = std > 0
        safe_std = torch.where(ok, std, 1.0)
        z = (y_opt - mu) / safe_std
        return torch.where(ok, _ei_term(z) * safe_std, 0.0)


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
    the variance explained at the probes by each candidate."""
    theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
    ts = gpc.sample_y(kernel, theta_nf, post, data, Xw, z)
    P = Xw[torch.argmin(ts, dim=0)]
    return _variance_explained_body(kernel, theta, post, data, Xw, P)


class PVRS(FullGPAcquisition):
    """Predictive variance reduction search (Nguyen et al. 2017): minimize
    the summed predictive variance at Thompson-sampled minimizers."""

    @torch.no_grad()
    def __call__(self, X, gp, *args, n_thompson=10, random_state=None, **kwargs):
        seed = gp._seed(random_state)
        Xw = gp._tensor(X)
        z = gp._normals(seed, (Xw.shape[0], int(n_thompson)))
        vals = _fused_fullgp_vals(
            gp._spec, gp._tensor(gp._theta), gp._post, gp._data, Xw, z,
            gp.white_index_,
        )
        return vals.cpu().numpy()


def _per_draw_body(rows, data, X, kernel, white_idx, n_real):
    """(S, m) predictive mean and std for each hyperposterior row: one
    batched gram (K1 on the device), one batched factorization, and the
    cross-gram solve through the cached block inverses where they exist.
    A non-PD draw gives NaN, which the caller's finite filter drops."""
    grams = gpc.fused_marginal_grams(kernel, rows, data, n_real)
    post, invs = gpc.posterior_and_invs(kernel, rows, data, Kp=grams)
    theta_nf = gpc.noise_free_theta(kernel, rows, white_idx)
    return gpc.predict(kernel, theta_nf, post, data, X, return_std=True, invs=invs)


def _fused_marginal_vals(rows, data, X, kernel, white_idx, n_real, acq, kwargs):
    """(S, m) values of an uncertainty acquisition, one row per draw."""
    mu_s, std_s = _per_draw_body(rows, data, X, kernel, white_idx, n_real)
    return acq(mu_s, std_s, **kwargs)


@torch.no_grad()
def evaluate_acquisitions_fused(X, gpr, acq, n_samples: int = 10, random_state=None, **kwargs):
    """Evaluate ONE acquisition on the candidate grid X: (1, n_candidates).

    A FullGP acquisition (PVRS) scores the consensus model; an
    uncertainty acquisition (EI) is averaged over ``n_samples`` distinct
    chain rows, with draws that give non-finite values dropped. The host
    RNG is consumed as in the JAX package: the row choice, then two
    seeds (per-draw samples, acquisition keys), which EI does not use.
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
    if not isinstance(acq, UncertaintyAcquisition):
        raise TypeError(f"unsupported acquisition {type(acq).__name__}")
    if n_samples <= 0:
        return out
    idx = rs.choice(len(gpr.chain_), replace=False, size=n_samples)
    rs.randint(0, 2**31 - 1)  # per-draw sample seed (unused by EI)
    rs.randint(0, 2**31 - 1)  # per-draw acquisition seed (unused by EI)
    vals = _fused_marginal_vals(
        gpr._tensor(gpr.chain_[idx]), gpr._data, gpr._tensor(X), gpr._spec,
        gpr.white_index_, len(gpr._y_orig), acq, kwargs,
    ).cpu().numpy()
    finite = np.all(np.isfinite(vals), axis=1)
    if finite.any():
        out[0] += vals[finite].sum(axis=0) / n_samples
    return out
