"""Functional Gaussian-process core (GPML Algorithm 2.1) on padded data.

PyTorch counterpart of :mod:`bask_tpu.models.gp`: :class:`GPData` holds
the padded, normalized training set (static shapes while the BO loop
grows ``n`` inside a padding bucket), :class:`GPPosterior` the per-theta
factor and dual coefficients. Batched hyperposterior draws are a leading
batch dimension of ``theta``, ``Kp`` and the posterior tensors (JAX's
``vmap``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.gram import fused_masked_gram_batch, fused_spec_for
from ..ops.linalg import _use_fast_path, cho_solve_masked, masked_cholesky, masked_gram
from ..utils import trace

__all__ = [
    "GPData",
    "GPPosterior",
    "make_data",
    "posterior",
    "posterior_and_invs",
    "warped_draws",
    "fused_marginal_grams",
    "log_marginal_likelihood",
    "predict",
    "sample_y",
    "eigh_draws",
    "noise_free_theta",
]


class GPData(NamedTuple):
    """Padded, normalized training data."""

    X: torch.Tensor  # (n_pad, d)
    y: torch.Tensor  # (n_pad,) normalized targets, 0 at padded entries
    alpha_diag: torch.Tensor  # (n_pad,) jitter + noise variance per point
    mask: torch.Tensor  # (n_pad,) bool, real points first
    y_mean: float
    y_std: float


class GPPosterior(NamedTuple):
    """Derived per-theta state (batched over leading dims of ``theta``)."""

    theta: torch.Tensor  # (..., n_theta)
    L: torch.Tensor  # (..., n_pad, n_pad) lower factor of the masked gram
    alpha_dual: torch.Tensor  # (..., n_pad)


def make_data(X, y, alpha_diag, mask, y_mean=0.0, y_std=1.0) -> GPData:
    with trace.wait():  # an upload waits for the stream
        mask = torch.as_tensor(mask, dtype=torch.bool, device=X.device)
    return GPData(
        X=X,
        y=torch.where(mask, y, 0.0),
        alpha_diag=alpha_diag,
        mask=mask,
        y_mean=float(y_mean),
        y_std=float(y_std),
    )


def posterior(kernel, theta, data: GPData) -> GPPosterior:
    """Factorize the training gram for one (or a batch of) theta."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    L = masked_cholesky(Kp)
    yb = data.y.expand(Kp.shape[:-1])
    return GPPosterior(theta=theta, L=L, alpha_dual=cho_solve_masked(L, yb))


def warped_draws(rows, data: GPData, n_warp: int, Xq=None):
    """Split hyperposterior rows (S, D) into kernel thetas, per-draw data
    and per-draw queries: with warping (``n_warp`` > 0) each row's warp
    parameters warp the training inputs to ``data.X`` (S, n_pad, d) and
    the queries ``Xq`` (m, d) to (S, m, d). Returns (theta, data, Xq)."""
    if not n_warp:
        return rows, data, Xq
    from .warping import split_warp_params, warp

    theta_gp, la, lb = split_warp_params(rows, n_warp)
    Xq = None if Xq is None else warp(Xq, la, lb)
    return theta_gp, data._replace(X=warp(data.X, la, lb)), Xq


def fused_marginal_grams(kernel, rows, data: GPData, n_real: Optional[int] = None):
    """(S, n_pad, n_pad) masked grams for a batch of hyperposterior rows
    from one launch of the K1 gram kernel, or ``None`` where K1 does not
    apply (:func:`bask_tpu_torch.ops.gram.fused_spec_for`). ``rows`` are
    kernel thetas; with warping, ``data`` comes from :func:`warped_draws`
    and its per-draw X (S, n_pad, d) feeds K1's per-walker mode. Assumes
    the prefix-mask padding convention (real points first)."""
    spec = fused_spec_for(kernel, data.X)
    if spec is None:
        return None
    if n_real is None:
        n_real = int(data.mask.sum())
    return fused_masked_gram_batch(spec, rows, data.X, data.alpha_diag, n_real)


def posterior_and_invs(kernel, theta, data: GPData, Kp=None):
    """Like :func:`posterior`, also returning the factor's cached
    diagonal-block inverses when the blocked path applies (float32 and a
    qualifying size under ``linalg.FAST_CHOLESKY = "auto"``, any dtype
    under "on", never under "off"), else ``None``; ``Kp`` is an optional
    precomputed masked gram."""
    from ..ops.fast_cholesky import (
        block_cholesky,
        block_solve_lower_mat,
        block_solve_upper_mat,
    )

    if Kp is None:
        Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    yb = data.y.expand(Kp.shape[:-1])
    if not _use_fast_path(Kp):
        L = masked_cholesky(Kp)
        return GPPosterior(theta, L, cho_solve_masked(L, yb)), None
    L, invs = block_cholesky(Kp)
    w = block_solve_lower_mat(L, invs, yb[..., :, None])
    alpha_dual = block_solve_upper_mat(L, invs, w)[..., 0]
    return GPPosterior(theta, L, alpha_dual), invs


def log_marginal_likelihood(kernel, theta, data: GPData):
    """LML (batched over theta); -inf where the gram is not PD."""
    from ..ops.linalg import masked_lml

    return masked_lml(kernel, theta, data.X, data.y, data.alpha_diag, data.mask)


def noise_free_theta(kernel, theta, white_index: Optional[int]):
    """theta with the WhiteKernel noise set to zero (log-space -inf)."""
    if white_index is None:
        return theta
    theta = theta.clone()
    with trace.wait():  # a Python scalar written into a device tensor: an upload
        theta[..., white_index] = -float("inf")
    return theta


def _cross(kernel, theta, Xq, data: GPData):
    """k(Xq, X_train) with padded columns zeroed: (..., m, n_pad)."""
    return kernel.eval(theta, Xq, data.X) * data.mask


def predict(
    kernel,
    theta_diag,
    post: GPPosterior,
    data: GPData,
    Xq,
    return_std=False,
    return_cov=False,
    invs=None,
):
    """Predictive mean and std (or covariance) in original y units.

    ``theta_diag`` is the theta of the prior-variance diagonal and the
    query gram (``noise_free_theta`` for epistemic uncertainty only);
    ``post`` keeps the noisy factorization. ``invs`` routes the
    cross-gram solve through the cached block inverses (matmuls).
    Differentiable in ``Xq``: the expected-minimum search descends the
    mean by autograd (JAX's ``predict_mean`` is this call's mean).
    """
    from ..ops.fast_cholesky import block_solve_lower_mat

    Ks = _cross(kernel, theta_diag, Xq, data)  # (..., m, n_pad)
    mean = data.y_mean + data.y_std * (Ks @ post.alpha_dual[..., :, None])[..., 0]
    if not (return_std or return_cov):
        return mean
    KsT = Ks.transpose(-1, -2)
    if invs is not None:
        v = block_solve_lower_mat(post.L, invs, KsT)
    else:
        v = torch.linalg.solve_triangular(post.L, KsT, upper=False)
    if return_cov:
        Kqq = kernel.eval(theta_diag, Xq)
        return mean, (Kqq - v.transpose(-1, -2) @ v) * data.y_std**2
    var = torch.clamp(kernel.diag(theta_diag, Xq) - (v * v).sum(-2), min=0.0)
    return mean, torch.sqrt(var) * data.y_std


def sample_y(kernel, theta_diag, post, data, Xq, z, invs=None):
    """Joint predictive draws (..., m, S) for standard normals ``z``
    (..., m, S)."""
    mean, cov = predict(kernel, theta_diag, post, data, Xq, return_cov=True, invs=invs)
    return eigh_draws(mean, cov, z)


def eigh_draws(mean, cov, z):
    """mean + V sqrt(max(w, 0)) z from the eigen-decomposition of
    ``cov``: exact for the rank-deficient PSD covariances of dense query
    grids, where a Cholesky would need visible jitter."""
    with trace.wait():  # eigh reads back its convergence flags
        evals, evecs = torch.linalg.eigh(cov)
    factor = evecs * torch.sqrt(torch.clamp(evals, min=0.0))[..., None, :]
    return mean[..., :, None] + factor @ z
