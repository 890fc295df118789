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

:func:`evaluate_acquisitions` is the legacy dispatcher of several
acquisitions at once; for one acquisition it computes what
:func:`evaluate_acquisitions_fused` does, bit for bit. It serves the
acquisitions the fused pass returns ``None`` for (a custom class that is
neither FullGP, uncertainty nor sample acquisition).

:func:`polish_acquisition` refines the grid argmax by a few Adam steps on
the acquisition surface from the top grid points: the per-draw grams
(K1) and factors (K3 bases) are computed once under ``torch.no_grad()``
and enter as constants; autograd differentiates the predictions in the
candidate points only.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import numpy as np
import torch

from .models import gp as gpc
from .ops.linalg import augmented_quadform
from .utils import trace
from .utils.stats import norm_cdf, norm_logcdf, norm_pdf

# "on" routes a tell's single acquisition through
# :func:`evaluate_acquisitions_fused`; anything else makes it return
# ``None``, so the Optimizer takes the legacy dispatcher, as in the JAX
# package (whose tests pin the two routes equal)
FUSED_ACQUISITION = "on"

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
    "evaluate_acquisitions",
    "evaluate_acquisitions_fused",
    "polish_acquisition",
    "polish_noop_reason",
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


def _ei_term(z):
    return z * norm_cdf(z) + norm_pdf(z)


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
            cdf_max = torch.exp(norm_logcdf((mid[..., None] - mean_q) / std_q).sum(-1))
            below = cdf_max < q
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        pct = 0.5 * (lo + hi)
        q1, med, q2 = pct[..., 0:1], pct[..., 1:2], pct[..., 2:3]
        beta = (q1 - q2) / (math.log(math.log(4.0 / 3.0)) - math.log(math.log(4.0)))
        alpha = med + beta * math.log(math.log(2.0))
        max_values = -torch.log(-torch.log(u)) * beta + alpha  # (..., n_min)
        gamma = (max_values[..., None, :] - mean[..., :, None]) / std[..., :, None]
        mi = (
            gamma * norm_pdf(gamma) / (2.0 * torch.clamp(norm_cdf(gamma), min=1e-16))
            - norm_logcdf(gamma)
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
    P = _thompson_probes(kernel, theta, post, data, Xw, z, white_idx)
    return _variance_explained_body(kernel, theta, post, data, Xw, P)


def _thompson_probes(kernel, theta, post, data, Xw, z, white_idx):
    """PVRS's probes: the argmins over ``Xw`` of the noise-free consensus
    GP's draws for the normals ``z`` (len(Xw), n_thompson); ``Xw``
    itself for ``z=None`` (VarianceReduction)."""
    if z is None:
        return Xw
    with trace.span("span.acq.probes"):
        theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
        ts = gpc.sample_y(kernel, theta_nf, post, data, Xw, z)
        return Xw[torch.argmin(ts, dim=0)]


class VarianceReduction(FullGPAcquisition):
    """Active-learning criterion: total variance explained over the whole
    candidate grid after adding each candidate."""

    @torch.no_grad()
    def __call__(self, X, gp, *args, **kwargs):
        vals = _fused_fullgp_vals(
            gp._spec, gp._tensor(gp._theta), gp._post, gp._post_data,
            gp._warp_tensor(gp._tensor(X)), None, gp.white_index_,
        )
        with trace.wait():
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
        with trace.wait():
            return vals.cpu().numpy()


def _draw_posteriors(rows, data, X, kernel, white_idx, n_real, n_warp):
    """Per hyperposterior row: one batched gram (K1 on the device) and one
    batched factorization; with warping each row warps the training
    inputs and ``X`` by its own warp. Returns (data, posterior, block
    inverses, noise-free theta, warped X)."""
    theta, d, Xq = gpc.warped_draws(rows, data, n_warp, X)
    grams = gpc.fused_marginal_grams(kernel, theta, d, n_real=n_real)
    post, invs = gpc.posterior_and_invs(kernel, theta, d, Kp=grams)
    return d, post, invs, gpc.noise_free_theta(kernel, theta, white_idx), Xq


def _per_draw_body(rows, data, X, kernel, white_idx, n_real, n_warp=0, z=None):
    """Per hyperposterior row (:func:`_draw_posteriors`), the cross-gram
    solve through the cached block inverses where they exist. Returns the
    (S, m) predictive mean and std, or, given standard normals ``z``
    (S, m, 1), one joint draw per row (S, m). A non-PD draw gives NaN,
    which the caller's finite filter drops."""
    d, post, invs, theta_nf, Xq = _draw_posteriors(rows, data, X, kernel, white_idx, n_real,
                                                   n_warp)
    if z is not None:
        return gpc.sample_y(kernel, theta_nf, post, d, Xq, z, invs=invs)[..., 0]
    return gpc.predict(kernel, theta_nf, post, d, Xq, return_std=True, invs=invs)


def _per_draw_sharded(rows, data, X, kernel, white_idx, n_real, n_warp, mesh):
    """:func:`_per_draw_body`'s (S, m) mean and std with the candidate grid
    split over the entries of a 1-axis ``mesh``: each distinct device
    builds the draws' posteriors once, each entry predicts its candidates
    (the cross-gram and its solve, the part that grows with the grid),
    and the shards are gathered in candidate order on ``rows``' device."""
    from .models.warping import split_warp_params, warp

    posts, mus, stds = {}, [], []
    for Xc in mesh.split(X):
        dev = Xc.device
        if dev not in posts:
            r = rows.to(dev)
            d = data._replace(**{k: getattr(data, k).to(dev)
                                 for k in ("X", "y", "alpha_diag", "mask")})
            posts[dev] = (r, *_draw_posteriors(r, d, None, kernel, white_idx, n_real, n_warp))
        r, d, post, invs, theta_nf, _ = posts[dev]
        Xq = warp(Xc, *split_warp_params(r, n_warp)[1:]) if n_warp else Xc
        mu, std = gpc.predict(kernel, theta_nf, post, d, Xq, return_std=True, invs=invs)
        mus.append(mu)
        stds.append(std)
    return (mesh.all_gather(mus, dim=-1, device=rows.device),
            mesh.all_gather(stds, dim=-1, device=rows.device))


def _fused_marginal_vals(rows, data, X, kernel, white_idx, n_real, acq, kwargs, n_warp=0, z=None,
                         mesh=None):
    """(S, m) values of an uncertainty acquisition, or of a sample
    acquisition on the draws for the normals ``z``, one row per draw.
    ``mesh`` shards an uncertainty acquisition's predictions over the
    candidates (a sample acquisition's joint draws need the whole grid's
    covariance, and run on the model's device)."""
    if isinstance(acq, SampleAcquisition):
        draws = _per_draw_body(rows, data, X, kernel, white_idx, n_real, n_warp, z)
        return acq(draws, **kwargs)
    if mesh is not None:
        mu_s, std_s = _per_draw_sharded(rows, data, X, kernel, white_idx, n_real, n_warp, mesh)
    else:
        mu_s, std_s = _per_draw_body(rows, data, X, kernel, white_idx, n_real, n_warp)
    return acq(mu_s, std_s, **kwargs)


def _rng(random_state):
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(random_state)


def _marginal_values(X, gpr, acqs, n_samples, rs, kwargs, mesh=None):
    """(S, m) host values of each uncertainty or sample acquisition in
    ``acqs`` (``None`` for the others) over ``n_samples`` distinct chain
    rows. Consumes ``rs`` in the JAX package's order: the rows, a seed
    for the per-draw function samples (the Thompson normals), a seed for
    the acquisitions' own randoms (a fresh generator per acquisition,
    the one MES draws from)."""
    idx = rs.choice(len(gpr.chain_), replace=False, size=n_samples)
    sample_seed = rs.randint(0, 2**31 - 1)
    acq_seed = rs.randint(0, 2**31 - 1)
    args = (
        gpr._tensor(gpr.chain_[idx]), gpr._data, gpr._tensor(X), gpr._spec,
        gpr.white_index_, len(gpr._y_orig),
    )
    z = None
    if any(isinstance(a, SampleAcquisition) for a in acqs):
        z = gpr._normals(sample_seed, (n_samples, X.shape[0], 1))
    out = []
    for acq in acqs:
        if isinstance(acq, UncertaintyAcquisition):
            gen = torch.Generator(device=gpr.device)
            gen.manual_seed(acq_seed)
            kw = {"generator": gen, **kwargs}
        elif isinstance(acq, SampleAcquisition):
            kw = kwargs
        else:
            out.append(None)
            continue
        vals = _fused_marginal_vals(*args, acq, kw, gpr._n_warp(), z, mesh=mesh)
        with trace.wait():
            out.append(vals.cpu().numpy())
    return out


def _finite_mean(vals, n_samples):
    """Sum of the draws (rows) whose values are all finite, over the
    total draw count, as in the JAX package."""
    finite = np.all(np.isfinite(vals), axis=1)
    if not finite.any():
        return 0.0
    return vals[finite].sum(axis=0) / n_samples


@torch.no_grad()
def evaluate_acquisitions_fused(X, gpr, acq, n_samples: int = 10, random_state=None, mesh=None,
                                **kwargs):
    """Evaluate ONE acquisition on the candidate grid X: (1, n_candidates),
    or ``None`` for an acquisition that is neither FullGP, uncertainty
    nor sample acquisition, and for every acquisition while
    :data:`FUSED_ACQUISITION` is not "on" (the caller then takes
    :func:`evaluate_acquisitions`, as in the JAX package).

    A FullGP acquisition is called on the consensus model as
    ``acq(X, gpr, random_state=rs, **kwargs)``; for a custom FullGP class
    that is what the JAX package's legacy route computes (its fused pass
    declines such a class). An uncertainty or sample acquisition is
    averaged over ``n_samples`` distinct chain rows, with draws that give
    non-finite values dropped.

    ``mesh`` (a 1-axis :class:`~bask_tpu_torch.parallel.mesh.Mesh`)
    splits the candidate grid of an uncertainty acquisition over its
    entries for the predictions; the values equal the unsharded ones.
    """
    with trace.span("span.acq.fused"):
        if FUSED_ACQUISITION != "on":
            return None
        X = np.atleast_2d(np.asarray(X, dtype=float))
        rs = _rng(random_state)
        out = np.zeros((1, X.shape[0]))
        if isinstance(acq, FullGPAcquisition):
            vals = acq(X, gpr, random_state=rs, **kwargs)
            if np.all(np.isfinite(vals)):
                out[0] = vals
            return out
        if not isinstance(acq, (UncertaintyAcquisition, SampleAcquisition)):
            return None
        if n_samples <= 0:
            return out
        (vals,) = _marginal_values(X, gpr, (acq,), n_samples, rs, kwargs, mesh=mesh)
        out[0] += _finite_mean(vals, n_samples)
        return out


@torch.no_grad()
def evaluate_acquisitions(
    X, gpr, acquisition_functions=None, n_samples: int = 10, progress: bool = False,
    random_state=None, **kwargs,
):
    """Evaluate several acquisitions on the candidate grid X, marginalized
    over ``n_samples`` chain rows: (n_acqs, n_candidates).

    FullGP acquisitions score the consensus model once each (in order,
    drawing from the one host RNG); uncertainty and sample acquisitions
    share one set of rows and are averaged over the draws, non-finite
    draws dropped; any other acquisition leaves its row at 0. For one
    acquisition this is :func:`evaluate_acquisitions_fused`'s result, bit
    for bit: the host RNG is consumed in the same order.
    """
    from .utils.progress import get_progress_bar

    X = np.atleast_2d(np.asarray(X, dtype=float))
    acqs = tuple(acquisition_functions)
    out = np.zeros((len(acqs), X.shape[0]))
    rs = _rng(random_state)
    for i, acq in enumerate(acqs):
        if isinstance(acq, FullGPAcquisition):
            vals = acq(X, gpr, random_state=rs, **kwargs)
            if np.all(np.isfinite(vals)):
                out[i] = vals
    marginal = any(isinstance(a, (UncertaintyAcquisition, SampleAcquisition)) for a in acqs)
    if not marginal or n_samples <= 0:
        return out
    pbar = get_progress_bar(progress, len(acqs))
    for i, vals in enumerate(_marginal_values(X, gpr, acqs, n_samples, rs, kwargs)):
        if vals is not None:
            out[i] += _finite_mean(vals, n_samples)
        pbar.update(1)
    pbar.close()
    return out


# ---------------------------------------------------------------------------
# Gradient-polished argmax
# ---------------------------------------------------------------------------
#
# Supported: the pointwise mu/std acquisitions (EI, TopTwoEI,
# Expectation, LCB) and PVRS/VarianceReduction. Excluded: MES (its value
# at x depends on min-value samples fitted to the whole grid) and
# Thompson sampling (a fresh function draw per x is no coherent surface).


def _adam_ascent(value_fn, X0, n_steps: int, lr: float):
    """Best-tracking Adam ascent of ``value_fn`` over [0, 1]^d from each
    row of ``X0`` (k, d). ``value_fn`` maps (k, d) to (k,), each value a
    function of its own row, so one backward pass of the summed values
    gives every start's gradient; non-finite gradients (sqrt at distance
    0) count as 0. Returns ``(x_best, v_best)`` per start, never worse
    than the start's own value under the same ``value_fn``."""

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        val = value_fn(x)
        (g,) = torch.autograd.grad(val.sum(), x)
        return val.detach(), torch.where(torch.isfinite(g), g, 0.0)

    def track(x, val, xb, vb):
        better = val > vb
        xb = torch.where(better[:, None], x, xb)
        vb = torch.maximum(torch.where(torch.isfinite(val), val, -math.inf), vb)
        return xb, vb

    x = xb = X0
    m = torch.zeros_like(X0)
    v = torch.zeros_like(X0)
    vb = torch.full(X0.shape[:1], -math.inf, dtype=X0.dtype, device=X0.device)
    for t in range(n_steps):
        val, g = value_and_grad(x)
        xb, vb = track(x, val, xb, vb)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        mh = m / (1.0 - 0.9 ** (t + 1.0))
        vh = v / (1.0 - 0.999 ** (t + 1.0))
        x = torch.clamp(x + lr * mh / (torch.sqrt(vh) + 1e-8), 0.0, 1.0)
    with torch.no_grad():
        val = value_fn(x)
    return track(x, val, xb, vb)


def _polish_fullgp_vals(kernel, theta, post, data, X0, Xw_pool, warp_params, z, white_idx,
                        n_steps, lr):
    """Adam-polish the PVRS (normals ``z``) or VarianceReduction
    (``z=None``) score from ``X0`` (transformed space). The probes come
    from ``Xw_pool`` (consensus-warped), so the values compare only with
    each other: the caller includes the grid argmax among the starts."""
    from .models import warping as wp

    with torch.no_grad():
        P = _thompson_probes(kernel, theta, post, data, Xw_pool, z, white_idx)

    def value(x):
        xw = x if warp_params is None else wp.warp(x, *warp_params)
        return _variance_explained_body(kernel, theta, post, data, xw, P)

    return _adam_ascent(value, X0, n_steps, lr)


def _polish_marginal_vals(rows, data, X0, X_pool, kernel, white_idx, n_real, n_warp, acq,
                          kwargs, n_steps, lr, n_samples):
    """Adam-polish a marginalized pointwise acquisition from ``X0``.

    The per-draw grams and factorizations are made once, without
    gradients; each step then predicts the k starts under every draw.
    EI's ``y_opt = min(mu)`` and TopTwoEI's best point are frozen per
    draw from one prediction pass over ``X_pool`` (the caller's grid), so
    the ascent climbs the surface the grid argmax saw.
    """
    from .models import warping as wp

    with torch.no_grad():
        theta, d, _ = gpc.warped_draws(rows, data, n_warp)
        grams = gpc.fused_marginal_grams(kernel, theta, d, n_real=n_real)
        post, invs = gpc.posterior_and_invs(kernel, theta, d, Kp=grams)
        theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
        warp_params = wp.split_warp_params(rows, n_warp)[1:] if n_warp else None

    def predict_at(Xq):  # (k, d) -> (S, k) mean and std
        if warp_params is not None:
            Xq = wp.warp(Xq, *warp_params)
        return gpc.predict(kernel, theta_nf, post, d, Xq, return_std=True, invs=invs)

    kw = dict(kwargs)
    ei_like = isinstance(acq, ExpectedImprovement)  # TopTwoEI included
    with torch.no_grad():
        mu_pool, std_pool = predict_at(X_pool)
        if ei_like:
            y_opt = kw.pop("y_opt", None)
            if y_opt is None:
                y_opt_s = mu_pool.min(dim=-1).values
            else:
                y_opt_s = torch.full(mu_pool.shape[:1], float(y_opt), dtype=X0.dtype,
                                     device=X0.device)
            y_opt_s = y_opt_s[:, None]
        if isinstance(acq, TopTwoEI):
            ok = std_pool > 0
            safe = torch.where(ok, std_pool, 1.0)
            ei = torch.where(ok, _ei_term((y_opt_s - mu_pool) / safe) * safe, 0.0)
            best = torch.argmax(ei, dim=-1, keepdim=True)
            mu_b, std_b = mu_pool.gather(-1, best), std_pool.gather(-1, best)

    def value(x):
        mu, std = predict_at(x)
        ok = std > 0
        if isinstance(acq, TopTwoEI):
            safe_outer = torch.where(ok, torch.sqrt(std**2 + std_b**2), 1.0)
            vals = torch.where(ok, safe_outer * _ei_term((mu_b - mu) / safe_outer), 0.0)
        elif ei_like:
            safe = torch.where(ok, std, 1.0)
            vals = torch.where(ok, _ei_term((y_opt_s - mu) / safe) * safe, 0.0)
        else:
            vals = acq(mu, std, **kw)
        # as the grid dispatcher: finite draws summed, over the total count
        return torch.where(torch.isfinite(vals), vals, 0.0).sum(0) / n_samples

    return _adam_ascent(value, X0, n_steps, lr)


def polish_noop_reason(acq, n_samples: int = 10, **kwargs):
    """Why :func:`polish_acquisition` returns ``None`` for this
    configuration, as a sentence, or ``None`` where polish runs."""
    if isinstance(acq, FullGPAcquisition):
        if type(acq) in (PVRS, VarianceReduction):
            return None
        return (
            f"custom FullGPAcquisition {type(acq).__name__} has no "
            "known differentiable surface (only PVRS/VarianceReduction "
            "are polished)"
        )
    if not isinstance(acq, UncertaintyAcquisition):
        return (
            f"{type(acq).__name__} is not an Uncertainty/FullGP "
            "acquisition; no pointwise surface to ascend"
        )
    if isinstance(acq, MaxValueSearch):
        return (
            "MES couples values to grid-wide min-value samples; no "
            "pointwise surface to ascend"
        )
    if n_samples <= 0:
        return (
            "n_samples=0 hyperposterior draws requested (pass "
            "n_samples>0 to tell/run so the marginalized surface exists)"
        )
    return None


def polish_acquisition(
    X0, gpr, acq, n_samples: int = 10, random_state=None, n_steps: int = 20,
    lr: float = 0.05, X_pool=None, **kwargs,
):
    """Gradient-ascent refinement of acquisition argmax candidates.

    ``X0`` (k, d) are starts in the transformed space (include the grid
    argmax: the values compare only within this call's own draws).
    Returns ``(X_polished, values)`` as NumPy, or ``None`` where
    :func:`polish_noop_reason` gives a reason. ``X_pool`` is the grid the
    PVRS probes and EI's frozen constants come from (default: the starts
    and 256 uniform points, or 256 uniform points). ``random_state``
    picks the Thompson normals or the chain rows, in the JAX package's
    order.
    """
    if polish_noop_reason(acq, n_samples=n_samples, **kwargs) is not None:
        return None
    X0 = np.atleast_2d(np.asarray(X0, dtype=float))
    rs = _rng(random_state)
    n_steps, lr = int(n_steps), float(lr)
    if isinstance(acq, FullGPAcquisition):
        if X_pool is None:
            X_pool = np.concatenate([X0, rs.uniform(size=(256, X0.shape[1]))])
        Xw_pool = gpr._warp_tensor(gpr._tensor(X_pool))
        seed = int(rs.randint(0, 2**31 - 1))
        z = None
        if type(acq) is PVRS:
            z = gpr._normals(seed, (Xw_pool.shape[0], int(kwargs.get("n_thompson", 10))))
        xb, vb = _polish_fullgp_vals(
            gpr._spec, gpr._tensor(gpr._theta), gpr._post, gpr._post_data,
            gpr._tensor(X0), Xw_pool, gpr._warp_params(), z, gpr.white_index_, n_steps, lr,
        )
    else:
        idx = rs.choice(len(gpr.chain_), replace=False, size=n_samples)
        if X_pool is None:
            X_pool = rs.uniform(size=(256, X0.shape[1]))
        xb, vb = _polish_marginal_vals(
            gpr._tensor(gpr.chain_[idx]), gpr._data, gpr._tensor(X0), gpr._tensor(X_pool),
            gpr._spec, gpr.white_index_, len(gpr._y_orig), gpr._n_warp(), acq, kwargs,
            n_steps, lr, int(n_samples),
        )
    return xb.detach().cpu().double().numpy(), vb.cpu().double().numpy()
