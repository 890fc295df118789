"""Fully-Bayesian GP regressor with hyperparameter MCMC on the device.

PyTorch counterpart of :class:`bask_tpu.models.bayesgpr.BayesGPR` (the
default path): an ML-II warm start on the first fit, then an ensemble
sampler over the kernel hyperparameters whose batched log-probability is
:func:`bask_tpu_torch.ops.linalg.batched_lml`, the consensus model at
the geometric median of the kept chain, and predictions from it.

``sample`` runs chain -> kept steps -> geometric median -> consensus
factorization (3-rung jitter ladder) -> consensus LML, the sequence of
the JAX package's fused sample program. The model lives on ``device`` in
``dtype`` (the CUDA card unless the caller names another device); on a
CUDA device in float32 the chain's grams and factorization bases run in
the package's hand-written kernels.

``warp_inputs=True`` adds Beta-CDF input warping
(:mod:`bask_tpu_torch.models.warping`): each chain row carries 2d warp
log-parameters after the kernel theta, the log-probability warps the
training inputs per walker (a (W, n_pad, d) X for the gram kernel's
per-walker mode), and the consensus splits the geometric median into
``theta``, ``warp_alphas_`` and ``warp_betas_``. ML-II fits theta alone
at the identity warp, as in the JAX package.

Pathwise draws (:mod:`bask_tpu_torch.models.pathwise`) give
:meth:`BayesGPR.sample_y_pathwise` and :meth:`BayesGPR.thompson_argmin_pathwise`,
the batch-ask path over large candidate grids; :meth:`BayesGPR.mcmc_diagnostics`
reports split R-hat, ESS and autocorrelation times of the kept chain.

Not ported: row-sharded mode, Laplace chain init, the MAP ML-II
objective, ML-II subsampling, ``optimizer=None``, host-callback priors
and serialization.
"""

from __future__ import annotations

import math
import warnings
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from ..ops import kernels as bk
from ..ops.linalg import batched_lml, cho_solve_masked, masked_cholesky, masked_gram
from ..parallel.mcmc import _MOVE_PARAMS, _normalize_moves, flatten_chain, run_ensemble
from ..utils.median import geometric_median
from ..utils.priors import guess_priors
from ..utils.validation import validate_zeroone
from . import gp as gpc
from . import warping as wp

__all__ = ["BayesGPR"]

DEFAULT_WARN_RHAT = 1.1

_MOVE_ALIASES = {
    "demix": (("de", 0.8), ("snooker", 0.2)),
    "tri": (("stretch", 0.5), ("de", 0.4), ("snooker", 0.1)),
}


def _bucket(n: int) -> int:
    """Padding bucket: 64 minimum, then multiples of 64."""
    return max(64, ((n + 63) // 64) * 64)


def _maybe_warn_rhat(kept_steps, warn_rhat):
    """Warn when the kept chain's max split R-hat exceeds ``warn_rhat``
    (skipped below 4 kept steps: no honest estimate there)."""
    if warn_rhat is None or kept_steps.shape[0] < 4:
        return
    from ..utils.diagnostics import split_rhat

    max_rhat = float(np.max(split_rhat(kept_steps)))
    if max_rhat > warn_rhat:
        warnings.warn(
            f"MCMC chain may not be converged: max split R-hat {max_rhat:.3f} "
            f"exceeds the threshold {warn_rhat}. Sample with until_rhat= or "
            "a longer chain; pass warn_rhat=None to silence this guard.",
            UserWarning,
            stacklevel=3,
        )


def _eval_priors(priors, theta):
    """Summed log-prior of (..., n_theta) thetas: a joint callable, or one
    elementwise callable per theta entry."""
    if callable(priors):
        return priors(theta)
    lp = 0.0
    for i, p in enumerate(priors):
        lp = lp + p(theta[..., i])
    return lp


def _make_log_prob_batch(kernel, priors, data, n_real, warp_prior=None, n_warp=0):
    """Batched (W, D) -> (W,) log-posterior for the ensemble sampler.

    With ``n_warp`` > 0 the last ``2 * n_warp`` entries of each row are
    warp log-parameters: ``warp_prior(log_alphas, log_betas)`` scores them
    ((W, d) each -> (W,)) and the training inputs are warped per walker."""

    def log_prob_batch(xs):
        if n_warp:
            theta_gp, la, lb = wp.split_warp_params(xs, n_warp)
            X = wp.warp(data.X, la, lb)
            lp = warp_prior(la, lb)
        else:
            theta_gp, X, lp = xs, data.X, 0.0
        lp = lp + _eval_priors(priors, theta_gp)
        lml = batched_lml(
            kernel, theta_gp, X, data.y, data.alpha_diag, data.mask, n_real=n_real
        )
        total = lp + lml
        return torch.where(torch.isfinite(total), total, -math.inf)

    return log_prob_batch


def _neg_lml_plain(kernel, theta, data):
    """Negative LML through the plain factorization (``cholesky_ex``
    plus a triangular solve), never the blocked kernels: autograd
    differentiates it for the ML-II warm start. NaN where not PD."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    L = masked_cholesky(Kp)
    w = torch.linalg.solve_triangular(L, data.y[:, None], upper=False)[:, 0]
    n = data.mask.sum().to(data.y.dtype)
    lml = (
        -0.5 * (w * w).sum()
        - torch.where(data.mask, torch.log(L.diagonal()), 0.0).sum()
        - 0.5 * n * math.log(2.0 * math.pi)
    )
    return -lml


def _posterior_robust_body(theta, data, kernel):
    """Posterior factorization with a branchless 3-rung jitter ladder:
    the first of K, K + 1e-8 s I, K + 1e-4 s I (s = mean |diag K|) whose
    factor has no NaN."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    scale = Kp.diagonal().abs().mean()
    eye = torch.eye(Kp.shape[0], dtype=Kp.dtype, device=Kp.device)
    L0 = masked_cholesky(Kp)
    L1 = masked_cholesky(Kp + 1e-8 * scale * eye)
    L2 = masked_cholesky(Kp + 1e-4 * scale * eye)
    L = torch.where(
        torch.isnan(L0).any(), torch.where(torch.isnan(L1).any(), L2, L1), L0
    )
    return gpc.GPPosterior(theta=theta, L=L, alpha_dual=cho_solve_masked(L, data.y))


def _consensus_body(kernel, theta, data):
    """Robust factorization and LML: the consensus refresh."""
    post = _posterior_robust_body(theta, data, kernel)
    return post, gpc.log_marginal_likelihood(kernel, theta, data)


def _canonical_moves(moves):
    """Normalize a ``moves`` spec to a tuple of ``(name, weight)``.

    ``None`` is pure stretch, ``"auto"`` stays a sentinel resolved per
    sample() call (demix at W >= 6, DE at W >= 4, stretch below), a bare
    move name is that move at weight 1, and ``"demix"``/``"tri"`` are
    mixtures; ``"demix:jump=0.2"`` hands each key to the member move
    that accepts it.
    """
    if moves is None or moves == "auto":
        return moves
    if isinstance(moves, str):
        base, sep, rest = moves.partition(":")
        alias = _MOVE_ALIASES.get(base)
        if alias is not None and sep:
            items = [it.strip() for it in rest.split(",")]
            keys = [it.partition("=")[0].strip() for it in items]
            out, claimed = [], set()
            for name, w in alias:
                accepts = _MOVE_PARAMS[name.partition(":")[0]]
                mine = [it for it, k in zip(items, keys) if k in accepts]
                claimed.update(k for k in keys if k in accepts)
                out.append((name + (":" + ",".join(mine) if mine else ""), w))
            unknown = [k for k in keys if k not in claimed]
            if unknown:
                raise ValueError(
                    f"alias {base!r} members accept no parameter named {unknown[0]!r}"
                )
            moves = tuple(out)
        elif alias is not None:
            moves = alias
        else:
            moves = ((moves, 1.0),)
    canon = tuple((str(n), float(w)) for n, w in moves)
    _normalize_moves(canon)
    return canon


class BayesGPR:
    """Fully-Bayesian Gaussian process regressor (see module docstring).

    ``kernel`` is a spec from :mod:`bask_tpu_torch.ops.kernels`;
    ``alpha`` is the jitter on the gram's diagonal (floored at 1e-6 in
    float32); ``noise="gaussian"`` appends a WhiteKernel at fit time;
    ``warp_inputs`` learns a Beta-CDF warp of each input dimension (inputs
    in [0, 1]); ``normalize_y`` standardizes the targets by their mean and
    standard deviation at every new data set. ``fit`` always runs the
    ML-II warm start. ``moves``
    picks the ensemble moves (default ``"auto"``: demix at W >= 6).
    ``device`` and ``dtype`` place the training data, the chain and the
    posterior; ``device=None`` is the CUDA card. Host-side state
    (``theta``, ``chain_``, ``pos_``, ``warp_alphas_``, ``warp_betas_``)
    is NumPy, as in the JAX package.
    """

    def __init__(
        self,
        kernel: Optional[bk.Kernel] = None,
        alpha: float = 1e-10,
        random_state=None,
        noise: Optional[str] = "gaussian",
        normalize_y: bool = False,
        warp_inputs: bool = False,
        moves="auto",
        device=None,
        dtype=torch.float32,
    ):
        if kernel is None:
            kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(1.0, (1e-5, 1e5))
        self._user_kernel = kernel
        self.alpha = alpha
        self.noise = noise
        self.normalize_y = normalize_y
        self.warp_inputs = warp_inputs
        self.moves = _canonical_moves(moves)
        self.device = torch.device("cuda" if device is None else device)
        self.dtype = dtype
        if isinstance(random_state, np.random.RandomState):
            self.random_state = random_state
        else:
            self.random_state = np.random.RandomState(random_state)

        self._spec: Optional[bk.Kernel] = None
        self.chain_: Optional[np.ndarray] = None
        self.chain_steps_: Optional[np.ndarray] = None  # (steps, W, D)
        self.pos_: Optional[np.ndarray] = None
        self.noise_: Optional[float] = None
        self.log_marginal_likelihood_value_: Optional[float] = None
        self.warp_alphas_: Optional[np.ndarray] = None
        self.warp_betas_: Optional[np.ndarray] = None
        self.until_rhat_result_ = None
        self._theta: Optional[np.ndarray] = None
        self._data: Optional[gpc.GPData] = None
        # the posterior's data: _data with the consensus warp applied
        self._post_data: Optional[gpc.GPData] = None
        self._post: Optional[gpc.GPPosterior] = None
        self._X_orig: Optional[np.ndarray] = None
        self._y_orig: Optional[np.ndarray] = None
        self._noise_vector: Optional[np.ndarray] = None
        self._priors_cache = None
        self._noise_zero = False
        self.n_accepted_ = 0
        self.n_proposals_ = 0
        self.y_train_mean_ = 0.0
        self.y_train_std_ = 1.0

    # -- basic properties --------------------------------------------------

    @property
    def kernel_(self):
        """Fitted kernel spec with the consensus hyperparameters baked in."""
        if self._spec is None:
            return None
        t = self._theta
        if t is None or np.isnan(np.asarray(t, dtype=float)).any():
            return self._spec
        return self._spec.with_theta(np.asarray(t, dtype=float))

    @property
    def X_train_(self):
        """Training inputs (warped if ``warp_inputs``), unpadded."""
        if self._X_orig is None:
            return None
        return self.warp(self._X_orig)

    @X_train_.setter
    def X_train_(self, X_train):
        """Replace the training inputs (original, unwarped space); the
        warped view and the posterior are rederived."""
        self._X_orig = np.array(X_train, dtype=float, ndmin=2)
        if self._y_orig is not None:
            self._upload()
            self._refresh_posterior(with_lml=False)

    @property
    def theta(self):
        return None if self._theta is None else np.copy(self._theta)

    @theta.setter
    def theta(self, value):
        self._theta = np.asarray(value, dtype=float)
        self._refresh_posterior()

    @property
    def L_(self):
        if self._post is None:
            return None
        n = len(self._y_orig)
        return self._post.L[:n, :n].cpu().numpy()

    @property
    def alpha_(self):
        if self._post is None:
            return None
        return self._post.alpha_dual[: len(self._y_orig)].cpu().numpy()

    @property
    def white_index_(self):
        return None if self._spec is None else bk.white_theta_index(self._spec)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    # -- data management ---------------------------------------------------

    def _set_data(self, X, y, noise_vector):
        self._X_orig = np.array(X, dtype=float, ndmin=2)
        self._y_orig = np.array(y, dtype=float).ravel()
        if self.normalize_y:
            self.y_train_mean_ = float(np.mean(self._y_orig))
            self.y_train_std_ = float(np.std(self._y_orig)) or 1.0
        else:
            self.y_train_mean_, self.y_train_std_ = 0.0, 1.0
        if noise_vector is not None:
            noise_vector = np.asarray(noise_vector, dtype=float) / self.y_train_std_**2
        self._noise_vector = noise_vector
        self._upload()

    def _upload(self):
        """(Re)build the padded device-side GPData."""
        X, y = self._X_orig, self._y_orig
        n, d = X.shape
        n_pad = _bucket(n)
        Xp = np.full((n_pad, d), 0.5)
        Xp[:n] = X
        yp = np.zeros(n_pad)
        yp[:n] = (y - self.y_train_mean_) / self.y_train_std_
        # float32 cannot represent a 1e-10 jitter against a unit-scale
        # gram; floor it so near-noise-free problems still factor
        base_alpha = self.alpha
        if self.dtype == torch.float32:
            base_alpha = max(base_alpha, 1e-6)
        alpha = np.full(n_pad, base_alpha)
        if self._noise_vector is not None:
            nv = np.asarray(self._noise_vector, dtype=float)
            alpha[: len(nv)] += nv
        self._data = gpc.make_data(
            self._tensor(Xp),
            self._tensor(yp),
            self._tensor(alpha),
            np.arange(n_pad) < n,
            y_mean=self.y_train_mean_,
            y_std=self.y_train_std_,
        )

    def _n_warp(self) -> int:
        return self._X_orig.shape[1] if self.warp_inputs else 0

    def _warp_params(self):
        """(log_alphas, log_betas) tensors of the consensus warp, or None."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        return self._tensor(self.warp_alphas_), self._tensor(self.warp_betas_)

    def _warp_tensor(self, X):
        """X (..., d) tensor in the consensus-warped space."""
        params = self._warp_params()
        return X if params is None else wp.warp(X, *params)

    def _refresh_posterior(self, with_lml: bool = True):
        """Consensus refresh: warp -> robust factorization -> LML."""
        if self._theta is None or self._data is None:
            return
        data = self._data._replace(X=self._warp_tensor(self._data.X))
        theta = self._tensor(self._theta)
        self._post_data = data
        if with_lml:
            self._post, self._consensus_lml_ = _consensus_body(self._spec, theta, data)
        else:
            self._post = _posterior_robust_body(theta, data, self._spec)
            self._consensus_lml_ = None

    # -- ML-II warm start --------------------------------------------------

    def _ml2_optimize(self):
        """scipy L-BFGS-B on the negative LML, with value and gradient from
        autograd through the plain factorization. The result only seeds
        the chain, so iterations are capped at 60."""
        from scipy.optimize import minimize

        kernel, data = self._spec, self._data

        def obj(t):
            theta = self._tensor(t).requires_grad_(True)
            v = _neg_lml_plain(kernel, theta, data)
            if not bool(torch.isfinite(v)):
                return 1e25, np.zeros_like(t)
            (g,) = torch.autograd.grad(v, theta)
            return float(v), g.detach().cpu().double().numpy()

        res = minimize(
            obj, kernel.theta0, jac=True, method="L-BFGS-B", bounds=kernel.bounds,
            options={"maxiter": 60},
        )
        return np.asarray(res.x, dtype=float)

    # -- sampling ----------------------------------------------------------

    def _resolve_priors(self, priors):
        if priors is None:
            if self._priors_cache is None:
                self._priors_cache = tuple(guess_priors(self._spec))
            return self._priors_cache
        return priors if callable(priors) else tuple(priors)

    @staticmethod
    def _resolve_warp_priors(warp_priors):
        """None: :func:`warping.default_warp_log_prior`; a pair of
        elementwise log-priors (alphas, betas): summed over dimensions; a
        callable of batched (W, d) log-alphas and log-betas -> (W,)."""
        if warp_priors is None:
            return wp.default_warp_log_prior
        if isinstance(warp_priors, (tuple, list)):
            a_prior, b_prior = warp_priors

            def warp_prior(log_alphas, log_betas):
                return a_prior(log_alphas).sum(-1) + b_prior(log_betas).sum(-1)

            return warp_prior
        return warp_priors

    @torch.no_grad()
    def sample(
        self,
        X=None,
        y=None,
        noise_vector=None,
        n_desired_samples: int = 100,
        n_burnin: int = 0,
        n_thin: int = 1,
        n_walkers_per_thread: int = 100,
        priors=None,
        warp_priors=None,
        position=None,
        add: bool = False,
        warn_rhat="default",
        moves=None,
        until_rhat: Optional[float] = None,
        max_extensions: int = 10,
        extension_steps: Optional[int] = None,
        _consensus: bool = True,
        **kwargs,
    ):
        """Sample the kernel-hyperparameter posterior on the device.

        Warm-starts from ``pos_`` when its shape fits, otherwise from a
        1e-2 ball around the current theta; runs
        ``ceil(n_desired_samples / n_walkers) + n_burnin`` steps and sets
        the consensus model at the geometric median of the kept chain.
        ``until_rhat`` then warm-extends the chain in legs of
        ``extension_steps`` steps until the max split R-hat of its second
        half is at most ``until_rhat``, or ``max_extensions`` legs were
        added.
        """
        self.until_rhat_result_ = None
        if isinstance(warn_rhat, str):  # "default"
            warn_rhat = None if until_rhat is not None else DEFAULT_WARN_RHAT
        common = dict(
            n_thin=n_thin,
            n_walkers_per_thread=n_walkers_per_thread, priors=priors,
            warp_priors=warp_priors, moves=moves, warn_rhat=None, **kwargs,
        )
        if until_rhat is not None:
            self.sample(
                X, y, noise_vector, n_desired_samples=n_desired_samples,
                n_burnin=n_burnin, position=position, add=add, **common,
            )

            def _second_half_rhat():
                steps = self.chain_steps_
                if steps is None or steps.shape[0] < 4:
                    return float("inf")
                from ..utils.diagnostics import split_rhat

                half = steps[steps.shape[0] // 2 :]
                if half.shape[0] < 4:
                    half = steps
                return float(np.max(split_rhat(half)))

            if extension_steps is not None:
                leg_samples = int(extension_steps) * int(self.pos_.shape[0])
            else:
                leg_samples = n_desired_samples
            extended = False
            for _ in range(max_extensions):
                if _second_half_rhat() <= until_rhat:
                    break
                extended = True
                self.sample(
                    n_desired_samples=leg_samples, n_burnin=0,
                    position=self.pos_, add=True, _consensus=False, **common,
                )
            if extended:
                self._set_consensus_from_flat(self._tensor(self.chain_))
            final_rhat = _second_half_rhat()
            self.until_rhat_result_ = {
                "rhat": final_rhat,
                "threshold": until_rhat,
                "converged": bool(final_rhat <= until_rhat),
                "steps": int(self.chain_steps_.shape[0]),
            }
            if final_rhat > until_rhat:
                warnings.warn(
                    f"sample(until_rhat={until_rhat}) did not converge within "
                    f"max_extensions={max_extensions} legs: max split R-hat "
                    f"{final_rhat:.3f}.",
                    UserWarning,
                    stacklevel=2,
                )
            elif warn_rhat is not None and final_rhat > warn_rhat:
                warnings.warn(
                    f"MCMC chain may not be converged: max split R-hat "
                    f"{final_rhat:.3f} exceeds the threshold {warn_rhat}.",
                    UserWarning,
                    stacklevel=2,
                )
            return self

        if (X is None and self._X_orig is None) or self._spec is None:
            raise ValueError("No data to sample from: pass X and y or call fit first.")
        if X is not None:
            self._set_data(X, y, noise_vector)
        elif noise_vector is not None:
            self._noise_vector = np.asarray(noise_vector, dtype=float) / self.y_train_std_**2
            self._upload()

        priors = self._resolve_priors(priors)
        warp_prior = self._resolve_warp_priors(warp_priors)
        n_warp = self._n_warp()
        n_dim = self._spec.n_theta + 2 * n_warp
        n_walkers = max(2, n_walkers_per_thread + n_walkers_per_thread % 2)
        if position is not None:
            n_walkers = int(np.asarray(position).shape[0])
        n_steps = int(math.ceil(n_desired_samples / n_walkers)) + n_burnin
        if len(range(n_burnin + n_thin - 1, n_steps, n_thin)) < 1:
            raise ValueError(
                f"Retained chain would be empty: n_desired_samples="
                f"{n_desired_samples} with {n_walkers} walkers gives "
                f"{n_steps - n_burnin} post-burnin step(s) and thin={n_thin} "
                "keeps none of them."
            )

        if position is not None:
            pos = np.asarray(position, dtype=float)
        elif self.pos_ is not None and self.pos_.shape == (n_walkers, n_dim):
            pos = self.pos_
        else:
            theta = np.copy(self._theta)
            bad = ~np.isfinite(theta)
            if bad.any():
                usable = self.noise_ and np.isfinite(self.noise_) and self.noise_ > 0
                theta[bad] = math.log(self.noise_) if usable else -10.0
            # warp dimensions start at the identity warp, log a = log b = 0
            theta = np.concatenate([theta, np.zeros(2 * n_warp)])
            pos = theta[None, :] + 1e-2 * self.random_state.randn(n_walkers, n_dim)
        seed = int(self.random_state.randint(0, 2**31 - 1))

        moves = _canonical_moves(moves) if moves is not None else self.moves
        if moves == "auto":
            w = pos.shape[0]
            moves = _MOVE_ALIASES["demix"] if w >= 6 else (("de", 1.0),) if w >= 4 else None

        log_prob = _make_log_prob_batch(
            self._spec, priors, self._data, len(self._y_orig), warp_prior, n_warp
        )
        chain_dev, final = run_ensemble(
            log_prob, self._tensor(pos), seed, n_steps,
            a=float(kwargs.get("a", 2.0)), moves=moves,
        )
        flat = flatten_chain(chain_dev, discard=n_burnin, thin=n_thin)
        kept_steps = chain_dev[n_burnin + n_thin - 1 :: n_thin].cpu().numpy()
        homogeneous_add = False
        if add and self.chain_ is not None:
            if (
                self.chain_steps_ is not None
                and self.chain_steps_.shape[1:] == kept_steps.shape[1:]
                and self.chain_steps_.size == self.chain_.size
            ):
                homogeneous_add = True
                self.chain_steps_ = np.concatenate([self.chain_steps_, kept_steps])
                self.chain_ = self.chain_steps_.reshape(-1, kept_steps.shape[-1])
            else:
                self.chain_ = np.concatenate([self.chain_, flat.cpu().numpy()])
                self.chain_steps_ = kept_steps
            flat = self._tensor(self.chain_)
        else:
            self.chain_steps_ = kept_steps
            self.chain_ = kept_steps.reshape(-1, kept_steps.shape[-1])
        self.pos_ = final.pos.cpu().numpy()
        _maybe_warn_rhat(self.chain_steps_, warn_rhat)
        w_act = self.chain_steps_.shape[1]
        if homogeneous_add and self.n_proposals_:
            self.n_accepted_ += int(final.accepted)
            self.n_proposals_ += n_steps * w_act
        else:
            self.n_accepted_ = int(final.accepted)
            self.n_proposals_ = n_steps * w_act
        if _consensus:
            self._set_consensus_from_flat(flat)
        return self

    def _set_consensus_from_flat(self, flat):
        """Geometric-median consensus over a flat (device) chain: the
        median splits into theta and the warp parameters, then the
        posterior and the consensus LML are refreshed on the warped data."""
        median = geometric_median(flat).cpu().double().numpy()
        n_gp, n_warp = self._spec.n_theta, self._n_warp()
        if n_warp:
            self.warp_alphas_ = median[n_gp : n_gp + n_warp]
            self.warp_betas_ = median[n_gp + n_warp :]
        self._theta = median[:n_gp]
        widx = self.white_index_
        if widx is not None:
            self.noise_ = float(np.exp(self._theta[widx]))
        self._refresh_posterior()
        self.log_marginal_likelihood_value_ = float(self._consensus_lml_)
        return self

    def fit(
        self,
        X,
        y,
        noise_vector=None,
        n_desired_samples: int = 100,
        n_burnin: int = 10,
        n_walkers_per_thread: int = 100,
        priors=None,
        warp_priors=None,
        position=None,
        **kwargs,
    ):
        """ML-II warm start (kernel theta at the identity warp), then
        hyperposterior sampling."""
        if self.noise == "gaussian" and bk.white_theta_index(self._user_kernel) is None:
            self._spec = self._user_kernel + bk.WhiteKernel(1.0, (1e-5, 1e5))
        else:
            self._spec = self._user_kernel
        self._priors_cache = None
        self._set_data(X, y, noise_vector)
        theta_ml = self._ml2_optimize()
        self._theta = theta_ml
        widx = self.white_index_
        if widx is not None:
            self.noise_ = float(np.exp(theta_ml[widx]))
        return self.sample(
            n_desired_samples=n_desired_samples,
            n_burnin=n_burnin,
            n_walkers_per_thread=n_walkers_per_thread,
            priors=priors,
            warp_priors=warp_priors,
            position=position,
            add=False,
            **kwargs,
        )

    def mcmc_diagnostics(self, c: float = 5.0) -> dict:
        """Convergence diagnostics of the kept chain: per-dimension split
        R-hat, effective sample size and integrated autocorrelation time
        (Sokal window constant ``c``), the acceptance rate, and the
        chain's steps and walkers."""
        if self.chain_steps_ is None:
            raise ValueError("No chain available: call fit()/sample() first.")
        if self.chain_steps_.shape[0] < 4:
            raise ValueError(
                "Need at least 4 post-burnin steps for diagnostics "
                f"(have {self.chain_steps_.shape[0]}); increase "
                "n_desired_samples or reduce thinning."
            )
        from ..utils.diagnostics import (
            effective_sample_size,
            integrated_autocorr_time,
            split_rhat,
        )

        x = self.chain_steps_
        return {
            "rhat": split_rhat(x),
            "ess": effective_sample_size(x),
            "autocorr_time": integrated_autocorr_time(x, c=c),
            "acceptance": self.n_accepted_ / self.n_proposals_ if self.n_proposals_ else None,
            "n_steps": int(x.shape[0]),
            "n_walkers": int(x.shape[1]),
        }

    # -- prediction --------------------------------------------------------

    @contextmanager
    def noise_set_to_zero(self):
        """Context manager: predictions exclude the Gaussian noise term
        (the factorized posterior is left as it is)."""
        prev = self._noise_zero
        self._noise_zero = True
        try:
            yield self
        finally:
            self._noise_zero = prev

    def _theta_diag(self):
        """Consensus theta of the prior-variance diagonal: noise-free
        inside :meth:`noise_set_to_zero`."""
        theta = self._tensor(self._theta)
        if self._noise_zero:
            return gpc.noise_free_theta(self._spec, theta, self.white_index_)
        return theta

    def _check_fitted(self):
        if self._post is None:
            raise ValueError("the model is not fitted: call fit first")

    @torch.no_grad()
    def predict(self, X, return_std: bool = False, return_cov: bool = False):
        """Predictive mean (and std or covariance) of the consensus GP;
        with warping ``X`` (in [0, 1]) is warped by the consensus warp."""
        self._check_fitted()
        X = np.atleast_2d(X)
        if self.warp_inputs:
            validate_zeroone(X)
        out = gpc.predict(
            self._spec, self._theta_diag(), self._post, self._post_data,
            self._warp_tensor(self._tensor(X)), return_std=return_std,
            return_cov=return_cov,
        )
        if return_std or return_cov:
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        return out.cpu().numpy()

    def _seed(self, random_state):
        if isinstance(random_state, np.random.RandomState):
            return int(random_state.randint(0, 2**31 - 1))
        if random_state is None:
            return int(self.random_state.randint(0, 2**31 - 1))
        return int(random_state)

    def _normals(self, seed, shape):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def sample_y(
        self,
        X,
        sample_mean: bool = False,
        noise: bool = False,
        n_samples: int = 1,
        random_state=0,
    ):
        """Function draws (n_points, n_samples): from the consensus GP with
        ``sample_mean=True``, else one draw per random chain row (each
        with its own warp, when warping)."""
        self._check_fitted()
        seed = self._seed(random_state)
        Xq = self._tensor(np.atleast_2d(X))
        widx = self.white_index_
        if sample_mean:
            theta = self._tensor(self._theta)
            td = theta if noise else gpc.noise_free_theta(self._spec, theta, widx)
            z = self._normals(seed, (Xq.shape[0], n_samples))
            return gpc.sample_y(
                self._spec, td, self._post, self._post_data, self._warp_tensor(Xq), z
            ).cpu().numpy()
        rs = np.random.RandomState(seed)
        idx = rs.choice(len(self.chain_), size=n_samples, replace=True)
        rows, data, Xq = gpc.warped_draws(
            self._tensor(self.chain_[idx]), self._data, self._n_warp(), Xq
        )
        grams = gpc.fused_marginal_grams(self._spec, rows, data, n_real=len(self._y_orig))
        post, invs = gpc.posterior_and_invs(self._spec, rows, data, Kp=grams)
        td = rows if noise else gpc.noise_free_theta(self._spec, rows, widx)
        z = self._normals(seed, (n_samples, Xq.shape[-2], 1))
        draws = gpc.sample_y(self._spec, td, post, data, Xq, z, invs=invs)
        return draws[..., 0].T.cpu().numpy()

    def _fused_spec(self):
        from ..ops.gram import match_fusable

        spec = match_fusable(self._spec)
        if spec is None:
            raise NotImplementedError(
                "Pathwise sampling requires a Constant*(Matern|RBF)[+White] "
                "kernel; use sample_y instead."
            )
        return spec

    def _pathwise_randoms(self, spec, seed, n_features, n_samples, batch=()):
        from .pathwise import draw_pathwise_randoms

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n_pad, d = self._data.X.shape
        return draw_pathwise_randoms(
            gen, spec.nu, n_features, d, n_pad, n_samples, batch=batch,
            dtype=self.dtype, device=self.device,
        )

    @torch.no_grad()
    def sample_y_pathwise(self, X, n_samples: int = 1, random_state=0, n_features: int = 1024):
        """Consensus-GP draws (n_points, n_samples) by pathwise sampling:
        linear in the number of points, so tens of thousands are fine.
        Needs a ``Constant * (Matern|RBF) [+ White]`` kernel."""
        from .pathwise import pathwise_samples

        spec = self._fused_spec()
        seed = self._seed(random_state)
        Xq = self._warp_tensor(self._tensor(np.atleast_2d(X)))
        rand = self._pathwise_randoms(spec, seed, n_features, n_samples)
        out = pathwise_samples(
            spec, self._tensor(self._theta), self._post_data, self._post.L, Xq, rand
        )
        return out.cpu().double().numpy() * self.y_train_std_ + self.y_train_mean_

    @torch.no_grad()
    def thompson_argmin_pathwise(
        self, X, n_samples: int = 1, top_k: int = 8, random_state=0,
        n_features: int = 1024, sample_mean: bool = True,
    ):
        """Per-draw top-k minimizer indices (n_samples, top_k), computed
        on the device: only the index table reaches the host.

        ``sample_mean=True`` draws from the consensus GP (one set of
        features for all draws); ``sample_mean=False`` gives each draw a
        chain row (rows picked by a NumPy RandomState of the seed, as in
        the JAX package) and its own features
        (:func:`~bask_tpu_torch.models.pathwise.pathwise_topk_hyper`).
        The randoms come from a torch generator seeded with the seed."""
        from .pathwise import pathwise_topk, pathwise_topk_hyper

        spec = self._fused_spec()
        seed = self._seed(random_state)
        Xq = self._tensor(np.atleast_2d(X))
        if sample_mean:
            rand = self._pathwise_randoms(spec, seed, n_features, n_samples)
            idx = pathwise_topk(
                spec, self._tensor(self._theta), self._post_data, self._post.L,
                self._warp_tensor(Xq), rand, top_k,
            )
            return idx.cpu().numpy()
        rs = np.random.RandomState(seed)
        rows = self._tensor(self.chain_[rs.choice(len(self.chain_), n_samples, replace=True)])
        rand = self._pathwise_randoms(spec, seed, n_features, 1, batch=(n_samples,))
        idx = pathwise_topk_hyper(
            spec, rows, self._data, Xq, rand, self._n_warp(), top_k,
            n_real=len(self._y_orig),
        )
        return idx.cpu().numpy()

    def log_marginal_likelihood(self, theta=None):
        """The consensus LML, or the LML at ``theta`` on the posterior's
        (warped) data."""
        if theta is None:
            return self.log_marginal_likelihood_value_
        data = self._post_data if self._post_data is not None else self._data
        with torch.no_grad():
            return float(gpc.log_marginal_likelihood(self._spec, self._tensor(theta), data))

    # -- public warper API (reference bask/bayesgpr.py:249-316) ------------

    def create_warpers(self, alphas, betas):
        """Set the warp log-parameters (call :meth:`rewarp` afterwards)."""
        if not self.warp_inputs:
            return
        self.warp_alphas_ = np.array(alphas, dtype=float)
        self.warp_betas_ = np.array(betas, dtype=float)

    def rewarp(self):
        """Re-warp the training data after the warp parameters changed and
        refresh the factorized posterior."""
        if self.warp_inputs and self.warp_alphas_ is not None:
            self._refresh_posterior(with_lml=False)

    @property
    def warpers_(self):
        """Per-column warp callables (scipy Beta CDFs), reference-compatible."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        import scipy.stats as st

        return [
            st.beta(a=np.exp(a), b=np.exp(b)).cdf
            for a, b in zip(self.warp_alphas_, self.warp_betas_)
        ]

    @property
    def unwarpers_(self):
        """Per-column unwarp callables (scipy Beta PPFs), reference-compatible."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        import scipy.stats as st

        return [
            st.beta(a=np.exp(a), b=np.exp(b)).ppf
            for a, b in zip(self.warp_alphas_, self.warp_betas_)
        ]

    def warp(self, X):
        """X (n, d) in the consensus-warped space (NumPy in, NumPy out);
        X itself without warping."""
        params = self._warp_params()
        if params is None:
            return X
        return wp.warp(self._tensor(X), *params).cpu().double().numpy()

    def unwarp(self, X):
        """The inverse of :meth:`warp`."""
        params = self._warp_params()
        if params is None:
            return X
        return wp.unwarp(self._tensor(X), *params).cpu().double().numpy()
