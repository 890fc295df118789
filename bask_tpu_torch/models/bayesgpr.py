"""Fully-Bayesian GP regressor with hyperparameter MCMC on the device.

PyTorch counterpart of :class:`bask_tpu.models.bayesgpr.BayesGPR` (the
default path): an ML-II warm start on the first fit, then an ensemble
sampler over the kernel hyperparameters whose batched log-probability is
:func:`bask_tpu_torch.ops.linalg.batched_lml`, the consensus model at
the geometric median of the kept chain, and predictions from it.

``sample`` runs chain -> kept steps -> geometric median -> consensus
factorization (3-rung jitter ladder) -> consensus LML, the sequence of
the JAX package's fused sample program. The model lives on ``device`` in
``dtype``; on a CUDA device in float32 the chain's grams and
factorization bases run in the package's hand-written kernels.

Not ported: input warping, row-sharded mode, pathwise draws, Laplace
chain init, the on-device ML-II, ML-II subsampling, host-callback priors
and serialization.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops import kernels as bk
from ..ops.linalg import batched_lml, cho_solve_masked, masked_cholesky, masked_gram
from ..parallel.mcmc import _MOVE_PARAMS, _normalize_moves, flatten_chain, run_ensemble
from ..utils.median import geometric_median
from ..utils.priors import guess_priors
from . import gp as gpc

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


def _make_log_prob_batch(kernel, priors, data, n_real):
    """Batched (W, D) -> (W,) log-posterior for the ensemble sampler."""

    def log_prob_batch(xs):
        lp = _eval_priors(priors, xs)
        lml = batched_lml(
            kernel, xs, data.X, data.y, data.alpha_diag, data.mask, n_real=n_real
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
    float32); ``noise="gaussian"`` appends a WhiteKernel at fit time.
    ``fit`` always runs the ML-II warm start. ``moves``
    picks the ensemble moves (default ``"auto"``: demix at W >= 6).
    ``device`` and ``dtype`` place the training data, the chain and the
    posterior. Host-side state (``theta``, ``chain_``, ``pos_``) is
    NumPy, as in the JAX package.
    """

    def __init__(
        self,
        kernel: Optional[bk.Kernel] = None,
        alpha: float = 1e-10,
        random_state=None,
        noise: Optional[str] = "gaussian",
        moves="auto",
        device="cpu",
        dtype=torch.float32,
    ):
        if kernel is None:
            kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(1.0, (1e-5, 1e5))
        self._user_kernel = kernel
        self.alpha = alpha
        self.noise = noise
        self.moves = _canonical_moves(moves)
        self.device = torch.device(device)
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
        self.until_rhat_result_ = None
        self._theta: Optional[np.ndarray] = None
        self._data: Optional[gpc.GPData] = None
        self._post: Optional[gpc.GPPosterior] = None
        self._X_orig: Optional[np.ndarray] = None
        self._y_orig: Optional[np.ndarray] = None
        self._noise_vector: Optional[np.ndarray] = None
        self._priors_cache = None
        # y is not normalized by default; fitted JAX state may carry a
        # normalization (convert.fitted_bayesgpr)
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

    def _refresh_posterior(self):
        if self._theta is None or self._data is None:
            return
        self._post, self._consensus_lml_ = _consensus_body(
            self._spec, self._tensor(self._theta), self._data
        )

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
            moves=moves, warn_rhat=None, **kwargs,
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
        n_dim = self._spec.n_theta
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
            pos = theta[None, :] + 1e-2 * self.random_state.randn(n_walkers, n_dim)
        seed = int(self.random_state.randint(0, 2**31 - 1))

        moves = _canonical_moves(moves) if moves is not None else self.moves
        if moves == "auto":
            w = pos.shape[0]
            moves = _MOVE_ALIASES["demix"] if w >= 6 else (("de", 1.0),) if w >= 4 else None

        log_prob = _make_log_prob_batch(
            self._spec, priors, self._data, n_real=len(self._y_orig)
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
        if homogeneous_add and getattr(self, "n_proposals_", 0):
            self.n_accepted_ += int(final.accepted)
            self.n_proposals_ += n_steps * w_act
        else:
            self.n_accepted_ = int(final.accepted)
            self.n_proposals_ = n_steps * w_act
        if _consensus:
            self._set_consensus_from_flat(flat)
        return self

    def _set_consensus_from_flat(self, flat):
        """Geometric-median consensus, posterior refresh and consensus LML
        over a flat (device) chain."""
        theta_med = geometric_median(flat)
        post, lml = _consensus_body(self._spec, theta_med, self._data)
        self._theta = theta_med.cpu().double().numpy()
        widx = self.white_index_
        if widx is not None:
            self.noise_ = float(np.exp(self._theta[widx]))
        self._post = post
        self._consensus_lml_ = lml
        self.log_marginal_likelihood_value_ = float(lml)
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
        position=None,
        **kwargs,
    ):
        """ML-II warm start, then hyperposterior sampling."""
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
            position=position,
            add=False,
            **kwargs,
        )

    # -- prediction --------------------------------------------------------

    def _check_fitted(self):
        if self._post is None:
            raise ValueError("the model is not fitted: call fit first")

    @torch.no_grad()
    def predict(self, X, return_std: bool = False, return_cov: bool = False):
        """Predictive mean (and std or covariance) of the consensus GP."""
        self._check_fitted()
        out = gpc.predict(
            self._spec, self._tensor(self._theta), self._post, self._data,
            self._tensor(np.atleast_2d(X)), return_std=return_std,
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
        ``sample_mean=True``, else one draw per random chain row."""
        self._check_fitted()
        seed = self._seed(random_state)
        Xq = self._tensor(np.atleast_2d(X))
        widx = self.white_index_
        if sample_mean:
            theta = self._tensor(self._theta)
            td = theta if noise else gpc.noise_free_theta(self._spec, theta, widx)
            z = self._normals(seed, (Xq.shape[0], n_samples))
            return gpc.sample_y(self._spec, td, self._post, self._data, Xq, z).cpu().numpy()
        rs = np.random.RandomState(seed)
        idx = rs.choice(len(self.chain_), size=n_samples, replace=True)
        rows = self._tensor(self.chain_[idx])
        grams = gpc.fused_marginal_grams(self._spec, rows, self._data, len(self._y_orig))
        post, invs = gpc.posterior_and_invs(self._spec, rows, self._data, Kp=grams)
        td = rows if noise else gpc.noise_free_theta(self._spec, rows, widx)
        z = self._normals(seed, (n_samples, Xq.shape[0], 1))
        draws = gpc.sample_y(self._spec, td, post, self._data, Xq, z, invs=invs)
        return draws[..., 0].T.cpu().numpy()
