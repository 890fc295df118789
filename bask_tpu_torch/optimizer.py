"""Ask/tell Bayesian optimization loop with stopping-rule diagnostics.

PyTorch counterpart of :class:`bask_tpu.optimizer.Optimizer`. Each
``tell`` past the initial design refits the GP (the first time a cold
``fit``: ML-II, then sampling to split R-hat 1.1 in 300-step legs;
afterwards a warm ``sample``), then evaluates the acquisition on a fresh
candidate grid (the legacy dispatcher where the fused pass declines),
optionally polishes the argmax by gradient ascent (``acq_polish``) and
caches it for the next ``ask``. ``ask(n_points > 1)`` proposes a batch:
one minimizer per Thompson draw, by pathwise sampling above 2,048
candidates. ``probability_of_optimality``, ``expected_optimality_gap``
and ``optimum_intervals`` are the stopping diagnostics. With tracing on
(:mod:`bask_tpu_torch.utils.trace`) a tell's refit and acquisition are the
spans ``span.opt.refit`` and ``span.opt.acquisition``, on the same clock
readings as ``last_timings_``.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import acquisition as acq_mod
from .models.bayesgpr import BayesGPR
from .space import normalize_dimensions
from .utils import trace
from .utils.init_seq import r2_sequence, sb_sequence
from .utils.priors import construct_default_kernel
from .utils.result import create_result, expected_minimum
from .utils.stats import hdi

__all__ = ["Optimizer", "ACQUISITION_FUNC"]

ACQUISITION_FUNC = {
    "ei": acq_mod.ExpectedImprovement(),
    "lcb": acq_mod.LCB(),
    "mean": acq_mod.Expectation(),
    "mes": acq_mod.MaxValueSearch(),
    "pvrs": acq_mod.PVRS(),
    "ts": acq_mod.ThompsonSampling(),
    "ttei": acq_mod.TopTwoEI(),
    "vr": acq_mod.VarianceReduction(),
}


def _is_listlike(x):
    return isinstance(x, (list, tuple, np.ndarray))


def _is_2dlistlike(x):
    return _is_listlike(x) and len(x) > 0 and all(_is_listlike(p) for p in x)


class Optimizer:
    """Stepwise Bayesian optimization over a search space.

    ``dimensions`` (tuples / category lists / Dimension objects),
    ``n_points`` candidate-grid size, ``n_initial_points`` with
    ``init_strategy`` in {"sb", "r2", "random"}, ``gp_kernel`` /
    ``gp_kwargs`` (e.g. ``{"warp_inputs": True}``) / ``gp_priors``,
    ``acq_func`` (a key of :data:`ACQUISITION_FUNC` or an
    :class:`~bask_tpu_torch.acquisition.Acquisition`), ``random_state``,
    and ``gp_sample_kwargs`` forwarded to every refit. ``acq_polish``
    Adam steps (0: off) refine the grid argmax from the top
    ``acq_polish_starts`` grid points at rate ``acq_polish_lr``; where the
    acquisition or the space gives no differentiable surface the grid
    argmax is used, with a warning once. ``device`` and ``dtype`` place
    the GP; ``device=None`` is the CUDA card. ``mesh``: a 1-axis
    :class:`~bask_tpu_torch.parallel.mesh.Mesh`; every GP refit shards its
    walker ensemble over it (``BayesGPR.sample(mesh=)``, the same chain as
    unsharded), and the marginal acquisitions predict over the candidate
    grid sharded over it (``evaluate_acquisitions_fused(mesh=)``). Unknown
    kwargs are tolerated.
    """

    def __init__(
        self,
        dimensions,
        n_points: int = 500,
        n_initial_points: int = 10,
        init_strategy: Optional[str] = "sb",
        gp_kernel=None,
        gp_kwargs: Optional[dict] = None,
        gp_priors=None,
        acq_func="pvrs",
        acq_func_kwargs: Optional[dict] = None,
        random_state=None,
        mesh=None,
        gp_sample_kwargs: Optional[dict] = None,
        acq_polish: int = 0,
        acq_polish_starts: int = 4,
        acq_polish_lr: float = 0.05,
        device=None,
        dtype=torch.float32,
        **kwargs,
    ):
        if isinstance(random_state, np.random.RandomState):
            self.rng = random_state
        else:
            self.rng = np.random.RandomState(random_state)
        self.acq_func = acq_func if callable(acq_func) else ACQUISITION_FUNC[acq_func]
        self.acq_func_kwargs = acq_func_kwargs or {}
        self.space = normalize_dimensions(dimensions)
        self._n_initial_points = n_initial_points
        self.n_initial_points_ = n_initial_points
        self.init_strategy = init_strategy
        if init_strategy == "r2":
            self._initial_points = self.space.inverse_transform(
                r2_sequence(n=n_initial_points, d=self.space.transformed_n_dims)
            )
        elif init_strategy == "sb":
            self._init_rng = np.random.RandomState(self.rng.randint(2**31))
        self.n_points = n_points
        gp_kwargs = dict(gp_kwargs or {})
        if gp_kwargs.get("row_mesh") is not None:
            # the acquisition marginalizes per-draw (W, n, n) posteriors,
            # which row mode exists to avoid, and a BO loop's n never
            # reaches the beyond-one-card regime: shard walkers instead
            raise ValueError(
                "row_mesh is a BayesGPR regression-scale feature and is "
                "not supported inside Optimizer; use Optimizer(mesh=...) "
                "walker sharding for multi-device BO loops."
            )
        if gp_kernel is None:
            gp_kernel = construct_default_kernel(
                list(range(self.space.transformed_n_dims))
            )
        self.gp = BayesGPR(
            kernel=gp_kernel,
            random_state=self.rng.randint(0, np.iinfo(np.int32).max),
            device=device,
            dtype=dtype,
            **gp_kwargs,
        )
        self.gp_priors = gp_priors
        self.mesh = mesh
        self.gp_sample_kwargs = dict(gp_sample_kwargs or {})
        self.acq_polish = int(acq_polish)
        self.acq_polish_starts = int(acq_polish_starts)
        self.acq_polish_lr = float(acq_polish_lr)
        self._polish_noop_warned = False
        if self.acq_polish > 0 and self.space.is_partly_categorical:
            warnings.warn(
                "acq_polish is ignored on (partly) categorical spaces: "
                "the acquisition surface is not differentiable across "
                "category one-hots; the grid argmax is used.",
                UserWarning,
            )
            self._polish_noop_warned = True
        self.Xi = []
        self.yi = []
        self.noisei = []
        self._next_x = None

    def ask(self, n_points: int = 1):
        """The next point to evaluate: an initial-design point, or the
        acquisition argmax cached by the last ``tell``. ``n_points > 1``
        gives a batch (:meth:`_ask_batch`)."""
        with trace.span("span.opt.ask"):
            if n_points > 1:
                return self._ask_batch(n_points)
            if self._n_initial_points > 0:
                if self.init_strategy == "r2":
                    return self._initial_points[self._n_initial_points - 1]
                if self.init_strategy == "sb":
                    existing = self.space.transform(self.Xi) if len(self.Xi) else None
                    pts = sb_sequence(
                        n=len(self.Xi) + 1,
                        d=self.space.transformed_n_dims,
                        existing_points=existing,
                        random_state=self._init_rng.randint(2**31),
                    )
                    return self.space.inverse_transform(np.atleast_2d(pts[len(self.Xi)]))[0]
                return self.space.rvs(random_state=self.rng)[0]
            if self.gp.kernel_ is None:
                raise RuntimeError("Initialization is finished, but no model has been fit.")
            return self._next_x

    def _ask_batch(self, n_points: int):
        """A batch of ``n_points``: during the initial design its next
        points; after it, one candidate per Thompson draw of the GP over a
        fresh candidate grid. Above 2,048 candidates the draws are
        pathwise (each with its own chain row, top-k on the device);
        below, exact joint draws. A duplicate argmin is replaced by the
        best remaining candidate of its draw."""
        if self._n_initial_points > 0:
            if self.init_strategy == "r2":
                out = []
                for k in range(n_points):
                    idx = self._n_initial_points - 1 - k
                    if idx >= 0:
                        out.append(self._initial_points[idx])
                    else:
                        out.append(self.space.rvs(random_state=self.rng)[0])
                return out
            if self.init_strategy == "sb":
                existing = self.space.transform(self.Xi) if len(self.Xi) else None
                pts = sb_sequence(
                    n=len(self.Xi) + n_points,
                    d=self.space.transformed_n_dims,
                    existing_points=existing,
                    random_state=self._init_rng.randint(2**31),
                )
                return self.space.inverse_transform(pts[len(self.Xi) :])
            return self.space.rvs(n_samples=n_points, random_state=self.rng)
        if self.gp.kernel_ is None:
            raise RuntimeError("Initialization is finished, but no model has been fit.")
        X = self._candidate_grid()
        if n_points > len(X):
            raise ValueError(
                f"ask(n_points={n_points}) exceeds the candidate grid "
                f"size ({len(X)}); raise Optimizer(n_points=...)"
            )
        seed = self.rng.randint(0, np.iinfo(np.int32).max)
        if len(X) > 2048:
            try:
                order = self.gp.thompson_argmin_pathwise(
                    X, n_samples=n_points, top_k=min(max(2 * n_points, 8), len(X)),
                    random_state=seed, sample_mean=False,
                ).T  # (k, n_points)
            except NotImplementedError:
                # no pathwise draws for this kernel: exact draws on a
                # subsample, so 65k candidates do not need a 65k x 65k
                # covariance per draw
                keep = self.rng.choice(len(X), size=max(2048, n_points), replace=False)
                X = X[keep]
                order = np.argsort(self.gp.sample_y(X, n_samples=n_points, random_state=seed), axis=0)
        else:
            order = np.argsort(self.gp.sample_y(X, n_samples=n_points, random_state=seed), axis=0)
        chosen, used = [], set()
        for j in range(n_points):
            picked = next((int(i) for i in order[:, j] if int(i) not in used), None)
            if picked is None:  # all of this draw's top-k already taken
                picked = next(i for i in range(len(X)) if i not in used)
            used.add(picked)
            chosen.append(picked)
        return self.space.inverse_transform(X[chosen])

    def _candidate_grid(self):
        """Fresh uniform candidate grid in the (unwarped) GP space; with
        input warping, uniform in the warped space and mapped back, so the
        density follows the learned warp (reference
        ``bask/optimizer.py:353-363``)."""
        with trace.span("span.opt.grid"):
            if self.gp.warp_inputs:
                d = self.space.transformed_n_dims
                return self.gp.unwarp(self.rng.uniform(size=(self.n_points, d)))
            return self.space.rvs_transformed(
                n_samples=self.n_points, random_state=self.rng
            )

    @staticmethod
    def _coerce_observations(x, y, noise_vector):
        """One point (``x`` list-like, ``y`` scalar) or a batch (``x``
        2-D, ``y`` list-like) -> parallel lists (X, y, noise)."""
        if _is_listlike(y) and _is_2dlistlike(x):
            xs = [list(p) for p in x]
            ys = [float(v) for v in y]
            if noise_vector is None:
                return xs, ys, [0.0] * len(ys)
            if not _is_listlike(noise_vector) or len(noise_vector) != len(ys):
                raise ValueError("Vector of noise variances needs to be of equal length as y.")
            return xs, ys, [float(v) for v in noise_vector]
        if not _is_listlike(x):
            raise ValueError(f"Incompatible argument types: x ({type(x)}) and y ({type(y)})")
        if _is_listlike(noise_vector):
            raise ValueError("Vector of noise variances passed with a single point.")
        noise = 0.0 if noise_vector is None else float(noise_vector)
        return [list(x)], [float(y)], [noise]

    def tell(
        self,
        x,
        y,
        noise_vector=None,
        fit: bool = True,
        replace: bool = False,
        n_samples: int = 0,
        gp_samples: int = 100,
        gp_burnin: int = 10,
        progress: bool = False,
    ):
        """Report objective value(s); past the initial design, refit the GP
        (with a progress bar over the chain if ``progress``) and compute
        the next proposal. Returns a scipy OptimizeResult."""
        with trace.span("span.opt.tell"):
            if replace:
                self.Xi, self.yi, self.noisei = [], [], []
                self._n_initial_points = self.n_initial_points_
            xs, ys, ns = self._coerce_observations(x, y, noise_vector)
            self.Xi += xs
            self.yi += ys
            self.noisei += ns
            self._n_initial_points -= len(ys)

            if fit and self._n_initial_points <= 0:
                if (
                    self.gp_priors is not None
                    and not callable(self.gp_priors)
                    and len(self.gp_priors) != self.space.transformed_n_dims + 2
                ):
                    raise ValueError(
                        "The number of priors does not match the number of "
                        "dimensions + 2."
                    )
                t_fit = time.perf_counter_ns()
                with trace.span("span.opt.refit", t_fit) as refit:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        common = dict(
                            noise_vector=np.asarray(self.noisei),
                            priors=self.gp_priors,
                            n_desired_samples=gp_samples,
                            n_burnin=gp_burnin,
                            progress=progress,
                            mesh=self.mesh,
                        )
                        common.update(self.gp_sample_kwargs)
                        if self.gp.pos_ is None or replace:
                            # the cold fit samples to R-hat <= 1.1 by default
                            cold = dict(common)
                            if "until_rhat" not in cold:
                                cold["until_rhat"] = 1.1
                                cold.setdefault("max_extensions", 12)
                                cold.setdefault("extension_steps", 300)
                            self.gp.fit(self.space.transform(self.Xi), self.yi, **cold)
                        else:
                            self.gp.sample(self.space.transform(self.Xi), self.yi, **common)
                    ur = self.gp.until_rhat_result_
                    if ur is not None and not ur["converged"]:
                        warnings.warn(
                            f"GP refit did not reach R-hat <= {ur['threshold']} within "
                            f"the extension budget (max split R-hat {ur['rhat']:.3f} "
                            f"after {ur['steps']} kept steps); proceeding with the "
                            "consensus estimate.",
                            UserWarning,
                            stacklevel=2,
                        )
                    t_acq = time.perf_counter_ns()
                    refit.end_at(t_acq)
                with trace.span("span.opt.acquisition", t_acq) as acquisition:
                    X = self._candidate_grid()
                    acq_seed = self.rng.randint(0, np.iinfo(np.int32).max)
                    acq_out = acq_mod.evaluate_acquisitions_fused(
                        X=X,
                        gpr=self.gp,
                        acq=self.acq_func,
                        n_samples=n_samples,
                        random_state=acq_seed,
                        mesh=self.mesh,
                        **self.acq_func_kwargs,
                    )
                    if acq_out is None:
                        acq_out = acq_mod.evaluate_acquisitions(
                            X=X,
                            gpr=self.gp,
                            acquisition_functions=(self.acq_func,),
                            n_samples=n_samples,
                            random_state=acq_seed,
                            **self.acq_func_kwargs,
                        )
                    acq_values = acq_out.flatten()
                    best_x_t = X[np.argmax(acq_values)]
                    if self.acq_polish > 0 and not self.space.is_partly_categorical:
                        best_x_t = self._polish(X, acq_values, n_samples, best_x_t)
                    self._next_x = self.space.inverse_transform(best_x_t[None, :])[0]
                    done = time.perf_counter_ns()
                    acquisition.end_at(done)
                self.last_timings_ = {
                    "gp_fit_s": (t_acq - t_fit) / 1e9,
                    "acquisition_s": (done - t_acq) / 1e9,
                    "mcmc_acceptance": (
                        self.gp.n_accepted_ / self.gp.n_proposals_ if self.gp.n_proposals_ else None
                    ),
                }
            return create_result(self.Xi, self.yi, self.space, self.rng, models=[self.gp])

    def _polish(self, X, acq_values, n_samples, best_x_t):
        """Adam-polish from the top ``acq_polish_starts`` grid points (the
        argmax among them); the winner is picked within the polish's own
        draws. Warns once and keeps ``best_x_t`` where polish cannot run."""
        k = min(self.acq_polish_starts, len(X))
        top = np.argsort(acq_values)[-k:]
        polished = acq_mod.polish_acquisition(
            X[top],
            gpr=self.gp,
            acq=self.acq_func,
            n_samples=n_samples,
            random_state=self.rng.randint(0, np.iinfo(np.int32).max),
            n_steps=self.acq_polish,
            lr=self.acq_polish_lr,
            X_pool=X,
            **self.acq_func_kwargs,
        )
        if polished is not None:
            xb, vb = polished
            return xb[int(np.argmax(vb))]
        if not self._polish_noop_warned:
            self._polish_noop_warned = True
            reason = acq_mod.polish_noop_reason(
                self.acq_func, n_samples=n_samples, **self.acq_func_kwargs
            ) or "unsupported configuration"
            warnings.warn(
                f"acq_polish is inactive: {reason}; the grid argmax is used.",
                UserWarning,
            )
        return best_x_t

    def run(
        self,
        func,
        n_iter: int = 1,
        replace: bool = False,
        n_samples: int = 5,
        gp_samples: int = 100,
        gp_burnin: int = 10,
    ):
        """Drive the ask/tell loop on ``func`` (scalar or (value, noise))."""
        for _ in range(n_iter):
            x = self.ask()
            out = func(x)
            val, noise = out if hasattr(out, "__len__") else (out, 0.0)
            self.tell(
                x, val, noise_vector=noise, n_samples=n_samples,
                gp_samples=gp_samples, gp_burnin=gp_burnin, replace=replace,
            )
            replace = False
        return create_result(self.Xi, self.yi, self.space, self.rng, models=[self.gp])

    # -- stopping-rule diagnostics -----------------------------------------

    def probability_of_optimality(
        self,
        threshold,
        n_space_samples: int = 500,
        n_gp_samples: int = 200,
        n_random_starts: int = 100,
        use_mean_gp: bool = True,
        normalized_scores: bool = True,
        random_state=None,
    ):
        """Monte-Carlo probability that the current expected optimum is
        within ``threshold`` (one value or a list) of the true optimum
        under the GP posterior."""
        result = create_result(self.Xi, self.yi, self.space, self.rng, models=[self.gp])
        X_orig = [
            expected_minimum(
                result, random_state=random_state, n_random_starts=n_random_starts
            )[0]
        ]
        X_orig.extend(self.space.rvs(n_samples=n_space_samples, random_state=random_state))
        score_samples = self.gp.sample_y(
            self.space.transform(X_orig), n_samples=n_gp_samples,
            sample_mean=use_mean_gp, random_state=random_state,
        )
        if normalized_scores:
            std = np.std(score_samples, axis=0)
            std = np.where(std > 0, std, 1.0)
        thresholds = threshold if _is_listlike(threshold) else [threshold]
        probabilities = []
        for eps in thresholds:
            diff = score_samples[0][None, :] - score_samples
            if normalized_scores:
                diff = diff / std
            probabilities.append(float((((diff - eps).max(axis=0)) < 0.0).mean()))
        if len(probabilities) == 1:
            return probabilities[0]
        return probabilities

    def expected_optimality_gap(
        self,
        max_tries: int = 3,
        n_probabilities: int = 50,
        n_space_samples: int = 500,
        n_gp_samples: int = 200,
        n_random_starts: int = 100,
        tol: float = 0.01,
        use_mean_gp: bool = True,
        normalized_scores: bool = True,
        random_state=None,
    ):
        """Expected optimality gap: the gap CDF estimated by
        :meth:`probability_of_optimality`, integrated over thresholds up
        to the one where it nearly reaches 1."""
        from scipy.optimize import minimize_scalar

        if not isinstance(random_state, np.random.RandomState):
            random_state = np.random.RandomState(random_state)
        seed = random_state.randint(0, 2**31 - 1)
        common = dict(
            n_random_starts=n_random_starts, n_gp_samples=n_gp_samples,
            n_space_samples=n_space_samples, use_mean_gp=use_mean_gp,
            normalized_scores=normalized_scores, random_state=seed,
        )

        def func(threshold):
            prob = self.probability_of_optimality(threshold=threshold, **common)
            return (prob - 1.0) ** 2 + threshold**2 * 1e-3

        max_gap = float(np.max(self.yi) - np.min(self.yi))
        upper = None
        for _ in range(max_tries):
            try:
                upper = minimize_scalar(func, bounds=(0.0, max_gap), method="bounded", tol=tol).x
                break
            except ValueError:
                continue
        if upper is None:
            raise ValueError("Determining the upper threshold was not possible.")
        thresholds = list(np.linspace(0.0, upper, num=n_probabilities))
        probabilities = self.probability_of_optimality(thresholds, **common)
        gap = 0.0
        for i in range(len(probabilities) - 1):
            gap += (probabilities[i + 1] - probabilities[i]) * thresholds[i + 1]
        return gap

    def optimum_intervals(
        self,
        hdi_prob: float = 0.95,
        multimodal: bool = True,
        opt_samples: int = 200,
        space_samples: int = 500,
        only_mean: bool = True,
        random_state=None,
    ):
        """Highest-density intervals of the optimum's location, one per
        dimension, from the argmins of Thompson draws over a random
        sample of the space."""
        if self.space.is_partly_categorical:
            raise NotImplementedError(
                "Highest density intervals not supported for categorical dimensions."
            )
        X = self.space.rvs(n_samples=space_samples, random_state=random_state)
        Xt = self.space.transform(X)
        optimum_samples = self.gp.sample_y(
            Xt, sample_mean=only_mean, n_samples=opt_samples, random_state=random_state
        )
        X_opt = Xt[np.argmin(optimum_samples, axis=0)]
        intervals = []
        for i, col in enumerate(X_opt.T):
            raw = hdi(col, hdi_prob=hdi_prob, multimodal=multimodal)
            intervals.append(np.asarray(self.space.dimensions[i].inverse_transform(raw)))
        return intervals
