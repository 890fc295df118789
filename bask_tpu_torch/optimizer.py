"""Ask/tell Bayesian optimization loop.

PyTorch counterpart of :class:`bask_tpu.optimizer.Optimizer` (single-
point ``ask``, ``tell`` and ``run``). Each ``tell`` past the initial
design refits the GP (the first time a cold ``fit``: ML-II, then sampling
to split R-hat 1.1 in 300-step legs; afterwards a warm ``sample``), then
evaluates the acquisition on a fresh candidate grid and caches its argmax
for the next ``ask``.

Not ported yet: batch ``ask``, the acquisition polish and the stopping
diagnostics (probability of optimality, expected optimality gap,
optimum intervals).
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
from .utils.init_seq import r2_sequence, sb_sequence
from .utils.priors import construct_default_kernel
from .utils.result import create_result

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
    and ``gp_sample_kwargs`` forwarded to every refit. ``device`` and
    ``dtype`` place the GP; ``device=None`` is the CUDA card. Unknown
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
        gp_sample_kwargs: Optional[dict] = None,
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
        if gp_kernel is None:
            gp_kernel = construct_default_kernel(
                list(range(self.space.transformed_n_dims))
            )
        self.gp = BayesGPR(
            kernel=gp_kernel,
            random_state=self.rng.randint(0, np.iinfo(np.int32).max),
            device=device,
            dtype=dtype,
            **dict(gp_kwargs or {}),
        )
        self.gp_priors = gp_priors
        self.gp_sample_kwargs = dict(gp_sample_kwargs or {})
        self.Xi = []
        self.yi = []
        self.noisei = []
        self._next_x = None

    def ask(self, n_points: int = 1):
        """The next point to evaluate: an initial-design point, or the
        acquisition argmax cached by the last ``tell``."""
        if n_points != 1:
            raise NotImplementedError("batch ask is not ported yet")
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

    def _candidate_grid(self):
        """Fresh uniform candidate grid in the (unwarped) GP space; with
        input warping, uniform in the warped space and mapped back, so the
        density follows the learned warp (reference
        ``bask/optimizer.py:353-363``)."""
        if self.gp.warp_inputs:
            d = self.space.transformed_n_dims
            return self.gp.unwarp(self.rng.uniform(size=(self.n_points, d)))
        return self.space.transform(
            self.space.rvs(n_samples=self.n_points, random_state=self.rng)
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
    ):
        """Report objective value(s); past the initial design, refit the GP
        and compute the next proposal. Returns a scipy OptimizeResult."""
        if replace:
            self.Xi, self.yi, self.noisei = [], [], []
            self._n_initial_points = self.n_initial_points_
        xs, ys, ns = self._coerce_observations(x, y, noise_vector)
        self.Xi += xs
        self.yi += ys
        self.noisei += ns
        self._n_initial_points -= len(ys)

        if fit and self._n_initial_points <= 0:
            t_fit = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                common = dict(
                    noise_vector=np.asarray(self.noisei),
                    priors=self.gp_priors,
                    n_desired_samples=gp_samples,
                    n_burnin=gp_burnin,
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
            t_acq = time.perf_counter()
            X = self._candidate_grid()
            acq_seed = self.rng.randint(0, np.iinfo(np.int32).max)
            acq_values = acq_mod.evaluate_acquisitions_fused(
                X=X,
                gpr=self.gp,
                acq=self.acq_func,
                n_samples=n_samples,
                random_state=acq_seed,
                **self.acq_func_kwargs,
            ).flatten()
            self._next_x = self.space.inverse_transform(
                X[np.argmax(acq_values)][None, :]
            )[0]
            done = time.perf_counter()
            self.last_timings_ = {
                "gp_fit_s": t_acq - t_fit,
                "acquisition_s": done - t_acq,
                "mcmc_acceptance": self.gp.n_accepted_ / max(self.gp.n_proposals_, 1),
            }
        return create_result(self.Xi, self.yi, self.space, self.rng, models=[self.gp])

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
