"""sklearn-compatible hyperparameter search driven by the port's Optimizer.

PyTorch counterpart of :class:`bask_tpu.searchcv.BayesSearchCV`, built on
sklearn's ``BaseSearchCV``: the candidate evaluation, cross-validation and
refit machinery is sklearn's; the point proposal is the fully-Bayesian
ask/tell loop of :class:`bask_tpu_torch.Optimizer` (one candidate per
iteration, evaluated by ``evaluate_candidates``, fed back with the
negated mean test score). The Optimizer's ``device`` and ``dtype`` go in
``optimizer_kwargs`` (``device=None`` is the CUDA card).

This module imports scikit-learn; ``import bask_tpu_torch`` does not
import this module until ``bask_tpu_torch.BayesSearchCV`` is first read.

``return_policy="best_mean"`` selects the evaluated setting whose GP
posterior mean is best instead of the best single observation — the
robust choice for noisy targets (reference ``bask/searchcv.py:55-68``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from sklearn.model_selection._search import BaseSearchCV

from .optimizer import Optimizer
from .space import dimensions_aslist, point_asdict

__all__ = ["BayesSearchCV"]


class BayesSearchCV(BaseSearchCV):
    """Fully-Bayesian cross-validated hyperparameter search.

    Parameters mirror the JAX package's: ``estimator``, ``search_spaces``
    (dict / list of dicts / list of (dict, n_iter) tuples with parameter
    name -> Dimension), ``optimizer_kwargs`` forwarded to
    :class:`bask_tpu_torch.Optimizer` (``n_samples``, ``gp_samples``,
    ``gp_burnin`` are extracted as step parameters), ``n_iter``,
    ``return_policy`` in {"best_setting", "best_mean"}, plus the usual
    sklearn CV arguments.

    ``n_points > 1`` evaluates that many candidates per GP refit: the
    batch comes from one Thompson-sampling ``ask(n_points)`` and is
    handed to ``evaluate_candidates`` in one call, so sklearn's ``n_jobs``
    parallelizes the CV fits across candidates. ``n_iter`` counts total
    candidate evaluations.
    """

    def __init__(
        self,
        estimator,
        search_spaces,
        optimizer_kwargs: Optional[dict] = None,
        n_iter: int = 50,
        return_policy: str = "best_setting",
        scoring=None,
        fit_params=None,
        n_jobs: int = 1,
        n_points: int = 1,
        iid: bool = True,
        refit: bool = True,
        cv=None,
        verbose: int = 0,
        pre_dispatch="2*n_jobs",
        random_state=None,
        error_score="raise",
        return_train_score: bool = False,
    ):
        self.search_spaces = search_spaces
        self.optimizer_kwargs = optimizer_kwargs
        self.n_iter = n_iter
        self.return_policy = return_policy
        self.n_points = n_points
        self.iid = iid
        self.random_state = random_state
        self.fit_params = fit_params
        super().__init__(
            estimator=estimator,
            scoring=scoring,
            n_jobs=n_jobs,
            refit=refit,
            cv=cv,
            verbose=verbose,
            pre_dispatch=pre_dispatch,
            error_score=error_score,
            return_train_score=return_train_score,
        )

    def fit(self, X, y=None, *, groups=None, **fit_params):
        """Fit with constructor-level ``fit_params`` merged in (sklearn's
        BaseSearchCV takes them per ``fit`` call only); call-time params
        win."""
        if self.fit_params:
            fit_params = {**self.fit_params, **fit_params}
        return super().fit(X, y=y, groups=groups, **fit_params)

    # -- search space handling --------------------------------------------

    def _normalized_spaces(self):
        """-> list of (search_space_dict, n_iter)."""
        spaces = self.search_spaces
        if isinstance(spaces, dict):
            return [(spaces, self.n_iter)]
        out = []
        for entry in spaces:
            if isinstance(entry, tuple) and len(entry) == 2:
                out.append((entry[0], int(entry[1])))
            else:
                out.append((entry, self.n_iter))
        return out

    def _make_optimizer(self, params_space: dict) -> Optimizer:
        kwargs = dict(self.optimizer_kwargs_)
        kwargs["dimensions"] = dimensions_aslist(params_space)
        kwargs.setdefault(
            "random_state", self._rng.randint(0, np.iinfo(np.int32).max)
        )
        optimizer = Optimizer(**kwargs)
        for name, dim in zip(
            sorted(params_space.keys()), optimizer.space.dimensions
        ):
            if dim.name is None:
                dim.name = name
        return optimizer

    # -- sklearn hook ------------------------------------------------------

    def _run_search(self, evaluate_candidates):
        self._rng = np.random.RandomState(self.random_state)
        kwargs = dict(self.optimizer_kwargs or {})
        self.n_samples_ = kwargs.pop("n_samples", 0)
        self.gp_samples_ = kwargs.pop("gp_samples", 100)
        self.gp_burnin_ = kwargs.pop("gp_burnin", 5)
        kwargs.setdefault("acq_func", "pvrs")
        self.optimizer_kwargs_ = kwargs

        n_points = max(1, int(self.n_points))
        self.optimizers_ = []
        for space, n_iter in self._normalized_spaces():
            optimizer = self._make_optimizer(space)
            self.optimizers_.append((space, optimizer))
            remaining = n_iter
            while remaining > 0:
                k = min(n_points, remaining)
                # a batch goes to evaluate_candidates in one call, so
                # sklearn's n_jobs spreads its CV fits across workers
                xs = [optimizer.ask()] if k == 1 else optimizer.ask(k)
                xs = [[np.asarray(v).item() for v in x] for x in xs]
                results = evaluate_candidates(
                    [point_asdict(space, x) for x in xs]
                )
                scores = np.asarray(
                    results["mean_test_score"][-len(xs):], dtype=float
                )
                if not np.isfinite(scores).all():
                    fill = np.nanmin(results["mean_test_score"]) - 1.0
                    if not np.isfinite(fill):
                        fill = 0.0
                    scores = np.where(np.isfinite(scores), scores, fill)
                ys = [-float(s) for s in scores]
                optimizer.tell(
                    xs if len(xs) > 1 else xs[0],
                    ys if len(xs) > 1 else ys[0],
                    n_samples=self.n_samples_,
                    gp_samples=self.gp_samples_,
                    gp_burnin=self.gp_burnin_,
                )
                remaining -= k

    def _select_best_index(self, refit, refit_metric, results):
        """Honor ``return_policy`` when picking the incumbent."""
        if callable(refit):
            # sklearn's callable-refit contract: the user function picks
            # the index; return_policy must not override it
            return BaseSearchCV._select_best_index(
                refit, refit_metric, results
            )
        default = results[f"rank_test_{refit_metric}"].argmin()
        if self.return_policy != "best_mean" or not getattr(
            self, "optimizers_", None
        ):
            return default
        # Best-mean policy: among evaluated candidates of the last space,
        # choose the one whose GP posterior mean (of the negated score)
        # is lowest.
        space, optimizer = self.optimizers_[-1]
        if optimizer.gp.chain_ is None:
            return default
        Xt = optimizer.space.transform(optimizer.Xi)
        mu = optimizer.gp.predict(Xt)
        best_x = optimizer.Xi[int(np.argmin(mu))]
        params = point_asdict(space, best_x)
        for i, p in enumerate(results["params"]):
            if all(p.get(k) == v for k, v in params.items()):
                return i
        return default
