"""BayesSearchCV on the port's Optimizer, on the CPU (the card's machine
has no scikit-learn): the iris bar of tests/test_searchcv.py (score >
0.89 for both return policies) at n_iter = 11 with short chains, the step
parameters, batch calls and dimension names, as the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("sklearn")

from sklearn.datasets import load_iris  # noqa: E402
from sklearn.model_selection import train_test_split  # noqa: E402
from sklearn.svm import SVC  # noqa: E402

from bask_tpu_torch import BayesSearchCV, PVRS  # noqa: E402
from bask_tpu_torch.space import Categorical, Integer, Real  # noqa: E402

CPU = {"device": "cpu", "dtype": torch.float64,
       "gp_sample_kwargs": {"until_rhat": None, "n_walkers_per_thread": 16}}


@pytest.mark.parametrize("return_policy", ["best_setting", "best_mean"])
def test_searchcv_iris(return_policy):
    X, y = load_iris(return_X_y=True)
    X_train, X_test, y_train, y_test = train_test_split(X, y, train_size=0.75, random_state=0)
    opt = BayesSearchCV(
        SVC(),
        {
            "C": Real(1e-6, 1e6, prior="log-uniform"),
            "gamma": Real(1e-6, 1e1, prior="log-uniform"),
            "degree": Integer(1, 8),
            "kernel": Categorical(["linear", "poly", "rbf"]),
        },
        n_iter=11,
        optimizer_kwargs=dict(CPU, gp_samples=32, gp_burnin=2),
        return_policy=return_policy,
        random_state=0,
    )
    opt.fit(X_train, y_train)
    assert opt.score(X_test, y_test) > 0.89
    assert len(opt.cv_results_["mean_test_score"]) == 11
    assert hasattr(opt, "best_params_")
    assert opt.optimizers_[-1][1].gp.chain_ is not None


def test_step_defaults_batches_and_names():
    """n_samples/gp_samples/gp_burnin come out of optimizer_kwargs with
    defaults 0/100/5, PVRS is the default acquisition, n_iter counts
    candidates in n_points-sized calls, and dimensions get the sorted
    parameter names."""
    searcher = BayesSearchCV(SVC(), {"C": Real(1e-3, 1e3, prior="log-uniform")}, n_iter=1,
                             optimizer_kwargs=CPU)
    calls = []

    def fake_evaluate(params_list):
        calls.append(len(params_list))
        return {"mean_test_score": np.asarray([0.5] * sum(calls))}

    searcher._run_search(fake_evaluate)
    assert (searcher.n_samples_, searcher.gp_samples_, searcher.gp_burnin_) == (0, 100, 5)
    assert isinstance(searcher.optimizers_[-1][1].acq_func, PVRS)
    batched = BayesSearchCV(SVC(), {"C": Real(1e-3, 1e3, prior="log-uniform")}, n_iter=5,
                            n_points=2, random_state=3,
                            optimizer_kwargs=dict(CPU, gp_samples=20, gp_burnin=1))
    calls.clear()
    batched._run_search(fake_evaluate)
    assert calls == [2, 2, 1]
    assert len(batched.optimizers_[-1][1].Xi) == 5
    named = BayesSearchCV(SVC(), {"gamma": Real(1e-4, 1.0, prior="log-uniform"),
                                  "degree": Integer(1, 5)}, n_iter=1)
    named._rng = np.random.RandomState(0)
    named.optimizer_kwargs_ = dict(CPU)
    optimizer = named._make_optimizer({"gamma": Real(1e-4, 1.0, prior="log-uniform"),
                                       "degree": Integer(1, 5)})
    assert [d.name for d in optimizer.space.dimensions] == ["degree", "gamma"]
