"""Prediction gradients, predictions before fit, and K_inv_ of the port's
BayesGPR against bask_tpu at float64: a JAX model fitted on 30 noisy 2-D
points (plain and input-warped) is carried into the port by ``convert``;
the gradients of the predictive mean and std in each query point agree
with JAX's and with central differences."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import BayesGPR, convert  # noqa: E402

KERNEL = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
GRID = np.random.RandomState(1).uniform(0.05, 0.95, size=(9, 2))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "warped"])
def fitted(request):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(30, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.randn(30)
    gp = JaxBayesGPR(kernel=KERNEL, normalize_y=True, warp_inputs=request.param,
                     random_state=0)
    gp.fit(X, y, n_desired_samples=64, n_burnin=5, n_walkers_per_thread=16,
           progress=False, warn_rhat=None)
    return gp, convert.bayesgpr_from_jax(gp, device="cpu")


def test_predict_gradients_match_jax(fitted):
    """Mean, std and both gradients within 1e-8 relative of JAX's."""
    gp, ours = fitted
    got = ours.predict(GRID, return_std=True, return_mean_grad=True, return_std_grad=True)
    want = gp.predict(GRID, return_std=True, return_mean_grad=True, return_std_grad=True)
    assert len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-10)
    mg_only = ours.predict(GRID, return_mean_grad=True)
    np.testing.assert_allclose(mg_only[1], np.asarray(want[2]), rtol=1e-8, atol=1e-10)


def test_predict_gradients_match_central_differences(fitted):
    """Against central differences of the port's own mean and std
    (h = 1e-6 in float64: agreement to ~1e-6 relative)."""
    _, ours = fitted
    _, _, mg, sg = ours.predict(GRID, return_std=True, return_mean_grad=True,
                                return_std_grad=True)
    h = 1e-6
    for i in range(GRID.shape[1]):
        e = np.zeros(GRID.shape[1])
        e[i] = h
        mp, sp_ = ours.predict(GRID + e, return_std=True)
        mm, sm = ours.predict(GRID - e, return_std=True)
        np.testing.assert_allclose(mg[:, i], (mp - mm) / (2 * h), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(sg[:, i], (sp_ - sm) / (2 * h), rtol=1e-5, atol=1e-7)


def test_noise_free_gradients_and_k_inv(fitted):
    gp, ours = fitted
    with ours.noise_set_to_zero(), gp.noise_set_to_zero():
        got = ours.predict(GRID, return_std=True, return_std_grad=True)
        want = gp.predict(GRID, return_std=True, return_std_grad=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(ours.K_inv_, gp.K_inv_, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(ours.y_train_, gp.y_train_, rtol=1e-14)


def test_predictions_before_fit_are_the_prior():
    """An unfitted model predicts from the GP prior (the user kernel at
    theta0, no White), as JAX's does; draws have the prior covariance."""
    spec = jk.ConstantKernel(1.5, (0.1, 2.0)) * jk.Matern((0.3, 0.4), (0.05, 2.0), nu=1.5)
    gp = JaxBayesGPR(kernel=spec, random_state=0)
    ours = BayesGPR(convert.kernel_spec(spec), random_state=0, device="cpu",
                    dtype=torch.float64)
    for kw in ({}, {"return_std": True}, {"return_cov": True},
               {"return_std": True, "return_mean_grad": True, "return_std_grad": True}):
        got, want = ours.predict(GRID, **kw), gp.predict(GRID, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-14)
    draws = ours.sample_y(GRID[:3], n_samples=20000, random_state=4)
    assert draws.shape == (3, 20000)
    cov = np.asarray(gp.predict(GRID[:3], return_cov=True)[1])
    # Monte-Carlo error of a covariance from 20,000 draws: ~1.5 / sqrt(2e4)
    np.testing.assert_allclose(np.cov(draws), cov, atol=0.05)
    assert ours.sample_y(GRID[:3], n_samples=2, random_state=4).shape == (3, 2)
