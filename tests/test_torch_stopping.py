"""The stopping diagnostics of the port against the JAX package: the
copied host estimators (HDI, ESS, IAT) on the same arrays to 1e-12,
``mcmc_diagnostics`` of a chain carried over by ``convert``, the
expected-minimum search from the same starts (x and fun within 1e-6),
and the Optimizer's ``probability_of_optimality``,
``expected_optimality_gap`` and ``optimum_intervals`` with ``sample_y``
stubbed by one shared array on both sides. Also ``log_marginal_likelihood
(theta=...)`` and ``noise_set_to_zero``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu import Optimizer as JaxOptimizer  # noqa: E402
from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.utils import diagnostics as jdiag  # noqa: E402
from bask_tpu.utils import result as jres  # noqa: E402
from bask_tpu.utils import stats as jstats  # noqa: E402
from bask_tpu_torch import Optimizer, convert  # noqa: E402
from bask_tpu_torch.utils import diagnostics as tdiag  # noqa: E402
from bask_tpu_torch.utils import result as tres  # noqa: E402
from bask_tpu_torch.utils import stats as tstats  # noqa: E402

DIMS = [(0.0, 1.0), (-1.0, 1.0)]
SHARED = np.random.RandomState(4).randn(600, 300)


@pytest.fixture(scope="module")
def fitted():
    """A JAX BayesGPR fitted at float64 on 30 points of DIMS' transformed
    cube, its port twin (chain steps and acceptance carried over), and a
    JAX and a port Optimizer holding them."""
    rng = np.random.RandomState(0)
    Xt = rng.uniform(size=(30, 2))
    y = np.sin(5 * Xt[:, 0]) * np.cos(3 * Xt[:, 1]) + 0.05 * rng.randn(30)
    kernel = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
    gp = JaxBayesGPR(kernel=kernel, normalize_y=True, random_state=0)
    gp.fit(Xt, y, n_desired_samples=96, n_burnin=5, n_walkers_per_thread=16,
           progress=False, warn_rhat=None)
    ours = convert.fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_, noise=gp.noise_,
        X=gp._X_orig, y=gp._y_orig, y_mean=gp.y_train_mean_, y_std=gp.y_train_std_,
        alpha=gp.alpha, noise_vector=gp._noise_vector, chain_steps=gp.chain_steps_,
        n_accepted=gp.n_accepted_, n_proposals=gp.n_proposals_, device="cpu",
    )
    opts = []
    for cls, model, kw in ((JaxOptimizer, gp, {}), (Optimizer, ours, {"device": "cpu"})):
        opt = cls(dimensions=DIMS, n_initial_points=30, random_state=0, **kw)
        opt.Xi = opt.space.inverse_transform(Xt)
        opt.yi = list(y)
        opt._n_initial_points = 0
        opt.gp = model
        opts.append(opt)
    return gp, ours, opts


def _ar1(seed, shape, phi=0.8):
    rng = np.random.RandomState(seed)
    x = np.zeros(shape)
    for t in range(1, shape[0]):
        x[t] = phi * x[t - 1] + rng.randn(*shape[1:])
    return x + 0.3 * rng.randn(1, shape[1], shape[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_ess_and_autocorr_time_match_jax(seed):
    x = _ar1(seed, (64, 6, 3))
    for t_fn, j_fn in (
        (tdiag.effective_sample_size, jdiag.effective_sample_size),
        (tdiag.integrated_autocorr_time, jdiag.integrated_autocorr_time),
        (tdiag.split_rhat, jdiag.split_rhat),
    ):
        np.testing.assert_allclose(t_fn(x), j_fn(x), rtol=1e-12)
    np.testing.assert_allclose(
        tdiag.integrated_autocorr_time(x, c=3.0), jdiag.integrated_autocorr_time(x, c=3.0),
        rtol=1e-12,
    )


@pytest.mark.parametrize("multimodal", [False, True])
def test_hdi_matches_jax(multimodal):
    rng = np.random.RandomState(5)
    for samples in (rng.randn(300), np.concatenate([rng.randn(150) - 3, rng.randn(150) + 3]),
                    np.round(rng.rand(200), 1)):
        for prob in (0.5, 0.95):
            np.testing.assert_allclose(
                tstats.hdi(samples, prob, multimodal), jstats.hdi(samples, prob, multimodal),
                rtol=1e-12,
            )


def test_torch_densities_match_jax():
    x = np.linspace(-12.0, 4.0, 41)
    t = torch.from_numpy(x)
    pos = torch.from_numpy(np.abs(x) + 0.1)
    pairs = [
        (tstats.norm_pdf(t), jstats.norm_pdf(x)),
        (tstats.norm_cdf(t), jstats.norm_cdf(x)),
        (tstats.norm_logcdf(t), jstats.norm_logcdf(x)),
        (tstats.halfnorm_logpdf(t, 0.7), jstats.halfnorm_logpdf(x, 0.7)),
        (tstats.invgamma_logpdf(pos, 2.5, 0.4), jstats.invgamma_logpdf(np.abs(x) + 0.1, 2.5, 0.4)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_mcmc_diagnostics_match_jax(fitted):
    gp, ours, _ = fitted
    ref, got = gp.mcmc_diagnostics(), ours.mcmc_diagnostics()
    for key in ("rhat", "ess", "autocorr_time"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12)
    for key in ("acceptance", "n_steps", "n_walkers"):
        assert got[key] == ref[key]


def test_expected_minimum_matches_jax(fitted):
    gp, ours, (jopt, topt) = fitted
    ref = jres.expected_minimum(
        jres.create_result(jopt.Xi, jopt.yi, jopt.space, models=[gp]),
        n_random_starts=6, random_state=2,
    )
    got = tres.expected_minimum(
        tres.create_result(topt.Xi, topt.yi, topt.space, models=[ours]),
        n_random_starts=6, random_state=2,
    )
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    assert abs(got[1] - ref[1]) <= 1e-6


def _stub_sample_y(monkeypatch, opts):
    for opt in opts:
        monkeypatch.setattr(
            opt.gp, "sample_y",
            lambda X, n_samples=1, **kw: SHARED[: len(X), :n_samples].copy(),
        )


def test_probability_of_optimality_and_gap_match_jax(fitted, monkeypatch):
    _, _, opts = fitted
    _stub_sample_y(monkeypatch, opts)
    kw = dict(n_space_samples=60, n_gp_samples=40, n_random_starts=4)
    ref = opts[0].probability_of_optimality([0.0, 0.3, 3.0], random_state=1, **kw)
    got = opts[1].probability_of_optimality([0.0, 0.3, 3.0], random_state=1, **kw)
    assert got == ref and got[0] <= got[1] <= got[2]
    assert opts[1].probability_of_optimality(0.3, random_state=1, **kw) == ref[1]
    gap_kw = dict(n_probabilities=6, n_space_samples=40, n_gp_samples=30, n_random_starts=3)
    ref = opts[0].expected_optimality_gap(random_state=3, **gap_kw)
    got = opts[1].expected_optimality_gap(random_state=3, **gap_kw)
    assert got == pytest.approx(ref, rel=1e-12)


def test_optimum_intervals_match_jax(fitted, monkeypatch):
    _, _, opts = fitted
    _stub_sample_y(monkeypatch, opts)
    for multimodal in (False, True):
        ref = opts[0].optimum_intervals(multimodal=multimodal, opt_samples=50,
                                        space_samples=80, random_state=2)
        got = opts[1].optimum_intervals(multimodal=multimodal, opt_samples=50,
                                        space_samples=80, random_state=2)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=1e-12)


def test_log_marginal_likelihood_at_theta_matches_jax(fitted):
    gp, ours, _ = fitted
    theta = gp.theta + 0.1
    assert ours.log_marginal_likelihood() == gp.log_marginal_likelihood_value_ or np.isclose(
        ours.log_marginal_likelihood(), gp.log_marginal_likelihood_value_, rtol=1e-10
    )
    np.testing.assert_allclose(
        ours.log_marginal_likelihood(theta), gp.log_marginal_likelihood(theta), rtol=1e-10
    )


def test_noise_set_to_zero_matches_jax(fitted):
    gp, ours, _ = fitted
    grid = np.random.RandomState(6).uniform(size=(20, 2))
    with gp.noise_set_to_zero(), ours.noise_set_to_zero():
        ref, got = gp.predict(grid, return_std=True), ours.predict(grid, return_std=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-8, atol=1e-12)
    noisy = ours.predict(grid, return_std=True)[1]
    assert (noisy > got[1]).all()
