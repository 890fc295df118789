"""The slice end to end: a BayesGPR fitted by the JAX package and carried
into the port by ``convert`` gives the same consensus LML, predictions
and PVRS/EI values (PVRS with the Thompson normals JAX draws); and a
small port Optimizer finds the optimum region of the 1-D example."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu import acquisition as jacq  # noqa: E402
from bask_tpu.models import gp as jgp  # noqa: E402
from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.models import gp as tgp  # noqa: E402
from bask_tpu_torch.optimizer import Optimizer  # noqa: E402

RTOL = 1e-5


@pytest.fixture(scope="module")
def fitted():
    """A JAX BayesGPR fitted at float64 on 30 noisy 2-D points, the port
    model carried over from it, and a fixed candidate grid."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(30, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.randn(30)
    kernel = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
    gp = JaxBayesGPR(kernel=kernel, normalize_y=True, random_state=0)
    gp.fit(X, y, n_desired_samples=80, n_burnin=10, n_walkers_per_thread=16,
           progress=False, warn_rhat=None)
    ours = convert.fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_,
        noise=gp.noise_, X=gp._X_orig, y=gp._y_orig, y_mean=gp.y_train_mean_,
        y_std=gp.y_train_std_, alpha=gp.alpha, noise_vector=gp._noise_vector,
    )
    grid = np.random.RandomState(1).uniform(size=(25, 2))
    return gp, ours, grid


def test_consensus_lml_and_predictions(fitted):
    gp, ours, grid = fitted
    np.testing.assert_allclose(
        ours.log_marginal_likelihood_value_, gp.log_marginal_likelihood_value_, rtol=RTOL
    )
    np.testing.assert_allclose(ours.L_, gp.L_, rtol=RTOL, atol=1e-10)
    mu, std = ours.predict(grid, return_std=True)
    mu_j, std_j = gp.predict(grid, return_std=True)
    np.testing.assert_allclose(mu, mu_j, rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(std, std_j, rtol=RTOL, atol=1e-10)


def test_gp_posterior_matches_jax(fitted):
    gp, ours, _ = fitted
    post_j = jgp.posterior(gp._spec, jnp.asarray(gp.theta), gp._post_data)
    post_t = tgp.posterior(ours._spec, ours._tensor(ours.theta), ours._data)
    np.testing.assert_allclose(post_t.L.numpy(), np.asarray(post_j.L), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(
        post_t.alpha_dual.numpy(), np.asarray(post_j.alpha_dual), rtol=RTOL, atol=1e-10
    )


def test_validate_zeroone_like_jax():
    from bask_tpu.utils.validation import validate_zeroone as jax_validate
    from bask_tpu_torch import validate_zeroone

    for arr in ([0.0, 0.5, 1.0], [[0.2, 1.1]], [-0.1], [np.nan]):
        outcomes = []
        for fn in (validate_zeroone, jax_validate):
            try:
                fn(np.asarray(arr))
                outcomes.append(None)
            except ValueError:
                outcomes.append(ValueError)
        assert outcomes[0] == outcomes[1]


def _eigvec_signs(gp, ours, grid):
    """+-1 per eigenvector: LAPACK's eigenvector signs differ between the
    two packages' eigh (the values agree), so a JAX normal z_i maps onto
    the port's eigenbasis as s_i z_i, the same draw."""
    th = jnp.asarray(gp.theta)
    _, cov_j = jgp.predict(
        gp._spec, jgp.noise_free_theta(gp._spec, th, gp.white_index_), gp._post,
        gp._post_data, jnp.asarray(grid), return_cov=True,
    )
    tt = ours._tensor(ours.theta)
    _, cov_t = tgp.predict(
        ours._spec, tgp.noise_free_theta(ours._spec, tt, ours.white_index_),
        ours._post, ours._data, ours._tensor(grid), return_cov=True,
    )
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=RTOL, atol=1e-12)
    v_j = np.asarray(jnp.linalg.eigh(cov_j)[1])
    v_t = torch.linalg.eigh(cov_t)[1].numpy()
    return np.sign(np.sum(v_j * v_t, axis=0))


def test_pvrs_with_jax_thompson_normals(fitted):
    gp, ours, grid = fitted
    acq_seed = 123
    vals_j = np.asarray(
        jacq.evaluate_acquisitions_fused(grid, gp, jacq.PVRS(), random_state=acq_seed)
    )[0]
    seed = np.random.RandomState(acq_seed).randint(0, 2**31 - 1)
    z = np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (len(grid), 10), dtype=jnp.float64)
    )
    z *= _eigvec_signs(gp, ours, grid)[:, None]
    vals = tacq._fused_fullgp_vals(
        ours._spec, ours._tensor(ours.theta), ours._post, ours._data,
        ours._tensor(grid), torch.from_numpy(z), ours.white_index_,
    ).numpy()
    np.testing.assert_allclose(vals, vals_j, rtol=RTOL)
    assert np.argmax(vals) == np.argmax(vals_j)
    # the port's own draws go through the same code path
    own = tacq.evaluate_acquisitions_fused(grid, ours, tacq.PVRS(), random_state=acq_seed)
    assert own.shape == (1, len(grid)) and np.isfinite(own).all()


def test_ei_marginalized_over_the_same_chain_rows(fitted):
    gp, ours, grid = fitted
    vals_j = np.asarray(
        jacq.evaluate_acquisitions_fused(
            grid, gp, jacq.ExpectedImprovement(), n_samples=12, random_state=7
        )
    )
    vals = tacq.evaluate_acquisitions_fused(
        grid, ours, tacq.ExpectedImprovement(), n_samples=12, random_state=7
    )
    np.testing.assert_allclose(vals, vals_j, rtol=RTOL, atol=1e-12)
    assert np.argmax(vals) == np.argmax(vals_j)


def test_port_sample_warm_starts_and_stays_finite(fitted):
    """A warm port ``sample`` on the carried state: the ensemble continues
    from ``pos_`` and the consensus stays finite."""
    gp, ours, _ = fitted
    ours.sample(n_desired_samples=32, n_burnin=2, n_walkers_per_thread=16, warn_rhat=None)
    assert ours.chain_steps_.shape == (2, 16, gp._spec.n_theta)
    assert np.isfinite(ours.log_marginal_likelihood_value_)
    assert 0.0 < ours.n_accepted_ / ours.n_proposals_ < 1.0


def test_sample_y_draws(fitted):
    """Consensus draws (PVRS's path) and per-chain-row draws: the right
    shapes, finite, and centred on the predictive mean."""
    _, ours, grid = fitted
    mu, std = ours.predict(grid, return_std=True)
    draws = ours.sample_y(grid, sample_mean=True, n_samples=4000, random_state=3)
    assert draws.shape == (len(grid), 4000) and np.isfinite(draws).all()
    assert np.all(np.abs(draws.mean(1) - mu) < 0.1 * std.max())
    marg = ours.sample_y(grid, n_samples=64, random_state=4)
    assert marg.shape == (len(grid), 64) and np.isfinite(marg).all()


def test_optimizer_finds_1d_optimum():
    """examples/optimize_1d.py's loop (PVRS, 50-point grid, 32 tells) on
    its objective, whose optimum is near x = 0.9554, y = -1.4734."""

    def objective(x, rng=np.random.RandomState(42)):
        return float(-(1.4 - 3.0 * x[0]) * np.sin(18.0 * x[0]) + rng.randn() * 0.05)

    opt = Optimizer(
        dimensions=[(0.0, 1.2)], n_points=50, n_initial_points=5,
        acq_func="pvrs", random_state=0, dtype=torch.float64,
    )
    res = opt.run(objective, n_iter=32, n_samples=0, gp_samples=200, gp_burnin=5)
    assert abs(res.x[0] - 0.9554) < 0.05 and res.fun < -1.3
    xs = np.asarray(res.x_iters)
    assert ((xs >= 0.0) & (xs <= 1.2)).all()
