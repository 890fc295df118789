"""SciPy and NumPy priors in the port, held to bask_tpu at float64.

The probe that failed before the port resolved its priors: 20 points in
2-D, ``Constant * Matern(2.5) + White``, ``priors=[halfnorm(scale=2)
.logpdf] * 4`` (the port raised ``TypeError`` where the JAX package
fits). Frozen SciPy log-densities are lifted to torch and match SciPy for
all 17 families; any other NumPy callable runs on the host through an
adapter, elementwise or joint, through fit, sample and the Optimizer."""

import warnings

import numpy as np
import pytest
import scipy.stats as sps

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import bayesgpr as jbg  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.utils.scipy_lift import lift_scipy_prior as jax_lift  # noqa: E402
from bask_tpu_torch import BayesGPR, Optimizer, convert  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.utils.scipy_lift import lift_scipy_prior  # noqa: E402

# family -> (frozen dist, probe grid with out-of-support points), as
# tests/test_scipy_lift.py
CASES = {
    "norm": (sps.norm(-1.2, 0.7), np.linspace(-6, 4, 41)),
    "halfnorm": (sps.halfnorm(scale=2.0), np.linspace(-1, 8, 41)),
    "halfnorm_loc": (sps.halfnorm(loc=0.5, scale=1.5), np.linspace(-1, 8, 41)),
    "uniform": (sps.uniform(-0.5, 2.0), np.linspace(-1, 2, 31)),
    "expon": (sps.expon(scale=0.8), np.linspace(-1, 6, 41)),
    "gamma": (sps.gamma(2.3, scale=1.4), np.linspace(-1, 9, 41)),
    "invgamma": (sps.invgamma(3.1, scale=0.9), np.linspace(-1, 9, 41)),
    "lognorm": (sps.lognorm(0.6, scale=1.2), np.linspace(-1, 9, 41)),
    "beta": (sps.beta(2.0, 3.5), np.linspace(-0.2, 1.2, 31)),
    "cauchy": (sps.cauchy(0.3, 1.7), np.linspace(-8, 8, 41)),
    "laplace": (sps.laplace(-0.4, 1.1), np.linspace(-6, 6, 41)),
    "logistic": (sps.logistic(0.2, 0.9), np.linspace(-8, 8, 41)),
    "t": (sps.t(4.5, loc=0.1, scale=1.3), np.linspace(-8, 8, 41)),
    "chi2": (sps.chi2(3.0, scale=1.2), np.linspace(-1, 12, 41)),
    "rayleigh": (sps.rayleigh(scale=1.4), np.linspace(-1, 8, 41)),
    "gumbel_r": (sps.gumbel_r(0.2, 1.1), np.linspace(-6, 9, 41)),
    "weibull_min": (sps.weibull_min(1.8, scale=0.9), np.linspace(-1, 6, 41)),
    "pareto": (sps.pareto(2.6, scale=1.3), np.linspace(0.5, 9, 41)),
}

KERNEL = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)


def _data():
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(20, 2))
    y = np.sin(4 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * rng.randn(20)
    return X, y


def _port(**kw):
    return BayesGPR(convert.kernel_spec(KERNEL), random_state=0, device="cpu",
                    dtype=torch.float64, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lift_matches_scipy_logpdf(case):
    """Within 1e-10 relative of SciPy (the lift's own acceptance bound),
    -inf exactly where SciPy's is, and equal to the JAX package's lift."""
    dist, grid = CASES[case]
    lifted = lift_scipy_prior(dist.logpdf)
    assert lifted is not None, f"{case} should lift"
    got = lifted(torch.tensor(grid, dtype=torch.float64)).numpy()
    want = dist.logpdf(grid)
    both_inf = np.isneginf(got) & np.isneginf(want)
    np.testing.assert_allclose(got[~both_inf], want[~both_inf], rtol=1e-10, atol=1e-12)
    assert (np.isneginf(got) == np.isneginf(want)).all()
    jax_got = np.asarray(jax_lift(dist.logpdf)(jnp.asarray(grid)))
    np.testing.assert_allclose(got[~both_inf], jax_got[~both_inf], rtol=1e-13, atol=1e-13)


def test_lift_pdf_unfrozen_and_unsupported():
    grid = np.linspace(0.01, 5, 20)
    t = torch.tensor(grid, dtype=torch.float64)
    dist = sps.gamma(1.7, scale=0.6)
    np.testing.assert_allclose(lift_scipy_prior(dist.pdf)(t).numpy(), dist.pdf(grid), rtol=1e-10)
    np.testing.assert_allclose(lift_scipy_prior(sps.norm.logpdf)(t).numpy(),
                               sps.norm.logpdf(grid), rtol=1e-12)
    np.testing.assert_allclose(lift_scipy_prior(sps.norm.pdf)(t).numpy(),
                               sps.norm.pdf(grid), rtol=1e-12)
    assert lift_scipy_prior(sps.vonmises(1.0).logpdf) is None
    assert lift_scipy_prior(lambda x: sps.norm.logpdf(x)) is None
    assert lift_scipy_prior(sps.norm(0, 1).cdf) is None
    assert lift_scipy_prior(sps.norm(np.zeros(3), 1.0).logpdf) is None
    out = lift_scipy_prior(sps.norm(0, 1).logpdf)(torch.zeros(3, dtype=torch.float32))
    assert out.dtype == torch.float32


def test_resolve_priors_routes_each_kind():
    """torch priors pass through; frozen SciPy logpdfs lift with no
    warning; opaque NumPy callables get a host adapter, with a warning
    once per prior; a joint torch prior of one theta vector is vmapped."""
    gp = _port()
    X, y = _data()
    gp.fit(X, y, n_desired_samples=8, n_walkers_per_thread=8, n_burnin=0, warn_rhat=None)

    def native(x):
        return -0.5 * x * x

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert gp._resolve_priors([native] * 4)[0] is native
        lifted = gp._resolve_priors([sps.halfnorm(scale=2).logpdf] * 4)
    assert lifted[0].__wrapped_scipy__[0] == "halfnorm"

    def opaque(x):
        return sps.norm(0, 2).logpdf(x)

    with pytest.warns(UserWarning, match="host through an adapter"):
        host = gp._resolve_priors([opaque] * 4)
    assert isinstance(host[0], tbg._HostPrior)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the cached adapter warns no more
        assert gp._resolve_priors([opaque] * 4)[0] is host[0]
    theta = torch.tensor(np.random.RandomState(1).randn(5), dtype=torch.float64)
    np.testing.assert_allclose(host[0](theta).numpy(), sps.norm(0, 2).logpdf(theta.numpy()),
                               rtol=1e-14)

    def per_vector(t):  # a JAX-style joint prior of one theta vector
        return -(t * t).sum()

    vm = gp._resolve_priors(per_vector)
    thetas = torch.tensor(np.random.RandomState(2).randn(6, 4), dtype=torch.float64)
    np.testing.assert_allclose(vm(thetas).numpy(), -(thetas**2).sum(-1).numpy(), rtol=1e-14)
    with pytest.warns(UserWarning, match="host through an adapter"):
        joint = gp._resolve_priors(lambda t: float(sps.norm(0, 2).logpdf(t).sum()))
    np.testing.assert_allclose(joint(thetas).numpy(),
                               sps.norm(0, 2).logpdf(thetas.numpy()).sum(-1), rtol=1e-14)


def test_log_prob_batch_matches_jax_for_lifted_and_host_priors():
    """The chain's batched log posterior with a lifted and with a host
    prior equals the JAX package's (host callback) on the same walkers."""
    X, y = _data()
    gp = _port()
    gp.fit(X, y, n_desired_samples=8, n_walkers_per_thread=8, n_burnin=0, warn_rhat=None)
    jgp = jbg.BayesGPR(KERNEL, random_state=0)
    jgp.fit(X, y, n_desired_samples=8, n_walkers_per_thread=8, n_burnin=0,
            progress=False, warn_rhat=None)
    walkers = gp.theta[None] + 0.3 * np.random.RandomState(3).randn(6, 4)
    walkers[:, :3] = np.abs(walkers[:, :3])  # inside halfnorm's support

    def opaque(x):
        return sps.norm(0, 2).logpdf(x)

    for priors in ([sps.halfnorm(scale=2).logpdf] * 4, [opaque] * 4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ours = tbg._make_log_prob_batch(
                gp._spec, gp._resolve_priors(priors), gp._data, 20
            )(torch.tensor(walkers)).numpy()
            theirs = np.asarray(jbg._make_log_prob_batch(
                jgp._spec, jgp._resolve_priors(priors), None, 0, jgp._data
            )(jnp.asarray(walkers)))
        np.testing.assert_allclose(ours, theirs, rtol=1e-9)


def test_scipy_prior_probe_fits_like_jax():
    """The probe: the port fits with frozen-SciPy priors, and its
    consensus theta is JAX's within 1e-4 (the two packages start from the
    same ball, drawn from the same RandomState; walkers outside halfnorm's
    support have -inf and stay, so the consensus is the ball's median)."""
    X, y = _data()
    priors = [sps.halfnorm(scale=2).logpdf] * 4
    kw = dict(n_desired_samples=100, n_walkers_per_thread=50, n_burnin=5, warn_rhat=None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ours = _port().fit(X, y, priors=priors, **kw)
    theirs = jbg.BayesGPR(KERNEL, random_state=0).fit(X, y, priors=priors, progress=False, **kw)
    assert np.isfinite(ours.log_marginal_likelihood_value_)
    np.testing.assert_allclose(ours.theta, theirs.theta, atol=1e-4)


def test_opaque_numpy_priors_fit_elementwise_and_joint():
    """An opaque lambda prior (elementwise, then joint) fits through the
    host adapter; the elementwise consensus is JAX's within 0.15 in log
    space (the chains' randoms differ; the posterior sds here are 0.3-0.9)."""
    X, y = _data()
    kw = dict(n_desired_samples=96, n_walkers_per_thread=32, n_burnin=5, warn_rhat=None)
    elementwise = [lambda x: sps.norm(0, 2).logpdf(x)] * 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = _port().fit(X, y, priors=elementwise, **kw)
        theirs = jbg.BayesGPR(KERNEL, random_state=0).fit(
            X, y, priors=elementwise, progress=False, **kw
        )
        joint = _port().fit(X, y, priors=lambda t: float(sps.norm(0, 2).logpdf(t).sum()), **kw)
    np.testing.assert_allclose(ours.theta, theirs.theta, atol=0.15)
    assert np.isfinite(joint.theta).all() and np.isfinite(joint.log_marginal_likelihood_value_)


def test_host_prior_through_the_optimizer():
    """``Optimizer(gp_priors=[opaque lambdas])`` runs tell/ask."""
    opt = Optimizer(
        dimensions=[(-2.0, 2.0)], n_initial_points=4, random_state=1, device="cpu",
        dtype=torch.float64, n_points=50,
        gp_priors=[lambda x: sps.norm(0, 2).logpdf(x)] * 3,
        gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 16},
    )
    for _ in range(5):
        x = opt.ask()
        opt.tell(x, float(np.sin(3 * x[0]) + 0.1 * x[0] ** 2), gp_samples=32, gp_burnin=2)
    assert np.isfinite(opt.gp.theta).all()
    assert -2.0 <= opt.ask()[0] <= 2.0


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        _port(host_prior_mode="interp")
    with pytest.raises(ValueError, match="host_prior_mode"):
        _port(host_prior_mode="tabulate")
    # row mode is ported: its arguments are taken, a bad gradient refused
    assert _port(row_nb=128).row_nb == 128
    with pytest.raises(ValueError, match="row_grad_method"):
        _port(row_grad_method="bogus")
