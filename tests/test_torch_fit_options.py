"""The fit options of BayesGPR in the port, held to bask_tpu at float64
on one data set (30 noisy points in 2-D): ML-II with restarts, the MAP
objective, the subsampled warm start (the same RandomState draws, so the
same starts and subset), the Laplace chain init (positions from the same
draws), the device L-BFGS against the host L-BFGS-B, ``optimizer=None``,
and the Optimizer with these options and with general-nu Matern and
Exponentiation kernels through tell/ask."""

import warnings

import numpy as np
import pytest
import scipy.stats as sps

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import BayesGPR, Optimizer, convert  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402

KERNEL = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
rng = np.random.RandomState(0)
X = rng.uniform(size=(30, 2))
Y = np.sin(4 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * rng.randn(30)


def _pair(kernel=KERNEL, **kw):
    """A JAX and a port model set up as ``fit`` sets them up before the
    warm start (White appended, data uploaded), from random_state 0."""
    j = JaxBayesGPR(kernel, random_state=0, **kw)
    t = BayesGPR(convert.kernel_spec(kernel), random_state=0, device="cpu",
                 dtype=torch.float64, **kw)
    for gp, white in ((j, jk.WhiteKernel), (t, tk.WhiteKernel)):
        gp._spec = gp._user_kernel + white(1.0, (1e-5, 1e5))
        gp._priors_cache = None
        gp._set_data(X, Y, None)
    return j, t


def _neg_lml(t, theta):
    return float(tbg._neg_lml_plain(t._spec, torch.tensor(theta), t._data))


@pytest.mark.parametrize("kw", [
    {"n_restarts_optimizer": 2},
    {"ml2_objective": "map", "n_restarts_optimizer": 2},
    {"ml2_subsample": 12},
], ids=["restarts", "map", "subsample"])
def test_ml2_matches_jax(kw):
    """The warm-start theta within 1e-5 of JAX's (both SciPy L-BFGS-B
    from the same starts on the same objective), and the RandomState left
    in the same place."""
    j, t = _pair(**kw)
    np.testing.assert_allclose(t._ml2_optimize(), j._ml2_optimize(), atol=1e-5)
    assert t.random_state.randint(2**31) == j.random_state.randint(2**31)


def test_laplace_positions_match_jax():
    """MAP refinement, Hessian, eigen-spread clamp and the walkers drawn
    from the same RandomState: positions within 1e-8 of JAX's."""
    j, t = _pair()
    theta = j._ml2_optimize()
    pj = j._laplace_positions(theta, 12, j._resolve_priors(None), 0)
    pt = t._laplace_positions(theta, 12, t._resolve_priors(None), 0)
    np.testing.assert_allclose(pt, pj, atol=1e-8)
    assert pt.std(0).min() >= 0.5 * tbg._LAPLACE_STD_MIN


def test_laplace_with_a_host_prior_falls_back_to_the_ball_like_jax():
    """A host prior has no gradient: both packages warn and draw the
    1e-2 ball from the same RandomState."""
    kw = dict(n_desired_samples=16, n_walkers_per_thread=16, n_burnin=0,
              chain_init="laplace", warn_rhat=None)
    priors = [lambda x: sps.norm(0, 2).logpdf(x)] * 4
    j, t = _pair()
    theta = j._ml2_optimize()
    starts = []
    for gp in (j, t):
        gp._theta = theta
        with pytest.warns(UserWarning, match="falling back to the ball"):
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="A gp prior")
                if gp is j:
                    gp.sample(priors=priors, progress=False, **kw)
                else:
                    gp.sample(priors=priors, **kw)
        starts.append(gp.random_state.randint(2**31))
    assert starts[0] == starts[1]


def test_device_lbfgs_reaches_the_host_objective():
    """The batched device L-BFGS (3 starts, 60 iterations) ends within
    1e-6 nats of SciPy's L-BFGS-B and of JAX's device L-BFGS."""
    j, t = _pair(optimizer="lbfgs-device", n_restarts_optimizer=2)
    _, host = _pair(n_restarts_optimizer=2)
    ours = _neg_lml(t, t._ml2_optimize())
    assert ours <= _neg_lml(t, host._ml2_optimize()) + 1e-6
    assert ours <= _neg_lml(t, j._ml2_optimize()) + 1e-6


def test_device_lbfgs_falls_back_loudly():
    """With the MAP objective or unbounded hyperparameters, the host
    L-BFGS-B runs instead, with a warning, as in JAX."""
    _, t = _pair(optimizer="lbfgs-device", ml2_objective="map")
    _, host = _pair(ml2_objective="map")
    with pytest.warns(UserWarning, match="host L-BFGS-B"):
        theta = t._ml2_optimize()
    np.testing.assert_allclose(theta, host._ml2_optimize(), atol=1e-8)
    _, t = _pair(optimizer="lbfgs-device")
    with np.errstate(divide="ignore"):  # log-bound -inf
        t._spec = tk.ConstantKernel(1.0, (0.1, 2.0)) * tk.Matern(
            (0.3, 0.3), (0.05, 2.0), nu=2.5
        ) + tk.WhiteKernel(1.0, (0.0, 1e5))
    with pytest.warns(UserWarning, match="finite, non-degenerate"), np.errstate(divide="ignore"):
        assert np.isfinite(t._ml2_optimize()).all()


def test_optimizer_none_seeds_at_theta0():
    gp = BayesGPR(convert.kernel_spec(KERNEL), optimizer=None, random_state=0,
                  device="cpu", dtype=torch.float64)

    def no_warm_start():
        raise AssertionError("optimizer=None must not run ML-II")

    gp._ml2_optimize = no_warm_start
    gp.fit(X, Y, n_desired_samples=32, n_walkers_per_thread=32, n_burnin=0, warn_rhat=None)
    np.testing.assert_allclose(gp.theta, gp._spec.theta0, atol=0.05)


def test_sample_chain_init_overrides_the_constructor():
    """``sample(chain_init="laplace")`` on a ball model draws Laplace
    positions (spread at least the Laplace floor in every direction)."""
    gp = BayesGPR(convert.kernel_spec(KERNEL), random_state=0, device="cpu",
                  dtype=torch.float64)
    gp.fit(X, Y, n_desired_samples=16, n_walkers_per_thread=16, n_burnin=0, warn_rhat=None)
    gp.pos_ = None
    seen = {}
    original = gp._laplace_positions

    def spy(*args):
        seen["pos"] = original(*args)
        return seen["pos"]

    gp._laplace_positions = spy
    gp.sample(n_desired_samples=16, n_walkers_per_thread=16, chain_init="laplace",
              warn_rhat=None)
    assert seen["pos"].shape == (16, gp._spec.n_theta)
    with pytest.raises(ValueError, match="chain_init"):
        BayesGPR(convert.kernel_spec(KERNEL), chain_init="cold", device="cpu")


def test_batch_ask_leaves_the_pathwise_route_for_a_general_kernel(monkeypatch):
    """Above 2,048 candidates a general-nu Matern has no pathwise draws in
    either package (NotImplementedError); the port's batch ask then draws
    exactly on a 2,048-candidate subsample, as JAX's does."""
    general = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=1.7)
    j = JaxBayesGPR(general, random_state=0)
    j._spec = general + jk.WhiteKernel(1.0, (1e-5, 1e5))
    with pytest.raises(NotImplementedError):
        j.thompson_argmin_pathwise(X, n_samples=2, sample_mean=False)
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * 2, n_initial_points=len(X), n_points=4096, random_state=0,
        acq_func="ei", device="cpu", dtype=torch.float64, gp_kernel=convert.kernel_spec(general),
        gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 8},
    )
    opt.tell(X.tolist(), Y.tolist(), n_samples=0, gp_samples=16, gp_burnin=1)
    with pytest.raises(NotImplementedError):
        opt.gp.thompson_argmin_pathwise(X, n_samples=2, sample_mean=False)
    seen = []

    def sample_y(Xc, n_samples=1, random_state=0, **kwargs):
        seen.append((len(Xc), n_samples))
        return np.random.RandomState(random_state).randn(len(Xc), n_samples)

    monkeypatch.setattr(opt.gp, "sample_y", sample_y)
    pts = np.asarray(opt.ask(n_points=3))
    assert seen == [(2048, 3)]
    assert len({tuple(p) for p in pts}) == 3


@pytest.mark.parametrize("case", ["laplace-map-subsample", "lbfgs-device", "matern-1.7",
                                  "exponentiation"])
def test_optimizer_tell_ask_with_options(case):
    """Each option through the Optimizer's cold fit, a warm tell and an
    ask on a 2-D bowl: 140 points for the 128-point subsample, 40 else."""
    gp_kwargs = {
        "laplace-map-subsample": {"chain_init": "laplace", "ml2_objective": "map",
                                  "n_restarts_optimizer": 2, "ml2_subsample": 128},
        "lbfgs-device": {"optimizer": "lbfgs-device", "n_restarts_optimizer": 2},
    }.get(case, {})
    kernel = {
        "matern-1.7": tk.ConstantKernel(1.0, (0.1, 2.0)) * tk.Matern((0.3, 0.3), (0.05, 2.0),
                                                                     nu=1.7),
        "exponentiation": tk.ConstantKernel(1.0, (0.1, 2.0))
        * tk.Exponentiation(tk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5), 2.0),
    }.get(case)
    n = 140 if "subsample" in case else 40
    r = np.random.RandomState(5)
    pts = r.uniform(size=(n, 2))
    vals = ((pts - 0.4) ** 2).sum(1) + 0.01 * r.randn(n)
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * 2, n_initial_points=n, random_state=0, device="cpu",
        dtype=torch.float64, n_points=100, gp_kernel=kernel, gp_kwargs=gp_kwargs,
        gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 16},
    )
    opt.tell(pts.tolist(), vals.tolist(), gp_samples=32, gp_burnin=2)
    x = opt.ask()
    opt.tell(x, float(((np.asarray(x) - 0.4) ** 2).sum()), gp_samples=32, gp_burnin=2)
    nxt = np.asarray(opt.ask())
    assert ((nxt >= 0) & (nxt <= 1)).all()
    assert np.isfinite(opt.gp.theta).all()
    assert np.isfinite(opt.gp.log_marginal_likelihood_value_)
