"""The acquisition polish and the legacy dispatcher of the port against
the JAX package, and the repairs that came with them: the Adam ascent on
a closed-form surface, the PVRS and VarianceReduction polish given JAX's
Thompson normals, the marginalized polish of EI, TopTwoEI, LCB and
Expectation over the same chain rows (values within 1e-6), the legacy
``evaluate_acquisitions`` bit-equal to the port's fused pass, and the
Optimizer's ``acq_polish``, ``mesh`` and legacy fallback."""

import warnings

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
from bask_tpu_torch import Optimizer, convert  # noqa: E402
from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch.models import gp as tgp  # noqa: E402
from bask_tpu_torch.optimizer import ACQUISITION_FUNC  # noqa: E402

TOL = 1e-6
POOL = np.random.RandomState(3).uniform(size=(20, 2))
X0 = POOL[[2, 7, 11]]


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(24, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.randn(24)
    kernel = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
    gp = JaxBayesGPR(kernel=kernel, normalize_y=True, random_state=0)
    gp.fit(X, y, n_desired_samples=64, n_burnin=5, n_walkers_per_thread=16,
           progress=False, warn_rhat=None)
    ours = convert.fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_, noise=gp.noise_,
        X=gp._X_orig, y=gp._y_orig, y_mean=gp.y_train_mean_, y_std=gp.y_train_std_,
        alpha=gp.alpha, noise_vector=gp._noise_vector, device="cpu",
    )
    return gp, ours


def test_adam_ascent_matches_jax_on_a_closed_form_surface():
    c, w = np.array([0.3, 0.8]), np.array([1.0, 4.0])
    starts = np.array([[0.9, 0.1], [0.0, 1.0], [0.5, 0.5], [0.31, 0.79]])
    xb_j, vb_j = jacq._adam_ascent(
        lambda x: -jnp.sum(w * (x - c) ** 2), jnp.asarray(starts), 25, 0.05
    )
    xb, vb = tacq._adam_ascent(
        lambda X: -((torch.from_numpy(w) * (X - torch.from_numpy(c)) ** 2).sum(-1)),
        torch.from_numpy(starts), 25, 0.05,
    )
    np.testing.assert_allclose(xb.numpy(), np.asarray(xb_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(vb.numpy(), np.asarray(vb_j), rtol=0, atol=1e-10)
    assert (vb.numpy() >= -((w * (starts - c) ** 2).sum(1))).all()


def _eigvec_signs(gp, ours, grid):
    """+-1 per eigenvector of the pool's noise-free predictive covariance:
    LAPACK's eigenvector signs differ between the two packages' eigh, so
    JAX's normal z_i is the port's s_i z_i (tests/test_torch_slice.py)."""
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
    v_j = np.asarray(jnp.linalg.eigh(cov_j)[1])
    v_t = torch.linalg.eigh(cov_t)[1].numpy()
    return np.sign(np.sum(v_j * v_t, axis=0))


@pytest.mark.parametrize("thompson", [True, False])
def test_fullgp_polish_matches_jax(fitted, thompson):
    """PVRS with JAX's Thompson normals; VarianceReduction (no randoms)."""
    gp, ours = fitted
    key = jax.random.PRNGKey(4)
    xb_j, vb_j = jacq._polish_fullgp_vals(
        jnp.asarray(gp.theta), gp._post, gp._post_data, jnp.asarray(X0), jnp.asarray(POOL),
        jnp.zeros(0), jnp.zeros(0), key, kernel=gp._spec, n_thompson=5,
        white_idx=gp.white_index_, with_thompson=thompson, has_warp=False, n_steps=10, lr=0.05,
    )
    z = None
    if thompson:
        z = np.array(jax.random.normal(key, (len(POOL), 5), dtype=jnp.float64))
        z = torch.from_numpy(z * _eigvec_signs(gp, ours, POOL)[:, None])
    xb, vb = tacq._polish_fullgp_vals(
        ours._spec, ours._tensor(ours.theta), ours._post, ours._post_data,
        ours._tensor(X0), ours._tensor(POOL), None, z, ours.white_index_, 10, 0.05,
    )
    np.testing.assert_allclose(vb.numpy(), np.asarray(vb_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(xb.numpy(), np.asarray(xb_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("name,kwargs", [("ei", {}), ("ttei", {}), ("lcb", {"alpha": 1.5}),
                                         ("mean", {}), ("ei", {"y_opt": -0.5})])
def test_marginal_polish_matches_jax(fitted, name, kwargs):
    gp, ours = fitted
    acq_j = {"ei": jacq.ExpectedImprovement(), "ttei": jacq.TopTwoEI(), "lcb": jacq.LCB(),
             "mean": jacq.Expectation()}[name]
    common = dict(n_samples=6, random_state=9, n_steps=10, lr=0.05, X_pool=POOL, **kwargs)
    xb_j, vb_j = jacq.polish_acquisition(X0, gp, acq_j, **common)
    xb, vb = tacq.polish_acquisition(X0, ours, ACQUISITION_FUNC[name], **common)
    np.testing.assert_allclose(vb, np.asarray(vb_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(xb, np.asarray(xb_j), rtol=0, atol=TOL)


class _Custom(tacq.Acquisition):
    def __call__(self, *args, **kwargs):
        return 0.0


class _CustomFullGP(tacq.FullGPAcquisition):
    def __call__(self, X, gp, *args, random_state=None, **kwargs):
        return np.asarray(X).sum(1) + random_state.randn(len(X))


def test_polish_noop_reasons_match_jax():
    pairs = [
        (jacq.MaxValueSearch(), tacq.MaxValueSearch(), {}),
        (jacq.ThompsonSampling(), tacq.ThompsonSampling(), {}),
        (jacq.ExpectedImprovement(), tacq.ExpectedImprovement(), {"n_samples": 0}),
        (jacq.ExpectedImprovement(), tacq.ExpectedImprovement(), {}),
        (jacq.PVRS(), tacq.PVRS(), {}),
    ]
    for acq_j, acq_t, kw in pairs:
        assert (jacq.polish_noop_reason(acq_j, **kw) is None) == (
            tacq.polish_noop_reason(acq_t, **kw) is None
        )
    assert tacq.polish_noop_reason(_CustomFullGP()) is not None
    assert tacq.polish_noop_reason(_Custom()) is not None


@pytest.mark.parametrize("name", ["ei", "lcb", "ts", "mes", "ttei", "pvrs", "vr"])
def test_legacy_dispatcher_bit_equals_the_fused_pass(fitted, name):
    _, ours = fitted
    acq = ACQUISITION_FUNC[name]
    legacy = tacq.evaluate_acquisitions(POOL, ours, (acq,), n_samples=8, random_state=5)
    fused = tacq.evaluate_acquisitions_fused(POOL, ours, acq, n_samples=8, random_state=5)
    assert legacy.shape == fused.shape == (1, len(POOL))
    assert np.array_equal(legacy, fused)


def test_legacy_multi_acquisition_draws_rows_as_jax(fitted):
    """(PVRS, EI, LCB) in one call: PVRS draws its seed first, then the
    marginal acquisitions share rows picked as JAX picks them."""
    gp, ours = fitted
    acqs_j = (jacq.PVRS(), jacq.ExpectedImprovement(), jacq.LCB())
    acqs_t = tuple(ACQUISITION_FUNC[k] for k in ("pvrs", "ei", "lcb"))
    ref = jacq.evaluate_acquisitions(POOL, gp, acqs_j, n_samples=8, random_state=6)
    got = tacq.evaluate_acquisitions(POOL, ours, acqs_t, n_samples=8, random_state=6, progress=True)
    assert got.shape == (3, len(POOL)) and np.isfinite(got).all()
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-5, atol=1e-10)


def test_fused_declines_an_unknown_acquisition_like_jax(fitted):
    gp, ours = fitted

    class JaxCustom(jacq.Acquisition):
        def __call__(self, *args, **kwargs):
            return 0.0

    assert jacq.evaluate_acquisitions_fused(POOL, gp, JaxCustom(), n_samples=4) is None
    assert tacq.evaluate_acquisitions_fused(POOL, ours, _Custom(), n_samples=4) is None
    out = tacq.evaluate_acquisitions(POOL, ours, (_Custom(),), n_samples=4, random_state=1)
    assert np.array_equal(out, np.zeros((1, len(POOL))))


def test_custom_fullgp_runs_as_the_legacy_route(fitted):
    """A custom FullGP class: the fused pass calls it as JAX's legacy
    route does, acq(X, gpr, random_state=rs) with the seed's RandomState."""
    _, ours = fitted
    fused = tacq.evaluate_acquisitions_fused(POOL, ours, _CustomFullGP(), random_state=8)
    legacy = tacq.evaluate_acquisitions(POOL, ours, (_CustomFullGP(),), random_state=8)
    direct = _CustomFullGP()(POOL, ours, random_state=np.random.RandomState(8))
    assert np.array_equal(fused[0], direct) and np.array_equal(legacy[0], direct)


def test_optimizer_refuses_a_mesh():
    """Walker sharding (``mesh=``) is ported; a row mesh inside the
    Optimizer is refused with the JAX package's message."""
    from bask_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="row_mesh is a BayesGPR"):
        Optimizer(dimensions=[(0.0, 1.0)], gp_kwargs={"row_mesh": Mesh(["cpu"] * 2)},
                  device="cpu")


def _small_optimizer(**kwargs):
    opt = Optimizer(dimensions=[(0.0, 1.0), (0.0, 1.0)], n_points=40, n_initial_points=8,
                    init_strategy="random", random_state=2, device="cpu", dtype=torch.float64,
                    gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 8}, **kwargs)
    X = np.random.RandomState(1).uniform(size=(8, 2))
    return opt, X, ((X - 0.4) ** 2).sum(1)


def test_tell_takes_the_legacy_dispatcher_when_fused_declines(monkeypatch):
    opt, X, y = _small_optimizer(acq_func=_Custom())
    calls = []
    legacy = tacq.evaluate_acquisitions

    def spy(*args, **kwargs):
        calls.append(kwargs["acquisition_functions"])
        return legacy(*args, **kwargs)

    monkeypatch.setattr(tacq, "evaluate_acquisitions", spy)
    opt.tell(X.tolist(), y.tolist(), n_samples=2, gp_samples=16, gp_burnin=2)
    assert len(calls) == 1 and isinstance(calls[0][0], _Custom)
    assert opt.ask() is not None


def test_acq_polish_runs_in_tell_and_warns_when_it_cannot(monkeypatch):
    opt, X, y = _small_optimizer(acq_func="ei", acq_polish=3)
    seen = []
    polish = tacq.polish_acquisition

    def spy(X0, **kwargs):
        out = polish(X0, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(tacq, "polish_acquisition", spy)
    opt.tell(X.tolist(), y.tolist(), n_samples=3, gp_samples=16, gp_burnin=2)
    assert len(seen) == 1 and seen[0] is not None
    xb, vb = seen[0]
    np.testing.assert_allclose(opt.ask(), xb[int(np.argmax(vb))], rtol=0, atol=1e-12)
    assert opt.last_timings_["mcmc_acceptance"] is not None

    opt, X, y = _small_optimizer(acq_func="mes", acq_polish=3)
    with pytest.warns(UserWarning, match="acq_polish is inactive"):
        opt.tell(X.tolist(), y.tolist(), n_samples=2, gp_samples=16, gp_burnin=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        opt.tell([0.5, 0.5], 0.1, n_samples=2, gp_samples=16, gp_burnin=2)  # warned once

    with pytest.warns(UserWarning, match="categorical"):
        Optimizer(dimensions=[(0.0, 1.0), ["a", "b"]], acq_polish=2, device="cpu")
