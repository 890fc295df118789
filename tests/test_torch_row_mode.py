"""``BayesGPR(row_mesh=...)`` of the port, the huge-n mode, on meshes of
the CPU listed 8 times (or (2, 4)), float64: the cases of
``tests/test_row_mode.py`` at its tolerances. The chain's log-probability,
the ML-II value and gradient (against JAX's ``_lml_value_grad``), the
consensus refresh, ``predict`` with gradients, ``sample_y``, the warped
row fit, the device and host L-BFGS, the pickle that drops the mesh and
the LML routing all go through the row-sharded sweep and agree with the
dense port model (itself held against JAX elsewhere)."""

import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import bayesgpr as jbg  # noqa: E402
from bask_tpu.models import gp as jgp  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.models import warping as twp  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402
from bask_tpu_torch.parallel.mesh import Mesh  # noqa: E402

BayesGPR = tbg.BayesGPR


def _row_mesh():
    return Mesh(["cpu"] * 8, ("r",))


def _wr_mesh():
    return Mesh(np.array(["cpu"] * 8).reshape(2, 4).tolist(), ("w", "r"))


def _kernel(d=2):
    return tk.ConstantKernel(1.0, (0.1, 10.0)) * tk.Matern((0.5,) * d, (0.05, 5.0), nu=2.5)


def _problem(n=53, d=2, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.randn(n)
    return X, y


def _gp(**kw):
    kw.setdefault("kernel", _kernel())
    kw.setdefault("random_state", 7)
    return BayesGPR(device="cpu", dtype=torch.float64, **kw)


def _fit(gp, X, y, **kw):
    kw.setdefault("n_desired_samples", 24)
    kw.setdefault("n_burnin", 2)
    kw.setdefault("n_walkers_per_thread", 8)
    kw.setdefault("progress", False)
    return gp.fit(X, y, **kw)


def _with_data(gp, X, y):
    gp._spec = gp._user_kernel + tk.WhiteKernel(1.0, (1e-5, 1e5))
    gp._set_data(X, y, None)
    return gp


def _dense_twin(gp, X, y, **kw):
    """A dense port model forced to ``gp``'s consensus theta."""
    ref = _gp(**kw)
    ref._spec = gp._spec
    ref._set_data(X, y, None)
    ref.theta = gp.theta
    return ref


@pytest.mark.parametrize("layout", ["rows", "walkers_rows", "rows_warped"])
def test_log_prob_batch_row_matches_plain(layout):
    """The chain's row-sharded log-probability equals the batched_lml one
    (1-axis and (2, 4) meshes; warped rows warp inside each sweep)."""
    n = 48 if layout == "rows_warped" else 53
    X, y = _problem(n=n)
    warp = layout == "rows_warped"
    gp = _with_data(_gp(random_state=1, warp_inputs=warp), X, y)
    priors = gp._resolve_priors(None)
    n_warp = X.shape[1] if warp else 0
    wprior = twp.default_warp_log_prior if warp else None
    mesh = _wr_mesh() if layout == "walkers_rows" else _row_mesh()
    plain = tbg._make_log_prob_batch(gp._spec, priors, gp._data, n, wprior, n_warp)
    row = tbg._make_log_prob_batch(gp._spec, priors, gp._data, n, wprior, n_warp,
                                   row_cfg=(mesh, 16, False))
    D = gp._spec.n_theta + 2 * n_warp
    base = np.concatenate([gp._spec.theta0, np.zeros(2 * n_warp)])
    rows = torch.as_tensor(base[None, :] + 0.15 * np.random.RandomState(0).randn(8, D))
    np.testing.assert_allclose(row(rows).numpy(), plain(rows).numpy(), rtol=1e-9, atol=1e-9)


def test_warped_row_fit_predict_matches_dense():
    """A warped fit in row mode against the dense warped model with the
    same seeds: the ML-II warm starts agree to 1e-9 (their gradients come
    from two factorizations and differ by rounding, which 60 L-BFGS-B steps
    carry to ~1e-11); from one start (``optimizer=None``) the chains, warp
    and LML agree at the JAX test's tolerances, and so do predictions,
    their gradients through the warp's Jacobian, and the draws."""
    X, y = _problem(n=48)
    kw = dict(n_desired_samples=24, n_burnin=2, n_walkers_per_thread=8, progress=False)
    t_row = _with_data(_gp(warp_inputs=True, row_mesh=_row_mesh(), row_nb=16), X, y)
    t_dense = _with_data(_gp(warp_inputs=True), X, y)
    np.testing.assert_allclose(t_row._ml2_optimize(), t_dense._ml2_optimize(), rtol=1e-9)

    gp_row = _gp(warp_inputs=True, row_mesh=_row_mesh(), row_nb=16, optimizer=None)
    gp_row.fit(X, y, **kw)
    gp_dense = _gp(warp_inputs=True, optimizer=None)
    gp_dense.fit(X, y, **kw)
    np.testing.assert_allclose(gp_row.chain_, gp_dense.chain_, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gp_row.warp_alphas_, gp_dense.warp_alphas_, rtol=1e-12)
    assert np.isfinite(gp_row.log_marginal_likelihood_value_)
    np.testing.assert_allclose(gp_row.log_marginal_likelihood_value_,
                               gp_dense.log_marginal_likelihood_value_, rtol=1e-8)

    Xq = X[:6]
    m_r, s_r, mg_r, sg_r = gp_row.predict(Xq, return_std=True, return_mean_grad=True,
                                          return_std_grad=True)
    m_d, s_d, mg_d, sg_d = gp_dense.predict(Xq, return_std=True, return_mean_grad=True,
                                            return_std_grad=True)
    np.testing.assert_allclose(m_r, m_d, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(s_r, s_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(mg_r, mg_d, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sg_r, sg_d, rtol=1e-5, atol=1e-7)
    d_r = gp_row.sample_y(Xq, sample_mean=True, n_samples=3, random_state=5)
    d_d = gp_dense.sample_y(Xq, sample_mean=True, n_samples=3, random_state=5)
    np.testing.assert_allclose(d_r, d_d, rtol=1e-7, atol=1e-9)
    d_m = gp_row.sample_y(Xq, n_samples=2, random_state=5)
    assert d_m.shape == (6, 2) and np.isfinite(d_m).all()
    np.testing.assert_allclose(d_m, gp_dense.sample_y(Xq, n_samples=2, random_state=5),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("method", ["adjoint", "jvp"])
def test_ml2_value_grad_matches_jax(method):
    """The row-mode ML-II objective (negated LML and gradient) against the
    JAX package's dense ``_lml_value_grad`` on the same padded data."""
    X, y = _problem()
    gp = _with_data(_gp(random_state=1, row_mesh=_row_mesh(), row_grad_method=method), X, y)
    theta = gp._spec.theta0 + 0.2
    v, g = tbg._row_neg_lml_value_grad(gp._spec, gp._row_cfg(), method, gp._data)(
        gp._tensor(theta)[None, :])
    jspec = convert_back_kernel(gp._spec)
    d = gp._data
    jdata = jgp.make_data(*(jnp.asarray(a.numpy()) for a in (d.X, d.y, d.alpha_diag, d.mask)))
    vg = np.asarray(jbg._lml_value_grad(jnp.asarray(theta), jdata, kernel=jspec))
    got = np.concatenate([[float(v[0])], g[0].numpy()])
    np.testing.assert_allclose(got, vg, rtol=1e-8, atol=1e-9)


def test_fit_predict_end_to_end_row_mode():
    """A full row-mode fit keeps no (n, n) factor; predictions, covariance,
    noise-free std and the LML at its theta agree with a dense model at
    the same consensus theta."""
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y)
    assert gp._post is None
    assert np.isfinite(gp.theta).all() and np.isfinite(gp.log_marginal_likelihood_value_)
    assert gp.chain_.shape[1] == gp._spec.n_theta
    ref = _dense_twin(gp, X, y)
    Xq = np.random.RandomState(5).uniform(size=(9, X.shape[1]))
    m_row, s_row = gp.predict(Xq, return_std=True)
    m_ref, s_ref = ref.predict(Xq, return_std=True)
    np.testing.assert_allclose(m_row, m_ref, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(s_row, s_ref, rtol=1e-7, atol=1e-9)
    _, c_row = gp.predict(Xq, return_cov=True)
    _, c_ref = ref.predict(Xq, return_cov=True)
    np.testing.assert_allclose(c_row, c_ref, rtol=1e-6, atol=1e-8)
    with gp.noise_set_to_zero():
        s_nf = gp.predict(Xq, return_std=True)[1]
    with ref.noise_set_to_zero():
        s_nf_ref = ref.predict(Xq, return_std=True)[1]
    np.testing.assert_allclose(s_nf, s_nf_ref, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(gp.log_marginal_likelihood(gp.theta),
                               ref.log_marginal_likelihood(gp.theta), rtol=1e-9)


def test_fit_2d_mesh_rounds_walkers_and_runs():
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_wr_mesh()), X, y, n_walkers_per_thread=6)
    assert gp.chain_steps_.shape[1] % 4 == 0  # halves shard over the 2-wide walker axis
    assert np.isfinite(gp.theta).all()


def test_sample_y_row_mode():
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y)
    Xq = np.random.RandomState(2).uniform(size=(7, X.shape[1]))
    mean_draws = gp.sample_y(Xq, sample_mean=True, n_samples=5)
    assert mean_draws.shape == (7, 5) and np.isfinite(mean_draws).all()
    marg = gp.sample_y(Xq, n_samples=3, random_state=11)
    assert marg.shape == (7, 3) and np.isfinite(marg).all()
    assert np.abs(mean_draws.mean(axis=1) - gp.predict(Xq)).max() < 2.0


def test_row_mode_normalize_y():
    X, y = _problem()
    y = y * 37.0 + 250.0
    gp = _fit(_gp(row_mesh=_row_mesh(), normalize_y=True), X, y)
    ref = _dense_twin(gp, X, y, normalize_y=True)
    Xq = np.random.RandomState(5).uniform(size=(6, X.shape[1]))
    np.testing.assert_allclose(gp.predict(Xq, return_std=True)[0],
                               ref.predict(Xq, return_std=True)[0], rtol=1e-8)


def test_row_mode_guards():
    mesh = _row_mesh()
    X, y = _problem()
    gp = _fit(_gp(row_mesh=mesh), X, y)
    with pytest.raises(ValueError, match="mutually exclusive"):
        gp.sample(mesh=mesh, n_desired_samples=4)
    with pytest.raises(ValueError, match="return_cov"):
        gp.predict(X[:3], return_cov=True, return_mean_grad=True)


def test_row_mode_predict_gradients_match_plain():
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y)
    ref = _dense_twin(gp, X, y)
    Xq = np.random.RandomState(9).uniform(size=(6, X.shape[1]))
    m_r, s_r, mg_r, sg_r = gp.predict(Xq, return_std=True, return_mean_grad=True,
                                      return_std_grad=True)
    m_p, s_p, mg_p, sg_p = ref.predict(Xq, return_std=True, return_mean_grad=True,
                                       return_std_grad=True)
    np.testing.assert_allclose(m_r, m_p, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(s_r, s_p, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(mg_r, mg_p, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sg_r, sg_p, rtol=1e-5, atol=1e-7)
    with gp.noise_set_to_zero():
        out_nf = gp.predict(Xq, return_std=True, return_std_grad=True)
    with ref.noise_set_to_zero():
        ref_nf = ref.predict(Xq, return_std=True, return_std_grad=True)
    np.testing.assert_allclose(out_nf[2], ref_nf[2], rtol=1e-5, atol=1e-7)
    out = gp.predict(Xq, return_mean_grad=True)
    assert isinstance(out, tuple) and len(out) == 2
    np.testing.assert_allclose(out[1], mg_r, rtol=1e-12)


def test_row_mode_pickle_detaches_mesh():
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y)
    loaded = pickle.loads(pickle.dumps(gp))
    assert loaded.row_mesh is None and gp.row_mesh is not None
    np.testing.assert_allclose(loaded.theta, gp.theta)
    loaded.row_mesh = _row_mesh()
    np.testing.assert_allclose(loaded.predict(X[:4]), gp.predict(X[:4]), rtol=1e-10)


def test_convert_carries_row_mode_state():
    """``convert.fitted_bayesgpr`` takes a fitted row-mode model's state and
    the port mesh (a JAX mesh is not carried); the consensus LML is the
    sweep's, equal to the source's."""
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh(), row_nb=16), X, y)
    ours = convert.fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_, X=X, y=y,
        noise=gp.noise_, device="cpu", row_mesh=_row_mesh(), row_nb=16,
    )
    assert ours._post is None and ours.row_nb == 16
    np.testing.assert_allclose(ours.log_marginal_likelihood_value_,
                               gp.log_marginal_likelihood_value_, rtol=1e-12)
    np.testing.assert_allclose(ours.predict(X[:4]), gp.predict(X[:4]), rtol=1e-10)


def test_row_mode_lbfgs_device_matches_host_driver():
    """``optimizer="lbfgs-device"`` in row mode takes its gradients from
    the row sweep and reaches the host L-BFGS-B's optimum on the same
    objective."""
    X, y = _problem(n=30)
    mesh = Mesh(["cpu"] * 4, ("r",))
    gp = _with_data(_gp(row_mesh=mesh, optimizer="lbfgs-device"), X, y)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        theta_dev = gp._ml2_optimize()
    assert not any("lbfgs-device" in str(x.message) for x in w)
    host = _with_data(_gp(row_mesh=mesh), X, y)
    theta_host = host._ml2_optimize()

    def neg_lml(g, t):
        return -g.log_marginal_likelihood(t)

    obj_dev, obj_host = neg_lml(gp, theta_dev), neg_lml(host, theta_host)
    assert obj_dev <= obj_host + 1e-6 * abs(obj_host) + 1e-6
    b = gp._spec.bounds
    assert (theta_dev >= b[:, 0] - 1e-12).all() and (theta_dev <= b[:, 1] + 1e-12).all()


def test_row_grad_method_knob():
    """``row_grad_method="jvp"`` routes ML-II through the forward-mode
    sweeps and matches the adjoint; a bad value is refused."""
    X, y = _problem()
    gp = _with_data(_gp(row_mesh=_row_mesh(), row_grad_method="jvp"), X, y)
    t = gp._tensor(gp._spec.theta0)[None, :]
    v_j, g_j = tbg._row_neg_lml_value_grad(gp._spec, gp._row_cfg(), "jvp", gp._data)(t)
    v_a, g_a = tbg._row_neg_lml_value_grad(gp._spec, gp._row_cfg(), "adjoint", gp._data)(t)
    np.testing.assert_allclose(
        np.concatenate([v_j.numpy(), g_j[0].numpy()]),
        np.concatenate([v_a.numpy(), g_a[0].numpy()]), rtol=1e-6, atol=1e-8,
    )
    assert np.isfinite(gp._ml2_optimize()).all()
    with pytest.raises(ValueError, match="row_grad_method"):
        _gp(row_grad_method="bogus")


def test_row_mode_progress_and_add():
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y, progress=True)
    w0, n0 = gp.chain_steps_.shape[1], len(gp.chain_)
    gp.sample(n_desired_samples=16, n_burnin=0, n_walkers_per_thread=w0, add=True)
    assert len(gp.chain_) > n0


def test_row_mode_noise_free_theta_diag_consistency():
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y)
    Xq = np.random.RandomState(8).uniform(size=(5, X.shape[1]))
    noisy = gp.sample_y(Xq, sample_mean=True, noise=True, n_samples=400, random_state=3)
    clean = gp.sample_y(Xq, sample_mean=True, noise=False, n_samples=400, random_state=3)
    assert noisy.var(axis=1).mean() >= clean.var(axis=1).mean()


def test_unfitted_row_mode_prior_predict():
    gp = _gp(row_mesh=_row_mesh())
    m, s = gp.predict(np.random.RandomState(0).uniform(size=(4, 2)), return_std=True)
    np.testing.assert_allclose(m, 0.0)
    assert (s > 0).all()


def test_row_mode_consensus_state_is_lml_consistent():
    """The theta setter refreshes the consensus LML by the sweep, equal to
    ``log_marginal_likelihood(theta)`` and to JAX's dense LML."""
    X, y = _problem()
    gp = _fit(_gp(row_mesh=_row_mesh()), X, y)
    t = gp.theta
    gp.theta = t
    np.testing.assert_allclose(float(gp._consensus_lml_), gp.log_marginal_likelihood(t),
                               rtol=1e-12)
    d = gp._data
    jdata = jgp.make_data(*(jnp.asarray(a.numpy()) for a in (d.X, d.y, d.alpha_diag, d.mask)))
    jspec = convert_back_kernel(gp._spec)
    oracle = jax.jit(lambda th: jgp.log_marginal_likelihood(jspec, th, jdata))(jnp.asarray(t))
    np.testing.assert_allclose(float(gp._consensus_lml_), float(oracle), rtol=1e-9)


def convert_back_kernel(spec):
    """The JAX spec of this file's fitted kernel, ``C * Matern(2.5) + White``."""
    c, m, w = spec.k1.k1, spec.k1.k2, spec.k2
    return (jk.ConstantKernel(c.constant_value, c.constant_value_bounds)
            * jk.Matern(m.length_scale, m.length_scale_bounds, nu=m.nu)
            + jk.WhiteKernel(w.noise_level, w.noise_level_bounds))
