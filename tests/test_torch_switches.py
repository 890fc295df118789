"""The port's module switches against the JAX package's, on the CPU.

``ops.linalg.FAST_CHOLESKY`` ("on", "off", "auto") picks the factorization
route of the masked LML and of ``models.gp.posterior_and_invs`` with the
JAX package's semantics: each value and dtype is held against
``bask_tpu`` at the same value, at the tolerances of the JAX package's own
tests (``tests/test_fast_cholesky.py``: rtol 1e-8 at float64; at float32
the predictive mean to rtol 2e-5 / atol 1e-6 and the std to rtol 1e-3 /
atol 1e-5, and the LML to rtol 1e-5 as ``tests/test_torch_linalg.py``
holds the float32 routes). The chain's graph cache keys on the switch
(the graph path at "off" is in ``tests/test_torch_chain_graphs.py``).
``acquisition.FUSED_ACQUISITION`` "off" sends a tell to the legacy
dispatcher with the same next point (as ``tests/test_fused_tell.py`` pins
for JAX)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bask_tpu.ops.linalg as jlin  # noqa: E402
from bask_tpu.models import gp as jgp  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import Optimizer, convert  # noqa: E402
from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch.models import gp as tgp  # noqa: E402
from bask_tpu_torch.ops import chol_base  # noqa: E402
from bask_tpu_torch.ops import linalg as tlin  # noqa: E402
from bask_tpu_torch.parallel import mcmc  # noqa: E402

def _kernel(noise):
    return jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern(
        (0.3, 0.3, 0.3), (0.05, 2.0), nu=2.5
    ) + jk.WhiteKernel(noise, (1e-5, 1e5))


# the problems of JAX's tests/test_fast_cholesky.py, where its tolerances
# were set: the LML test's (seed 3, normal targets, noise 0.05) and the
# float32 predict test's (seed 1, y = sin(3 x0), noise 0.01)
PROBLEMS = {"lml": (3, 0.05), "predict": (1, 0.01)}
VALUES = ("on", "off", "auto")
# (LML rtol, mean rtol, mean atol, std rtol, std atol) per dtype
TOL = {np.float64: (1e-8, 1e-8, 0.0, 1e-8, 0.0), np.float32: (1e-5, 2e-5, 1e-6, 1e-3, 1e-5)}


@pytest.fixture
def switches():
    """Both packages' FAST_CHOLESKY, and FUSED_ACQUISITION, put back."""
    yield
    jlin.FAST_CHOLESKY = tlin.FAST_CHOLESKY = "auto"
    tacq.FUSED_ACQUISITION = "on"


def _set(value):
    jlin.FAST_CHOLESKY = tlin.FAST_CHOLESKY = value


def _problem(dtype, kind, n=100, n_pad=128, d=3):
    """(kernel, X, y, alpha, mask, Xq, thetas): n = 100 of 128 points, 50
    queries, the kernel's theta0 and three thetas around it."""
    seed, noise = PROBLEMS[kind]
    kernel = _kernel(noise)
    rng = np.random.RandomState(seed)
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n) if kind == "lml" else np.sin(3 * X[:n, 0])
    mask = np.arange(n_pad) < n
    Xq = rng.uniform(size=(50, d))
    thetas = kernel.theta0[None] + 0.3 * rng.randn(4, kernel.n_theta)
    thetas[0] = kernel.theta0
    return (kernel, X.astype(dtype), y.astype(dtype), np.full(n_pad, 1e-6, dtype), mask,
            Xq.astype(dtype), thetas.astype(dtype))


def _port(kernel, dtype, X, y, alpha, mask):
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    return convert.kernel_spec(kernel), convert.gp_data(X, y, alpha, mask, device="cpu",
                                                         dtype=tdtype)


def _jax_data(X, y, alpha, mask):
    return jgp.make_data(jnp.asarray(X), jnp.asarray(y), jnp.asarray(alpha), jnp.asarray(mask))


def _jax_gram(kernel, theta, jdata, dtype):
    """JAX's masked gram in ``dtype``: with x64 on (the test process's
    setting) JAX's kernel evaluation returns float64 for float32 inputs,
    so its float32 route is reached through a float32 gram."""
    return jlin.masked_gram(kernel, jnp.asarray(theta), jdata.X, jdata.alpha_diag,
                            jdata.mask).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("value", VALUES)
def test_lml_route_matches_jax(switches, value, dtype):
    """``masked_lml`` and ``batched_lml_from_gram`` against JAX's
    ``batched_lml_from_gram`` on JAX's gram in the same dtype (at float64
    also ``log_marginal_likelihood``) at the same switch value, per theta."""
    kernel, X, y, alpha, mask, _, thetas = _problem(dtype, "lml")
    _set(value)
    spec, data = _port(kernel, dtype, X, y, alpha, mask)
    jdata = _jax_data(X, y, alpha, mask)
    th = torch.from_numpy(thetas)
    ours = tlin.masked_lml(spec, th, data.X, data.y, data.alpha_diag, data.mask).numpy()
    Kp = tlin.masked_gram(spec, th, data.X, data.alpha_diag, data.mask)
    from_gram = tlin.batched_lml_from_gram(Kp, data.y, data.mask).numpy()
    ref = np.array([float(jlin.batched_lml_from_gram(_jax_gram(kernel, t, jdata, dtype)[None],
                                                     jdata.y, jdata.mask)[0])
                    for t in thetas])
    assert np.isfinite(ref).all()
    if dtype == np.float64:
        np.testing.assert_allclose(
            ref, [float(jgp.log_marginal_likelihood(kernel, jnp.asarray(t), jdata))
                  for t in thetas], rtol=1e-12)
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours, from_gram)
    np.testing.assert_allclose(ours, ref, rtol=TOL[dtype][0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("value", VALUES)
def test_posterior_and_predict_match_jax(switches, value, dtype):
    """``posterior_and_invs`` and ``predict(return_std=True)`` against JAX
    at the same switch value; ``invs`` is None exactly where JAX's is
    (always under "off", at float64 under "auto")."""
    kernel, X, y, alpha, mask, Xq, thetas = _problem(dtype, "predict")
    _set(value)
    spec, data = _port(kernel, dtype, X, y, alpha, mask)
    jdata = _jax_data(X, y, alpha, mask)
    theta, jtheta = torch.from_numpy(thetas[0]), jnp.asarray(thetas[0])
    post, invs = tgp.posterior_and_invs(spec, theta, data)
    jpost, jinvs = jgp.posterior_and_invs(kernel, jtheta, jdata,
                                          Kp=_jax_gram(kernel, thetas[0], jdata, dtype))
    assert (invs is None) == (jinvs is None)
    assert (invs is None) == (value == "off" or (value == "auto" and dtype == np.float64))
    mu, sd = tgp.predict(spec, theta, post, data, torch.from_numpy(Xq), return_std=True,
                         invs=invs)
    jmu, jsd = jgp.predict(kernel, jtheta, jpost, jdata, jnp.asarray(Xq), return_std=True,
                           invs=jinvs)
    _, m_rtol, m_atol, s_rtol, s_atol = TOL[dtype]
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=m_rtol, atol=m_atol)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=s_rtol, atol=s_atol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_on_against_off_in_the_port(switches, dtype):
    """The two routes of the port alone (JAX's ``test_fast_lml_matches_slow_path``
    and ``test_posterior_and_invs_f32_predict_parity``): "on" factors by
    blocks at either dtype (K3's plain version as the bases), "off" by
    ``cholesky_ex`` whole."""
    kernel, X, y, alpha, mask, _, thetas = _problem(dtype, "lml")
    spec, data = _port(kernel, dtype, X, y, alpha, mask)
    pkernel, pX, py, palpha, pmask, Xq, pthetas = _problem(dtype, "predict")
    pspec, pdata = _port(pkernel, dtype, pX, py, palpha, pmask)
    theta, ptheta, Xq_t = (torch.from_numpy(a) for a in (thetas, pthetas[0], Xq))
    out = {}
    for value in ("off", "on"):
        _set(value)
        lml = tlin.masked_lml(spec, theta, data.X, data.y, data.alpha_diag, data.mask)
        post, invs = tgp.posterior_and_invs(pspec, ptheta, pdata)
        assert (invs is None) == (value == "off")
        out[value] = (lml.numpy(), *tgp.predict(pspec, ptheta, post, pdata, Xq_t,
                                                 return_std=True, invs=invs))
    lml_rtol, m_rtol, m_atol, s_rtol, s_atol = TOL[dtype]
    np.testing.assert_allclose(out["on"][0], out["off"][0], rtol=lml_rtol)
    np.testing.assert_allclose(out["on"][1].numpy(), out["off"][1].numpy(), rtol=m_rtol,
                               atol=m_atol)
    np.testing.assert_allclose(out["on"][2].numpy(), out["off"][2].numpy(), rtol=s_rtol,
                               atol=s_atol)


def test_off_reaches_no_base_and_the_shape_rule(switches, monkeypatch):
    """"off" never reaches the base factor (K3 on the card; its plain
    version here); "on" leaves a gram below 128 or off the 64 grid to
    ``cholesky_ex`` at any dtype, "auto" takes the blocks at float32 only,
    as JAX's shape rule does."""
    calls = []
    real = chol_base.chol_inv_plain
    monkeypatch.setattr(chol_base, "chol_inv_plain", lambda M: calls.append(M.shape) or real(M))
    A = 2.0 * torch.eye(128)[None]
    y, mask = torch.ones(1, 128), torch.ones(128, dtype=torch.bool)
    _set("off")
    tlin.batched_lml_from_gram(A, y, mask)
    assert calls == []
    _set("auto")
    tlin.batched_lml_from_gram(A, y, mask)
    assert calls == [(1, 128, 128)]

    def fast(n, dtype):
        return tlin._use_fast_path(torch.empty(1, n, n, dtype=dtype))

    _set("on")
    assert not any(fast(n, torch.float64) for n in (64, 96, 160))
    assert fast(192, torch.float64) and fast(192, torch.float32)
    _set("auto")
    assert not fast(192, torch.float64) and fast(192, torch.float32)
    _set("off")
    assert not fast(192, torch.float32)


def _graph_key(value):
    g = mcmc.ChainGraph(key=("spec",), inputs=(torch.zeros(128, 3),), build=lambda bufs: None)
    _set(value)
    return mcmc._entry_key(g, 20, 4, torch.float32, "cuda:0")


def test_graph_key_holds_the_switch(switches):
    keys = {v: _graph_key(v) for v in VALUES}
    assert len(set(keys.values())) == 3
    assert _graph_key("auto") == keys["auto"]


@pytest.mark.parametrize("acq,n_samples", [("pvrs", 0), ("ei", 5)])
def test_fused_acquisition_off_takes_the_legacy_route(switches, monkeypatch, acq, n_samples):
    """With FUSED_ACQUISITION "off" the fused pass returns None, the tell
    calls the legacy dispatcher, and the next points equal the fused
    route's, tell after tell."""
    legacy_calls = []
    real_legacy = tacq.evaluate_acquisitions

    def counted(*a, **k):
        legacy_calls.append(1)
        return real_legacy(*a, **k)

    monkeypatch.setattr(tacq, "evaluate_acquisitions", counted)

    def next_xs(value):
        tacq.FUSED_ACQUISITION = value
        opt = Optimizer(dimensions=[(-1.0, 1.0), (0.0, 2.0)], n_points=60,
                        n_initial_points=3, init_strategy="random", acq_func=acq,
                        random_state=11, device="cpu")
        rng = np.random.RandomState(3)
        nxs = []
        for _ in range(5):
            x = opt.ask()
            opt.tell(x, float((np.asarray(x) ** 2).sum() + 0.05 * rng.randn()),
                     n_samples=n_samples, gp_samples=40, gp_burnin=3)
            if opt._next_x is not None:
                nxs.append(np.asarray(opt._next_x, dtype=float))
        return np.asarray(nxs)

    fused = next_xs("on")
    assert legacy_calls == []
    legacy = next_xs("off")
    assert len(legacy_calls) == len(legacy) > 0
    np.testing.assert_array_equal(fused, legacy)
    tacq.FUSED_ACQUISITION = "off"
    assert tacq.evaluate_acquisitions_fused(np.zeros((2, 2)), None, tacq.PVRS()) is None
