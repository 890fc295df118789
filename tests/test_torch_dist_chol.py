"""The port's row-sharded Cholesky (``bask_tpu_torch.ops.dist_chol``)
against the JAX package, on a mesh of the CPU listed 8 times (or (2, 4)
and (4, 2)), float64: the LML against ``masked_lml`` of both packages and
JAX's ``row_sharded_lml`` at rtol 1e-10, predictions, covariance, draws,
the two LML gradients, prediction gradients, the 2-axis mesh, ``unroll``,
fuzzed shapes, non-PD -> -inf and bad shapes. The cases of
``tests/test_dist_chol.py``. Every JAX reference runs under ``jax.jit``:
op-by-op, a sharded JAX program takes ~12 s on this CPU, jitted < 1 s."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from bask_tpu.ops import dist_chol as jdc  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.ops import linalg as jlin  # noqa: E402
from bask_tpu.models import gp as jgp  # noqa: E402
from bask_tpu_torch.models import gp as tgp  # noqa: E402
from bask_tpu_torch.ops import dist_chol as tdc  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402
from bask_tpu_torch.ops import linalg as tlin  # noqa: E402
from bask_tpu_torch.parallel.mesh import Mesh  # noqa: E402


def _mesh(shape=(8,), names=("r",)):
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape).tolist(), names)


def _problem(n_pad=256, n_real=233, d=3, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n_pad, d))
    X[:n_real] = rng.uniform(size=(n_real, d))
    y = np.zeros(n_pad)
    y[:n_real] = np.sin(3.0 * X[:n_real, 0]) + 0.1 * rng.randn(n_real)
    mask = np.arange(n_pad) < n_real
    alpha = np.where(mask, 1e-6 + 1e-7 * rng.uniform(size=n_pad), 0.0)
    return X, y, alpha, mask


def _t(*arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _kernels(mod, d=3):
    return mod.ConstantKernel(1.0, (0.1, 10.0)) * mod.Matern(
        (0.3, 0.4, 0.5)[:d], (0.05, 5.0), nu=2.5
    ) + mod.WhiteKernel(0.05, (1e-5, 1e5))


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _jax_lml(kernel, theta, X, y, alpha, mask):
    return float(_jit(lambda t: jlin.masked_lml(kernel, t, *_j(X, y, alpha, mask)),
                      jnp.asarray(theta)))


@pytest.fixture(scope="module")
def jax_row_lml():
    """JAX's row_sharded_lml on its 8 virtual CPU devices, by nb."""
    X, y, alpha, mask = _problem()
    kernel = _kernels(jk)
    mesh = JMesh(np.array(jax.devices("cpu")[:8]), ("r",))
    theta = jnp.asarray(kernel.theta0 + 0.1)
    return {nb: float(_jit(lambda t: jdc.row_sharded_lml(
        kernel, t, *_j(X, y, alpha, mask), mesh=mesh, nb=nb), theta)) for nb in (16, 32, 64)}


@pytest.mark.parametrize("n_loc,nb", [(64, 256), (96, 64), (2048, 256), (32, 7)])
def test_pick_row_nb(n_loc, nb):
    assert tdc.pick_row_nb(n_loc, nb) == jdc.pick_row_nb(n_loc, nb)


@pytest.mark.parametrize("nb", [16, 32, 64])
@pytest.mark.parametrize("unroll", [False, True])
def test_matches_masked_lml(nb, unroll, jax_row_lml):
    kt, kj = _kernels(tk), _kernels(jk)
    X, y, alpha, mask = _problem()
    theta = kj.theta0 + 0.1
    want_j = _jax_lml(kj, theta, X, y, alpha, mask)
    want_t = float(tlin.masked_lml(kt, torch.as_tensor(theta), *_t(X, y, alpha, mask)))
    got = float(tdc.row_sharded_lml(kt, torch.as_tensor(theta), *_t(X, y, alpha, mask),
                                    mesh=_mesh(), nb=nb, unroll=unroll))
    assert np.isfinite(want_j)
    np.testing.assert_allclose(got, want_j, rtol=1e-10)
    np.testing.assert_allclose(got, want_t, rtol=1e-10)
    np.testing.assert_allclose(got, jax_row_lml[nb], rtol=1e-10)


@pytest.mark.parametrize("which", ["rbf", "matern15_white"])
def test_no_padding_and_other_kernels(which):
    X, y, alpha, mask = _problem(n_pad=128, n_real=128, d=2, seed=3)
    alpha = np.full_like(alpha, 1e-5)

    def make(mod):
        if which == "rbf":
            return mod.ConstantKernel(2.0, (0.1, 10.0)) * mod.RBF(0.5, (0.05, 5.0))
        return mod.ConstantKernel(1.0, (0.1, 10.0)) * mod.Matern(
            (0.3, 0.5), (0.05, 5.0), nu=1.5
        ) + mod.WhiteKernel(0.05, (1e-5, 1e5))

    kj, kt = make(jk), make(tk)
    theta = kj.theta0 - 0.2
    want = _jax_lml(kj, theta, X, y, alpha, mask)
    got = float(tdc.row_sharded_lml(kt, torch.as_tensor(theta), *_t(X, y, alpha, mask),
                                    mesh=_mesh()))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_batch_matches_vmapped_masked_lml():
    kj, kt = _kernels(jk), _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=192, n_real=171, seed=5)
    thetas = kj.theta0[None, :] + 0.15 * np.random.RandomState(7).randn(6, kj.n_theta)
    want = _jit(jax.vmap(lambda t: jlin.masked_lml(kj, t, *_j(X, y, alpha, mask))),
                jnp.asarray(thetas))
    got = tdc.row_sharded_lml_batch(kt, torch.as_tensor(thetas), *_t(X, y, alpha, mask),
                                    mesh=_mesh(), nb=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def _dense(mod_gp, kernel, theta, X, y, alpha, mask, y_mean, y_std):
    data = mod_gp.make_data(X, y, alpha, mask, y_mean=y_mean, y_std=y_std)
    return data, mod_gp.posterior(kernel, theta, data)


@pytest.mark.parametrize("noise_free", [False, True])
def test_predict_matches_gp_predict(noise_free):
    """Mean, std and LML from the sweep against JAX's and the port's dense
    readout, with y renormalized; ``noise_free`` predicts with the White
    variance out of the query side (``theta_diag``)."""
    kj, kt = _kernels(jk), _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=256, n_real=229, seed=21)
    theta = kj.theta0 + 0.07
    y_mean, y_std = 0.31, 1.7
    Xq = np.random.RandomState(3).uniform(size=(17, 3))
    white = kj.n_theta - 1
    tq = np.array(theta)
    if noise_free:
        tq[white] = -np.inf

    def ref(t, tq):
        dj, pj = _dense(jgp, kj, t, *_j(X, y, alpha, mask), y_mean, y_std)
        return jgp.predict(kj, tq, pj, dj, jnp.asarray(Xq), return_std=True)

    mu_ref, std_ref = jax.jit(ref)(jnp.asarray(theta), jnp.asarray(tq))
    lml_ref = _jax_lml(kj, theta, X, y, alpha, mask)

    out = tdc.row_sharded_predict(
        kt, torch.as_tensor(theta), *_t(X, y, alpha, mask), torch.as_tensor(Xq), mesh=_mesh(),
        nb=32, y_mean=y_mean, y_std=y_std, theta_diag=torch.as_tensor(tq), return_lml=True,
    )
    mu, std, lml = (o.numpy() for o in out)
    np.testing.assert_allclose(mu, np.asarray(mu_ref), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(std, np.asarray(std_ref), rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(float(lml), lml_ref, rtol=1e-10)


def test_predict_cov_and_sample_y_match_gp():
    """The covariance against JAX's and the port's dense ``predict``
    (1e-8), and the draws against the port's dense ``sample_y`` from the
    same standard normals (1e-6)."""
    kj, kt = _kernels(jk), _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=128, n_real=117, seed=31)
    theta = kj.theta0 - 0.05
    y_mean, y_std = -0.2, 0.9
    Xq = np.random.RandomState(5).uniform(size=(9, 3))

    def ref(t):
        dj, pj = _dense(jgp, kj, t, *_j(X, y, alpha, mask), y_mean, y_std)
        return jgp.predict(kj, t, pj, dj, jnp.asarray(Xq), return_cov=True)

    mu_ref, cov_ref = _jit(ref, jnp.asarray(theta))
    tt = torch.as_tensor(theta)
    mu, cov = tdc.row_sharded_predict(
        kt, tt, *_t(X, y, alpha, mask), torch.as_tensor(Xq), mesh=_mesh(), nb=16,
        y_mean=y_mean, y_std=y_std, return_cov=True,
    )
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(cov.numpy(), np.asarray(cov_ref), rtol=1e-8, atol=1e-10)

    z = torch.as_tensor(np.random.RandomState(42).randn(9, 4))
    dt, pt = _dense(tgp, kt, tt, *_t(X, y, alpha, mask), y_mean, y_std)
    draws_ref = tgp.sample_y(kt, tt, pt, dt, torch.as_tensor(Xq), z)
    draws = tdc.row_sharded_sample_y(
        kt, tt, *_t(X, y, alpha, mask), torch.as_tensor(Xq), z, mesh=_mesh(), n_samples=4,
        nb=16, y_mean=y_mean, y_std=y_std,
    )
    np.testing.assert_allclose(draws.numpy(), draws_ref.numpy(), rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="z must be"):
        tdc.row_sharded_sample_y(kt, tt, *_t(X, y, alpha, mask), torch.as_tensor(Xq), z,
                                 mesh=_mesh(), n_samples=3)


@pytest.mark.parametrize("method", ["adjoint", "jvp"])
def test_value_grad_matches_dense(method):
    """The closed-form adjoint gradient and the jvp gradient against
    JAX's autodiff of the dense ``masked_lml`` and the port's autograd,
    with a padding mask."""
    kj, kt = _kernels(jk), _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=128, n_real=113, seed=51)
    theta = kj.theta0 + 0.11
    v_j, g_j = _jit(jax.value_and_grad(
        lambda t: jlin.masked_lml(kj, t, *_j(X, y, alpha, mask))
    ), jnp.asarray(theta))
    tt = torch.as_tensor(theta).requires_grad_(True)
    v_t = tlin.masked_lml(kt, tt, *_t(X, y, alpha, mask))
    (g_t,) = torch.autograd.grad(v_t, tt)

    v, g = tdc.row_sharded_lml_value_grad(
        kt, torch.as_tensor(theta), *_t(X, y, alpha, mask), _mesh(), nb=16, method=method
    )
    np.testing.assert_allclose(float(v), float(v_j), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), g_t.numpy(), rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="adjoint"):
        tdc.row_sharded_lml_value_grad(kt, torch.as_tensor(theta), *_t(X, y, alpha, mask),
                                       _mesh(), nb=16, method="bogus")


@pytest.mark.parametrize("noise_free", [False, True])
def test_predict_gradients_match_autodiff(noise_free):
    """``return_grad``'s extra sweep columns against JAX's autodiff of the
    dense mean and std in each query point (masking, y scaling, and the
    noise-free query side)."""
    kj, kt = _kernels(jk), _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=128, n_real=109, seed=41)
    theta = kj.theta0 + 0.03
    y_mean, y_std = 0.4, 1.3
    Xq = np.random.RandomState(7).uniform(size=(5, 3))
    tq = np.array(theta)
    if noise_free:
        tq[kj.n_theta - 1] = -np.inf
    def ref(Xq):
        dj, pj = _dense(jgp, kj, jnp.asarray(theta), *_j(X, y, alpha, mask), y_mean, y_std)

        def mean_one(x):
            return jgp.predict(kj, jnp.asarray(tq), pj, dj, x[None, :])[0]

        def std_one(x):
            return jgp.predict(kj, jnp.asarray(tq), pj, dj, x[None, :], return_std=True)[1][0]

        return jax.vmap(jax.grad(mean_one))(Xq), jax.vmap(jax.grad(std_one))(Xq)

    mg_ref, sg_ref = (np.asarray(a) for a in _jit(ref, jnp.asarray(Xq)))
    out = tdc.row_sharded_predict(
        kt, torch.as_tensor(theta), *_t(X, y, alpha, mask), torch.as_tensor(Xq), mesh=_mesh(),
        nb=16, y_mean=y_mean, y_std=y_std, theta_diag=torch.as_tensor(tq), return_grad=True,
        return_lml=True,
    )
    assert len(out) == 5
    np.testing.assert_allclose(out[2].numpy(), mg_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(out[3].numpy(), sg_ref, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(out[4]), _jax_lml(kj, theta, X, y, alpha, mask), rtol=1e-10)
    with pytest.raises(ValueError, match="return_cov"):
        tdc.row_sharded_predict(kt, torch.as_tensor(theta), *_t(X, y, alpha, mask),
                                torch.as_tensor(Xq), mesh=_mesh(), nb=16, return_grad=True,
                                return_cov=True)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_walker_row_2d_mesh(shape):
    kj, kt = _kernels(jk), _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=192, n_real=180, seed=9)
    thetas = kj.theta0[None, :] + 0.1 * np.random.RandomState(11).randn(8, kj.n_theta)
    want = _jit(jax.vmap(lambda t: jlin.masked_lml(kj, t, *_j(X, y, alpha, mask))),
                jnp.asarray(thetas))
    got = tdc.walker_row_sharded_lml(kt, torch.as_tensor(thetas), *_t(X, y, alpha, mask),
                                     mesh=_mesh(shape, ("w", "r")), nb=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("bad", ["walkers", "rows", "axes"])
def test_walker_row_2d_mesh_rejects_bad_shapes(bad):
    kt = _kernels(tk)
    mesh = _mesh((2, 4), ("w", "r"))
    n_pad, W = {"walkers": (192, 5), "rows": (98, 4), "axes": (192, 4)}[bad]
    X, y, alpha, mask = _problem(n_pad=n_pad, n_real=90)
    thetas = torch.as_tensor(kt.theta0[None, :] + np.zeros((W, 1)))
    if bad == "axes":
        with pytest.raises(ValueError, match="2-axis"):
            tdc.walker_row_sharded_lml(kt, thetas, *_t(X, y, alpha, mask), mesh=_mesh())
        return
    with pytest.raises(ValueError, match="divisible"):
        tdc.walker_row_sharded_lml(kt, thetas, *_t(X, y, alpha, mask), mesh=mesh)


def test_unrolled_sweep_matches_loop():
    """``unroll=True`` against ``unroll=False`` (JAX's two sweep forms; the
    port runs the trapezoid for both) across LML, predictions and
    covariance."""
    kt = _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=192, n_real=177, seed=41)
    theta = torch.as_tensor(kt.theta0 + 0.03)
    Xq = torch.as_tensor(np.random.RandomState(8).uniform(size=(7, 3)))
    args = _t(X, y, alpha, mask)
    lml_loop = float(tdc.row_sharded_lml(kt, theta, *args, mesh=_mesh(), nb=24))
    lml_unroll = float(tdc.row_sharded_lml(kt, theta, *args, mesh=_mesh(), nb=24, unroll=True))
    np.testing.assert_allclose(lml_unroll, lml_loop, rtol=1e-12)
    kw = dict(mesh=_mesh(), nb=24, y_mean=0.4, y_std=1.3, return_cov=True, return_lml=True)
    out_loop = tdc.row_sharded_predict(kt, theta, *args, Xq, **kw)
    out_unroll = tdc.row_sharded_predict(kt, theta, *args, Xq, unroll=True, **kw)
    for a, b in zip(out_unroll, out_loop):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_shapes_and_panels(trial):
    """Random (n_pad, n_real, nb, d) on the 8-entry mesh against JAX's
    dense masked LML: the owner/panel offsets across block alignments."""
    rng = np.random.RandomState(123 + trial)
    d = int(rng.randint(1, 4))
    n_pad = 8 * int(rng.randint(3, 25))
    n_real = int(rng.randint(max(2, n_pad // 2), n_pad + 1))
    nb = int(rng.randint(2, 40))
    kj, kt = (m.ConstantKernel(1.0, (0.1, 10.0)) * m.Matern(tuple([0.4] * d), (0.05, 5.0), nu=2.5)
              + m.WhiteKernel(0.05, (1e-5, 1e5)) for m in (jk, tk))
    X = np.zeros((n_pad, d))
    X[:n_real] = rng.uniform(size=(n_real, d))
    y = np.zeros(n_pad)
    y[:n_real] = rng.randn(n_real)
    mask = np.arange(n_pad) < n_real
    alpha = np.where(mask, 1e-5, 0.0)
    theta = kj.theta0 + 0.1 * rng.randn(kj.n_theta)
    want = _jax_lml(kj, theta, X, y, alpha, mask)
    got = float(tdc.row_sharded_lml(kt, torch.as_tensor(theta), *_t(X, y, alpha, mask),
                                    mesh=_mesh(), nb=nb))
    assert np.isfinite(want), (n_pad, n_real, nb)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               err_msg=f"n_pad={n_pad} n_real={n_real} nb={nb}")


@pytest.mark.parametrize("unroll", [False, True])
def test_non_pd_gives_neg_inf(unroll):
    kj, kt = (m.ConstantKernel(1.0, (0.1, 10.0)) * m.Matern(0.3, (0.05, 5.0), nu=2.5)
              for m in (jk, tk))
    n_pad, n_real = 128, 100
    rng = np.random.RandomState(1)
    X = np.zeros((n_pad, 1))
    pts = rng.uniform(size=(n_real // 2, 1))
    X[:n_real] = np.concatenate([pts, pts])  # exact duplicates
    y = np.zeros(n_pad)
    y[:n_real] = rng.randn(n_real)
    mask = np.arange(n_pad) < n_real
    alpha = np.zeros(n_pad)  # no jitter: the gram is singular
    assert _jax_lml(kj, kj.theta0, X, y, alpha, mask) == -np.inf
    got = float(tdc.row_sharded_lml(kt, torch.as_tensor(kt.theta0), *_t(X, y, alpha, mask),
                                    mesh=_mesh(), unroll=unroll))
    assert got == -np.inf


@pytest.mark.parametrize("fn", ["lml", "predict", "value_grad"])
def test_rejects_indivisible_n(fn):
    kt = _kernels(tk)
    X, y, alpha, mask = _problem(n_pad=100, n_real=90)
    theta = torch.as_tensor(kt.theta0)
    args = _t(X, y, alpha, mask)
    with pytest.raises(ValueError, match="divisible"):
        if fn == "lml":
            tdc.row_sharded_lml(kt, theta, *args, mesh=_mesh())
        elif fn == "predict":
            tdc.row_sharded_predict(kt, theta, *args, args[0][:3], mesh=_mesh())
        else:
            tdc.row_sharded_lml_value_grad(kt, theta, *args, _mesh())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diagonal_block_factor_is_k3_recursion(dtype):
    """A float32 diagonal block comes from the blocked recursion on K3
    bases (their plain version on the CPU), bit-equal to
    ``_chol_inv_recursive``; K3 is float32 only, so a float64 block goes
    through ``cholesky_ex`` and a triangular solve, as the dense path's
    does. A non-PD block gives NaN, not a raise, in both."""
    from bask_tpu_torch.ops import chol_base
    from bask_tpu_torch.ops.fast_cholesky import _chol_inv_recursive

    rng = np.random.RandomState(0)
    A = rng.randn(256, 256)
    A = torch.as_tensor(A @ A.T / 256 + 1e-3 * np.eye(256), dtype=dtype)
    L, Linv = tdc._factor_block(A)
    if dtype == torch.float32:
        L2, Linv2 = _chol_inv_recursive(A, chol_base.chol_inv_plain)
        rtol, atol = 1e-4, 1e-5
    else:
        L2 = torch.linalg.cholesky(A)
        Linv2 = torch.linalg.solve_triangular(L2, torch.eye(256, dtype=dtype), upper=False)
        rtol, atol = 1e-10, 1e-12
    assert torch.equal(L, L2) and torch.equal(Linv, Linv2)
    np.testing.assert_allclose((L @ L.T).numpy(), A.numpy(), rtol=rtol, atol=atol)
    bad = A.clone()
    bad[200, 200] = -1.0
    Lb, _ = tdc._factor_block(bad)
    assert torch.isnan(Lb).any()
