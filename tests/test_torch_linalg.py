"""The port's blocked factorization, solves and batched LML against the
JAX package (float64 to rtol 1e-10, float32 to float32 tolerances),
-inf for a non-PD walker, the jitter-ladder rung, and padding
invariance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import bayesgpr as jbg  # noqa: E402
from bask_tpu.models import gp as jgp  # noqa: E402
from bask_tpu.ops import fast_cholesky as jfc  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.ops import linalg as jlin  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.ops import fast_cholesky as tfc  # noqa: E402
from bask_tpu_torch.ops import linalg as tlin  # noqa: E402

KERNEL = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern(
    (0.3, 0.3, 0.3), (0.05, 2.0), nu=2.5
) + jk.WhiteKernel(0.05, (1e-5, 1e5))


def _spd(rng, b, n, jitter=1e-3):
    A = rng.randn(b, n, n)
    return A @ np.swapaxes(A, -1, -2) / n + jitter * np.eye(n)


@pytest.mark.parametrize("n", [64, 256, 320, 576])
def test_block_cholesky_and_solves_f64(n):
    """320 has a ragged last panel (nb = 128); 576 has 256, 256 and a
    ragged 64 panel, so 128-wide K3 bases split the 256 panels once and
    factor the 64 panel whole."""
    rng = np.random.RandomState(0)
    A = _spd(rng, 2, n)
    y = rng.randn(2, n)
    Y = rng.randn(2, n, 3)
    L, invs = tfc.block_cholesky(torch.from_numpy(A))
    Lj, invs_j = jfc.block_cholesky(jnp.asarray(A))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-10, atol=1e-13)
    assert [iv.shape for iv in invs] == [iv.shape for iv in invs_j]
    w = tfc.block_forward_solve(L, invs, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(
        w, np.asarray(jfc.block_forward_solve(Lj, invs_j, jnp.asarray(y))), rtol=1e-10
    )
    for t_fn, j_fn in (
        (tfc.block_solve_lower_mat, jfc.block_solve_lower_mat),
        (tfc.block_solve_upper_mat, jfc.block_solve_upper_mat),
    ):
        np.testing.assert_allclose(
            t_fn(L, invs, torch.from_numpy(Y)).numpy(),
            np.asarray(j_fn(Lj, invs_j, jnp.asarray(Y))),
            rtol=1e-10, atol=1e-12,
        )
    _, ld, q = tfc.fast_lml_terms(torch.from_numpy(A), torch.from_numpy(y))
    _, ldj, qj = jfc.fast_lml_terms(jnp.asarray(A), jnp.asarray(y))
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-10)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=1e-10)


def test_block_cholesky_f32_matches_jax_f32():
    """float32: the port's bases are K3's steps, JAX's CPU bases are XLA's
    cholesky + Newton inverse; both are within float32 rounding of each
    other (the tolerances of tests/test_fast_cholesky.py)."""
    rng = np.random.RandomState(1)
    A = _spd(rng, 3, 256).astype(np.float32)
    y = rng.randn(3, 256).astype(np.float32)
    L, ld, q = tfc.fast_lml_terms(torch.from_numpy(A), torch.from_numpy(y))
    Lj, ldj, qj = jfc.fast_lml_terms(jnp.asarray(A), jnp.asarray(y))
    # atol ~ n eps_f32 |L|: the factor's entries accumulate n roundings
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=1e-4)


def _problem(rng, n, n_pad, d=3, dtype=np.float64):
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = np.sin(6 * X[:n, 0]) + 0.1 * rng.randn(n)
    alpha = np.full(n_pad, 1e-6)
    mask = np.arange(n_pad) < n
    return [a.astype(dtype) for a in (X, y, alpha)] + [mask]


def _lml_both(thetas, X, y, alpha, mask, n_real):
    ours = tlin.batched_lml(
        convert.kernel_spec(KERNEL), torch.from_numpy(thetas), torch.from_numpy(X),
        torch.from_numpy(y), torch.from_numpy(alpha), torch.from_numpy(mask),
        n_real=n_real,
    ).numpy()
    ref = np.asarray(
        jlin.batched_lml(
            KERNEL, jnp.asarray(thetas), jnp.asarray(X), jnp.asarray(y),
            jnp.asarray(alpha), jnp.asarray(mask),
        )
    )
    return ours, ref


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_batched_lml_matches_jax(dtype, rtol):
    """f64 runs LAPACK's factorization in both; f32 (n_pad = 128) runs
    the blocked factorization in both."""
    rng = np.random.RandomState(2)
    X, y, alpha, mask = _problem(rng, 100, 128, dtype=dtype)
    thetas = (KERNEL.theta0[None] + 0.3 * rng.randn(6, KERNEL.n_theta)).astype(dtype)
    ours, ref = _lml_both(thetas, X, y, alpha, mask, 100)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(ours, ref, rtol=rtol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_non_pd_walker_is_minus_inf(dtype):
    """Exact duplicate points with zero noise and jitter: a singular gram,
    -inf in both packages, and the other walkers stay finite."""
    rng = np.random.RandomState(3)
    X, y, alpha, mask = _problem(rng, 100, 128, dtype=dtype)
    X[50:100] = X[:50]
    alpha[:] = 0.0
    thetas = np.tile(KERNEL.theta0, (3, 1)).astype(dtype)
    thetas[1, -1] = -200.0  # noise exp(-200) = 0: singular
    ours, ref = _lml_both(thetas, X, y, alpha, mask, 100)
    assert ours[1] == -np.inf and ref[1] == -np.inf
    assert np.isfinite(ours[[0, 2]]).all()
    np.testing.assert_allclose(ours[[0, 2]], ref[[0, 2]], rtol=1e-10 if dtype == np.float64 else 1e-5)


def test_padding_invariance():
    """The same 60 points in the 64 and the 192 bucket: one LML."""
    rng = np.random.RandomState(4)
    thetas = torch.from_numpy(KERNEL.theta0[None] + 0.2 * rng.randn(4, KERNEL.n_theta))
    X, y, alpha, mask = _problem(rng, 60, 64)
    Xb, yb, ab, mb = _problem(np.random.RandomState(0), 60, 192)
    Xb[:60], yb[:60], ab[:60] = X[:60], y[:60], alpha[:60]
    spec = convert.kernel_spec(KERNEL)
    small, big = (
        tlin.batched_lml(spec, thetas, *(torch.from_numpy(a) for a in arrs), n_real=60)
        for arrs in ((X, y, alpha, mask), (Xb, yb, ab, mb))
    )
    np.testing.assert_allclose(big.numpy(), small.numpy(), rtol=1e-12)


@pytest.mark.parametrize("per_walker", [False, True])
def test_walker_chunking_is_invisible(monkeypatch, per_walker):
    """A gram budget of 3 walkers splits 7 walkers into chunks of 3, 3, 1;
    every walker's LML is unchanged."""
    rng = np.random.RandomState(6)
    X, y, alpha, mask = _problem(rng, 50, 64)
    if per_walker:
        X = X[None] + 0.01 * rng.uniform(size=(7,) + X.shape)
    thetas = torch.from_numpy(KERNEL.theta0[None] + 0.2 * rng.randn(7, KERNEL.n_theta))
    args = [torch.from_numpy(a) for a in (X, y, alpha, mask)]
    spec = convert.kernel_spec(KERNEL)
    full = tlin.batched_lml(spec, thetas, *args, n_real=50)
    monkeypatch.setattr(tlin, "LML_MAX_BATCH_BYTES", 3 * 64 * 64 * 8)
    assert tlin._lml_chunk_walkers(64, 8, 7) == 3
    np.testing.assert_array_equal(tlin.batched_lml(spec, thetas, *args, n_real=50).numpy(), full.numpy())


def test_masked_cholesky_turns_failure_into_nan():
    """cholesky_ex reports a failed factor through ``info`` with a partly
    filled L; the port maps it to an all-NaN factor, as XLA's cholesky
    reports it, without a host sync."""
    A = torch.eye(4, dtype=torch.float64).expand(2, 4, 4).clone()
    A[1, 2, 2] = -1.0
    L = tlin.masked_cholesky(A)
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).all()


def test_jitter_ladder_rung_matches_jax():
    """A numerically rank-deficient gram (long lengthscale, noise 0): the
    plain factor fails, the 1e-8 rung succeeds, in both packages."""
    n, n_pad = 40, 64
    rng = np.random.RandomState(5)
    X = np.full((n_pad, 1), 0.5)
    X[:n, 0] = rng.uniform(size=n)
    y = np.zeros(n_pad)
    y[:n] = np.sin(X[:n, 0])
    alpha = np.zeros(n_pad)
    mask = np.arange(n_pad) < n
    kernel = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.RBF(10.0, (0.05, 20.0))
    theta = kernel.theta0
    data_j = jgp.make_data(*(jnp.asarray(a) for a in (X, y, alpha)), jnp.asarray(mask))
    post_j = jbg._posterior_robust_body(jnp.asarray(theta), data_j, kernel)
    data_t = convert.gp_data(X, y, alpha, mask, device="cpu")
    spec = convert.kernel_spec(kernel)
    post_t = tbg._posterior_robust_body(torch.from_numpy(theta), data_t, spec)
    Kp = tlin.masked_gram(spec, torch.from_numpy(theta), data_t.X, data_t.alpha_diag, data_t.mask)
    assert torch.isnan(tlin.masked_cholesky(Kp)).any()  # rung 0 fails
    scale = Kp.diagonal().abs().mean()
    L1 = tlin.masked_cholesky(Kp + 1e-8 * scale * torch.eye(n_pad, dtype=Kp.dtype))
    assert torch.isfinite(L1).all()
    np.testing.assert_array_equal(post_t.L.numpy(), L1.numpy())
    np.testing.assert_allclose(post_t.L.numpy(), np.asarray(post_j.L), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(
        post_t.alpha_dual.numpy(), np.asarray(post_j.alpha_dual), rtol=1e-6, atol=1e-6
    )
