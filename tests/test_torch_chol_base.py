"""K3, the batched base Cholesky + inverse: its plain PyTorch version
against the JAX package's Pallas kernel in interpret mode and against the
float64 factor, the NaN contract and the CPU dispatch of the wrapper.
The CUDA kernel itself is tested in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.ops import pallas_chol_base as pcb  # noqa: E402
from bask_tpu_torch.ops import chol_base  # noqa: E402


def _spd_batch(rng, B, m):
    """The SPD blocks of tests/test_pallas_chol_base.py, float32."""
    Xp = rng.uniform(size=(m, 5))
    K0 = np.exp(-0.5 * ((Xp[:, None] - Xp[None]) ** 2).sum(-1) / 0.3**2) + 1e-2 * np.eye(m)
    A = np.broadcast_to(K0, (B, m, m)).copy() * (1.0 + 0.1 * rng.rand(B))[:, None, None]
    return A.astype(np.float32)


SHAPES = [(50, 32), (1, 32), (7, 24), (3, 16), (200, 32)]


@pytest.mark.parametrize("B,m", SHAPES)
def test_plain_matches_pallas_interpret_and_oracle(B, m):
    A = _spd_batch(np.random.RandomState(0), B, m)
    L, X = (t.numpy() for t in chol_base.chol_inv_base(torch.from_numpy(A)))
    Lj, Xj = (np.asarray(t) for t in pcb.chol_inv_base(jnp.asarray(A), interpret=True))
    # the same m float32 steps; only rsqrt and the FMA contraction may
    # round differently, by an ulp that the later steps carry along
    np.testing.assert_allclose(L, Lj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(X, Xj, rtol=0, atol=2e-5 * np.abs(Xj).max())
    # the oracle bounds of tests/test_pallas_chol_base.py
    Lr = np.linalg.cholesky(A.astype(np.float64))
    assert np.abs(L.astype(np.float64) - Lr).max() < 5e-6
    assert np.abs(X.astype(np.float64) @ Lr - np.eye(m)).max() < 5e-5
    assert np.array_equal(np.tril(L), L) and np.array_equal(np.tril(X), X)


def test_float64_plain_is_exact():
    A = _spd_batch(np.random.RandomState(1), 4, 32).astype(np.float64)
    L, X = (t.numpy() for t in chol_base.chol_inv_plain(torch.from_numpy(A)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(X @ L, np.broadcast_to(np.eye(32), A.shape), atol=1e-10)


def test_leading_batch_dims():
    A = _spd_batch(np.random.RandomState(2), 6, 16).reshape(2, 3, 16, 16)
    L, X = chol_base.chol_inv_base(torch.from_numpy(A))
    Lf, Xf = chol_base.chol_inv_base(torch.from_numpy(A.reshape(6, 16, 16)))
    assert L.shape == (2, 3, 16, 16)
    np.testing.assert_array_equal(L.reshape(6, 16, 16).numpy(), Lf.numpy())
    np.testing.assert_array_equal(X.reshape(6, 16, 16).numpy(), Xf.numpy())


def test_non_pd_propagates_nan():
    """rsqrt of a negative pivot -> NaN reaching the factor's last entry:
    the branchless failed-factorization -> -inf LML contract."""
    A = -np.broadcast_to(np.eye(32, dtype=np.float32), (4, 32, 32)).copy()
    L, X = chol_base.chol_inv_base(torch.from_numpy(A))
    assert torch.isnan(L[:, -1, -1]).all() and torch.isnan(X[:, -1, -1]).all()
    Lg, _ = chol_base.chol_inv_base(torch.from_numpy(_spd_batch(np.random.RandomState(1), 4, 32)))
    assert torch.isfinite(Lg).all()


def test_cpu_tensor_runs_plain_version():
    A = torch.from_numpy(_spd_batch(np.random.RandomState(3), 5, 32))
    before = chol_base.chol_inv_base.launches
    for a, b in zip(chol_base.chol_inv_base(A), chol_base.chol_inv_plain(A)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert chol_base.chol_inv_base.launches == before
