"""The port's CUDA kernels on a card: K1 (gram) and K3 (base Cholesky +
inverse) against their plain versions, their launch counters, the
wrappers' refusals, and the batched LML through both kernels.

Every test here needs a CUDA card and skips without one. The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu_torch.ops import chol_base, gram, linalg  # noqa: E402
from bask_tpu_torch.ops import kernels as bk  # noqa: E402

pytestmark = pytest.mark.cuda

KERNEL = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
    (0.3,) * 15, (0.05, 2.0), nu=2.5
) + bk.WhiteKernel(0.05, (1e-5, 1e5))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def _gram_inputs(dev, per_walker, B=8, n=500, n_pad=512, d=15):
    rng = np.random.RandomState(4)
    shape = (B, n_pad, d) if per_walker else (n_pad, d)
    X = np.full(shape, 0.5)
    X[..., :n, :] = rng.uniform(size=shape[:-2] + (n, d))
    thetas = KERNEL.theta0[None] + 0.2 * rng.randn(B, KERNEL.n_theta)
    return [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in (thetas, X, np.full(n_pad, 1e-6))
    ]


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
@pytest.mark.parametrize("per_walker", [False, True])
def test_gram_kernel_matches_plain(dev, nu, per_walker):
    """Against the plain version in float64 on the same float32 inputs:
    within 4e-6 max|K|, the float32 rounding of d2 at these 15-D points."""
    spec = gram.FusedSpec(nu=nu, n_ls=15, has_const=True, has_white=True)
    thetas, X, alpha = _gram_inputs(dev, per_walker)
    before = gram.fused_masked_gram_batch.launches
    K = gram.fused_masked_gram_batch(spec, thetas, X, alpha, 500)
    torch.cuda.synchronize()
    assert gram.fused_masked_gram_batch.launches == before + 1
    ref = gram.fused_masked_gram_plain(spec, thetas.double(), X.double(), alpha.double(), 500)
    assert torch.isfinite(K).all()
    assert float((K.double() - ref).abs().max()) <= 4e-6 * float(ref.abs().max())
    assert torch.equal(K[:, 500:, 500:], torch.eye(12, device=dev).expand(8, 12, 12))


def _spd_batch(rng, B, m):
    Xp = rng.uniform(size=(m, 5))
    K0 = np.exp(-0.5 * ((Xp[:, None] - Xp[None]) ** 2).sum(-1) / 0.3**2) + 1e-2 * np.eye(m)
    return np.broadcast_to(K0, (B, m, m)).copy() * (1.0 + 0.1 * rng.rand(B))[:, None, None]


@pytest.mark.parametrize("B,m", [(50, 32), (1, 32), (7, 24), (3, 16), (200, 32)])
def test_chol_kernel_matches_oracle(dev, B, m):
    """The bounds of tests/test_pallas_chol_base.py against the float64
    factor."""
    A = torch.tensor(_spd_batch(np.random.RandomState(0), B, m), dtype=torch.float32, device=dev)
    before = chol_base.chol_inv_base.launches
    L, X = chol_base.chol_inv_base(A)
    torch.cuda.synchronize()
    assert chol_base.chol_inv_base.launches == before + 1
    Lr, _ = chol_base.chol_inv_plain(A.double())
    assert float((L.double() - Lr).abs().max()) < 5e-6
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    assert float((X.double() @ Lr - eye).abs().max()) < 5e-5
    assert torch.equal(L, torch.tril(L)) and torch.equal(X, torch.tril(X))


def test_chol_kernel_nan_contract(dev):
    bad = -torch.eye(32, device=dev).expand(4, 32, 32).contiguous()
    L, X = chol_base.chol_inv_base(bad)
    assert torch.isnan(L[:, -1, -1]).all() and torch.isnan(X[:, -1, -1]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    spec = gram.match_fusable(KERNEL)
    thetas, X, alpha = _gram_inputs(dev, False)
    with pytest.raises(TypeError):
        gram.fused_masked_gram_batch(spec, thetas, X.double(), alpha, 500)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_batch(spec, thetas, X[:500], alpha[:500], 500)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_batch(spec, thetas.cpu(), X, alpha, 500)
    with pytest.raises(ValueError):  # 3 lengthscales for 15 input columns
        gram.fused_masked_gram_batch(spec._replace(n_ls=3), thetas[:, :5], X, alpha, 500)
    with pytest.raises(TypeError):
        chol_base.chol_inv_base(torch.eye(8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        chol_base.chol_inv_base(torch.eye(40, device=dev))


def test_batched_lml_runs_both_kernels(dev):
    """The chain's log-likelihood on the card (K1 gram, blocked factor
    with K3 bases) against the float64 CPU path."""
    rng = np.random.RandomState(5)
    n, n_pad, d = 100, 128, 15
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = np.sum((X[:n] - 0.5) ** 2, 1) + 0.05 * rng.randn(n)
    y[:n] = (y[:n] - y[:n].mean()) / y[:n].std()
    thetas = KERNEL.theta0[None] + 0.1 * rng.randn(10, KERNEL.n_theta)
    mask = np.arange(n_pad) < n

    def run(device, dtype):
        t = [torch.tensor(a, dtype=dtype, device=device) for a in (thetas, X, y, np.full(n_pad, 1e-6))]
        return linalg.batched_lml(KERNEL, *t, torch.tensor(mask, device=device), n_real=n)

    assert gram.fused_spec_for(KERNEL, torch.zeros(n_pad, d, device=dev)) is not None
    assert gram.fused_spec_for(KERNEL, torch.zeros(100, d, device=dev)) is None
    k1, k3 = gram.fused_masked_gram_batch.launches, chol_base.chol_inv_base.launches
    lml = run(dev, torch.float32).double().cpu().numpy()
    assert gram.fused_masked_gram_batch.launches == k1 + 1
    assert chol_base.chol_inv_base.launches > k3
    ref = run("cpu", torch.float64).numpy()
    assert np.isfinite(lml).all()
    np.testing.assert_allclose(lml, ref, rtol=1e-5)
