"""K1, the fused masked gram: its plain PyTorch version against the JAX
package's Pallas kernel run in interpret mode, the structure matcher and
the CPU dispatch of the wrapper. The CUDA kernel itself is tested in
tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.experimental.pallas as pl  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.ops import gram  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    import bask_tpu.ops.pallas_gram as pg

    monkeypatch.setattr(
        pg.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    return pg


CASES = [
    jk.ConstantKernel(1.0, (0.1, 2.0))
    * jk.Matern((0.3, 0.3, 0.3), (0.05, 2.0), nu=2.5)
    + jk.WhiteKernel(0.05, (1e-5, 1e5)),
    jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.RBF((0.4, 0.2, 0.6), (0.05, 2.0)),
    jk.Matern((0.3, 0.5, 0.2), (0.05, 2.0), nu=1.5),
    jk.Matern(0.4, (0.05, 2.0), nu=0.5) + jk.WhiteKernel(0.1, (1e-5, 1e5)),
]

# Both are float32 with the same d2 = |xi|^2 + |xj|^2 - 2 xi.xj formula
# and differ by the summation order of the dot products: a few float32
# ulps of |x/ls|^2 times the kernel's slope. On the 15-D bench data that
# is below 4e-6 max|K| (the bound chip_smoke.py holds the CUDA kernel
# to); on these 3-D inputs, with lengthscales down to 0.2, the Pallas
# kernel itself sits up to 1.2e-5 max|K| from float64, hence 2e-5, the
# rtol tests/test_pallas_gram.py pins for the same kernel.
RTOL = 2e-5


def _inputs(kernel, seed, n, n_pad, d, B, per_walker=False):
    rng = np.random.RandomState(seed)
    shape = (B, n_pad, d) if per_walker else (n_pad, d)
    X = np.full(shape, 0.5, np.float32)
    X[..., :n, :] = rng.uniform(size=shape[:-2] + (n, d))
    alpha = np.full(n_pad, 1e-6, np.float32)
    thetas = (kernel.theta0[None, :] + 0.2 * rng.randn(B, kernel.n_theta)).astype(
        np.float32
    )
    return thetas, X, alpha


def _compare(pg, kernel, thetas, X, alpha, n):
    ours = convert.kernel_spec(kernel)
    spec_t = gram.match_fusable(ours)
    assert tuple(spec_t) == tuple(pg.match_fusable(kernel))
    K_jax = np.asarray(
        pg.fused_masked_gram_batch(
            pg.match_fusable(kernel), jnp.asarray(thetas), jnp.asarray(X),
            jnp.asarray(alpha), n,
        )
    )
    K = gram.fused_masked_gram_batch(
        spec_t, torch.from_numpy(thetas), torch.from_numpy(X),
        torch.from_numpy(alpha), n,
    ).numpy()
    assert K.dtype == np.float32 and K.shape == K_jax.shape
    np.testing.assert_allclose(K, K_jax, rtol=0, atol=RTOL * np.abs(K_jax).max())


@pytest.mark.parametrize("kernel", CASES)
def test_plain_matches_pallas_interpret(kernel, interpret_pallas):
    thetas, X, alpha = _inputs(kernel, 0, n=90, n_pad=128, d=3, B=3)
    _compare(interpret_pallas, kernel, thetas, X, alpha, 90)


def test_plain_per_walker_X_matches_pallas(interpret_pallas):
    kernel = CASES[0]
    thetas, X, alpha = _inputs(kernel, 1, n=60, n_pad=128, d=3, B=2, per_walker=True)
    _compare(interpret_pallas, kernel, thetas, X, alpha, 60)


def test_padding_layout():
    """Zero off the real block, 1 on the padded diagonal, noise + alpha
    on the real diagonal."""
    kernel = CASES[0]
    thetas, X, alpha = _inputs(kernel, 2, n=50, n_pad=64, d=3, B=2)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    K = gram.fused_masked_gram_plain(
        spec, torch.from_numpy(thetas).double(), torch.from_numpy(X).double(),
        torch.from_numpy(alpha).double(), 50,
    ).numpy()
    assert np.all(K[:, 50:, :50] == 0) and np.all(K[:, :50, 50:] == 0)
    np.testing.assert_array_equal(K[:, 50:, 50:], np.broadcast_to(np.eye(14), (2, 14, 14)))
    amp, noise = np.exp(thetas[:, 0]), np.exp(thetas[:, -1])
    np.testing.assert_allclose(
        np.diagonal(K[:, :50, :50], axis1=1, axis2=2),
        np.broadcast_to((amp + noise)[:, None] + 1e-6, (2, 50)), rtol=1e-6,
    )


def test_match_fusable():
    for k in CASES:
        assert gram.match_fusable(convert.kernel_spec(k)) is not None
    from bask_tpu_torch.ops import kernels as tk

    assert gram.match_fusable(tk.RBF(1.0, "fixed")) is None
    assert gram.match_fusable(tk.RBF(1.0, (0.1, 1.0)) * tk.Matern(1.0, (0.1, 1.0))) is None
    assert gram.match_fusable(tk.RBF(1.0, (0.1, 1.0)) + tk.RBF(1.0, (0.1, 1.0))) is None
    # K1 applies to CUDA tensors only: a CPU problem takes the spec path
    X = torch.zeros(64, 3, dtype=torch.float32)
    assert gram.fused_spec_for(convert.kernel_spec(CASES[0]), X) is None


def test_cpu_tensor_runs_plain_version():
    kernel = CASES[1]
    thetas, X, alpha = _inputs(kernel, 3, n=40, n_pad=64, d=3, B=2)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    before = gram.fused_masked_gram_batch.launches
    args = (spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), 40)
    np.testing.assert_array_equal(
        gram.fused_masked_gram_batch(*args).numpy(),
        gram.fused_masked_gram_plain(*args).numpy(),
    )
    assert gram.fused_masked_gram_batch.launches == before
