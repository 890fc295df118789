"""K1 and K2, the fused masked grams: their plain PyTorch versions
against the JAX package's Pallas kernels run in interpret mode, the
structure matcher, the CPU dispatch of the wrappers, and the lower-only
contract of the factorization that lets K2 skip the upper tiles. The CUDA
kernels themselves are tested in tests/test_torch_cuda.py."""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.experimental.pallas as pl  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.ops import gram, linalg  # noqa: E402


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


@pytest.mark.parametrize("has_const", [False, True])
@pytest.mark.parametrize("has_white", [False, True])
@pytest.mark.parametrize("n_ls", [1, 4])
def test_pack_params_matches_jax(has_const, has_white, n_ls):
    """The packed rows [amp, noise, 1/ls...] of every spec layout that the
    CUDA kernel now forms itself from thetas (it reads the same flags),
    against the JAX package's _pack_params: float32, within the 2 ulp of
    two exp implementations."""
    import bask_tpu.ops.pallas_gram as pg

    d, B = 4, 5
    n_theta = int(has_const) + n_ls + int(has_white)
    thetas = np.random.RandomState(9).randn(B, n_theta).astype(np.float32)
    spec = gram.FusedSpec(nu=2.5, n_ls=n_ls, has_const=has_const, has_white=has_white)
    ours = gram._pack_params(spec, torch.from_numpy(thetas), d).numpy()
    ref = np.asarray(
        pg._pack_params(pg.FusedSpec(*spec), jnp.asarray(thetas), B, d)
    )[:, 0, :]
    assert ours.shape == ref.shape == (B, d + 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=2.4e-7, atol=0)
    if not has_const:
        assert (ours[:, 0] == 1).all()
    if not has_white:
        assert (ours[:, 1] == 0).all()


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


def _nu_kernel(nu):
    ls = ((0.4, 0.2, 0.6), (0.05, 2.0))
    base = jk.RBF(*ls) if nu == math.inf else jk.Matern(*ls, nu=nu)
    return jk.ConstantKernel(1.0, (0.1, 2.0)) * base + jk.WhiteKernel(0.05, (1e-5, 1e5))


def _upper_tiles(n_pad):
    t = np.arange(n_pad) // gram._SQ_TILE
    return t[None, :] > t[:, None]


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
@pytest.mark.parametrize("per_walker", [False, True])
def test_lower_plain_matches_pallas_interpret(nu, per_walker, interpret_pallas):
    """K2's plain version against the JAX package's lower-triangle kernel
    at K1's tolerance; its lower part is exactly K1's plain version and
    its strictly upper 128-tiles are exactly 0 (n = 200 in n_pad = 256)."""
    pg = interpret_pallas
    kernel = _nu_kernel(nu)
    thetas, X, alpha = _inputs(kernel, 5, n=200, n_pad=256, d=3, B=2, per_walker=per_walker)
    K_jax = np.asarray(
        pg.fused_masked_gram_lower_batch(
            pg.match_fusable(kernel), jnp.asarray(thetas), jnp.asarray(X),
            jnp.asarray(alpha), 200,
        )
    )
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    args = (spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), 200)
    K2 = gram.fused_masked_gram_lower_batch(*args)
    assert K2.dtype == torch.float32 and K2.shape == K_jax.shape
    np.testing.assert_allclose(K2.numpy(), K_jax, rtol=0, atol=RTOL * np.abs(K_jax).max())
    upper = torch.from_numpy(_upper_tiles(256))
    K1 = gram.fused_masked_gram_plain(*args)
    assert torch.equal(K2[:, ~upper], K1[:, ~upper])
    assert torch.equal(K2[:, upper], torch.zeros_like(K2[:, upper]))
    assert (K_jax[:, _upper_tiles(256)] == 0).all()


def test_lower_wrapper_cpu_dispatch_and_refusal():
    kernel = _nu_kernel(2.5)
    thetas, X, alpha = _inputs(kernel, 6, n=100, n_pad=128, d=3, B=2)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    args = (spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), 100)
    before = gram.fused_masked_gram_lower_batch.launches
    assert torch.equal(
        gram.fused_masked_gram_lower_batch(*args), gram.fused_masked_gram_lower_plain(*args)
    )
    assert gram.fused_masked_gram_lower_batch.launches == before
    assert gram.LOWER_GRAM == "off"  # the JAX package's default
    thetas, X, alpha = _inputs(kernel, 6, n=100, n_pad=192, d=3, B=2)
    with pytest.raises(ValueError):  # the zero pattern needs 128-tiles
        gram.fused_masked_gram_lower_plain(
            spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), 100
        )


@pytest.mark.parametrize("n_pad", [128, 512, 640])
def test_lml_from_lower_gram_is_bit_identical(n_pad):
    """The blocked factorization reads only the lower 128-tiles, so the
    float32 LML of K2's gram equals that of K1's gram bit for bit; 640
    takes the ragged 256/256/128 panels of fast_cholesky.pick_nb (the
    port's counterpart of tests/test_pallas_gram.py's lower-gram case)."""
    kernel = _nu_kernel(2.5)
    n = n_pad - 12
    thetas, X, alpha = _inputs(kernel, 7, n=n, n_pad=n_pad, d=3, B=2)
    rng = np.random.RandomState(8)
    y = np.zeros(n_pad, np.float32)
    y[:n] = rng.randn(n)
    mask = torch.from_numpy(np.arange(n_pad) < n)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    args = (spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), n)
    K1 = gram.fused_masked_gram_plain(*args)
    K2 = gram.fused_masked_gram_lower_plain(*args)
    assert torch.equal(K1, K2) == (n_pad == 128)  # one tile: nothing to zero
    lml1 = linalg.batched_lml_from_gram(K1, torch.from_numpy(y), mask)
    lml2 = linalg.batched_lml_from_gram(K2, torch.from_numpy(y), mask)
    assert lml1.dtype == torch.float32 and torch.isfinite(lml1).all()
    assert torch.equal(lml1, lml2)
