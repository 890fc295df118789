"""K4, the walker-batched gram: the port's wrapper
(``gram.fused_masked_gram_wb_batch``, its plain version on CPU tensors)
against the JAX package's K4, the ``pallas_call`` of
``benchmarks/bench_gram_wb.py:59 gram_wb``, rebuilt here from
``pallas_gram._pack_params`` / ``._tile_values`` and that script's
BlockSpecs and run in interpret mode; and the wrapper's refusals. The
CUDA kernel itself, bit-equal to K1, is tested in
tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import bask_tpu.ops.pallas_gram as pg  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.ops import gram  # noqa: E402

W, N, D = 10, 128, 3
# Both sides are float32 with the same d2 = |xi|^2 + |xj|^2 - 2 xi.xj and
# differ only in the summation order of the dots (XLA's strip product
# against torch's matmul on the CPU): a few float32 ulps of |x/ls|^2
# times the kernel's slope, inside the 4e-6 max|K| that K1 is held to
# (chip_smoke.py phase 2). Not bit for bit: the JAX K4 itself differs
# from the JAX K1 by ~1e-6 on the CPU, because its row strips change how
# the dot is rounded.
RTOL = 4e-6


def _kernel(nu):
    base = jk.RBF if nu == math.inf else jk.Matern
    kw = {} if nu == math.inf else {"nu": nu}
    return jk.ConstantKernel(1.0, (0.1, 2.0)) * base(
        tuple([0.3] * D), (0.05, 2.0), **kw
    ) + jk.WhiteKernel(0.05, (1e-5, 1e5))


def _jax_gram_wb(spec, thetas, X, alpha, n_real, wb, tile):
    """``bench_gram_wb.py``'s ``gram_wb`` (grid (W / wb, N / tile), an
    unrolled loop over the block's wb walkers around ``_tile_values``), in
    interpret mode."""
    n_walkers, d = thetas.shape[0], X.shape[1]
    n_pad = X.shape[0]
    packed = pg._pack_params(spec, thetas, n_walkers, d)
    n_real_arr = jnp.asarray(n_real, dtype=jnp.int32).reshape(1)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n_walkers // wb, n_pad // tile),
        in_specs=[
            pl.BlockSpec((wb, 1, d + 2), lambda g, i, n: (g, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, d), lambda g, i, n: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((n_pad, d), lambda g, i, n: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, 1), lambda g, i, n: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((wb, tile, n_pad), lambda g, i, n: (g, i, 0),
                               memory_space=pltpu.VMEM),
    )

    def body(n_ref, params_ref, x_ref, y_ref, alpha_ref, out_ref):
        i = pl.program_id(1)
        T, C = out_ref.shape[1], out_ref.shape[2]
        rows = i * T + jax.lax.broadcasted_iota(jnp.int32, (T, C), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (T, C), 1)
        for w in range(wb):
            out_ref[w, :, :] = pg._tile_values(
                spec, params_ref[w, 0, :], x_ref[:, :], y_ref[:, :], alpha_ref[:, 0],
                n_ref[0], rows, cols,
            )

    return pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((n_walkers, n_pad, n_pad), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(n_real_arr, packed, X, X, alpha[:, None])


def _inputs(kernel, seed, n_real):
    """bench_gram_wb.py's inputs at (W, N, D): X uniform, thetas at
    log 0.3 plus 0.05 normal noise; padded rows at 0.5."""
    rng = np.random.RandomState(seed)
    X = np.full((N, D), 0.5, np.float32)
    X[:n_real] = rng.uniform(size=(n_real, D))
    thetas = (np.log(0.3) + 0.05 * rng.randn(W, kernel.n_theta)).astype(np.float32)
    return thetas, X, np.full(N, 1e-6, np.float32)


@pytest.mark.parametrize("wb", [2, 5])
@pytest.mark.parametrize("nu,n_real", [(2.5, N), (0.5, 120), (math.inf, 100)])
def test_wb_gram_matches_the_jax_k4(wb, nu, n_real):
    kernel = _kernel(nu)
    thetas, X, alpha = _inputs(kernel, 0, n_real)
    K_jax = np.asarray(_jax_gram_wb(
        pg.match_fusable(kernel), jnp.asarray(thetas), jnp.asarray(X), jnp.asarray(alpha),
        n_real, wb, 64,
    ))
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    before = gram.fused_masked_gram_wb_batch.launches
    K = gram.fused_masked_gram_wb_batch(
        spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), n_real, wb
    )
    assert gram.fused_masked_gram_wb_batch.launches == before  # CPU: the plain version
    assert K.dtype == torch.float32 and K.shape == K_jax.shape == (W, N, N)
    np.testing.assert_allclose(K.numpy(), K_jax, rtol=0, atol=RTOL * np.abs(K_jax).max())


def test_wb_gram_on_cpu_is_k1s_plain_version():
    kernel = _kernel(1.5)
    thetas, X, alpha = _inputs(kernel, 1, 110)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    args = (spec, torch.from_numpy(thetas), torch.from_numpy(X), torch.from_numpy(alpha), 110)
    for wb in (1, 3, 10, 64):  # a ragged last block and more than W are accepted
        assert torch.equal(gram.fused_masked_gram_wb_batch(*args, wb),
                           gram.fused_masked_gram_plain(*args))


@pytest.mark.parametrize("case", ["per-walker X", "wb = 0", "wb = -2"])
def test_wb_gram_refusals(case):
    """K4 takes shared X only and at least one walker per block, on any
    device (on a card it also refuses what K1 refuses)."""
    kernel = _kernel(2.5)
    thetas, X, alpha = _inputs(kernel, 2, N)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    X_t, wb = torch.from_numpy(X), 2
    if case == "per-walker X":
        X_t = X_t.expand(W, N, D)
    else:
        wb = int(case.split("=")[1])
    with pytest.raises(ValueError):
        gram.fused_masked_gram_wb_batch(
            spec, torch.from_numpy(thetas), X_t, torch.from_numpy(alpha), N, wb
        )
