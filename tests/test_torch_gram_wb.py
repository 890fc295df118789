"""K4, the walker-batched gram: the port's wrapper
(``gram.fused_masked_gram_wb_batch``, its plain version on CPU tensors)
against the JAX package's K4, the ``pallas_call`` of
``benchmarks/bench_gram_wb.py:59 gram_wb``, rebuilt here from
``pallas_gram._pack_params`` / ``._tile_values`` and that script's
BlockSpecs and run in interpret mode; and the wrapper's refusals. Then
the arithmetic of the CUDA kernel (``csrc/gram_wb.cu``), emulated in
torch on the CPU: its cross term in 3xTF32 is within K1's 4e-6 max|K| of
float64 on the bench dataset for every nu, and one-pass TF32 is not. The
CUDA kernel itself is tested in tests/test_torch_cuda.py."""

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
from bask_tpu_torch.ops import kernels as bk_torch  # noqa: E402

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


# -- the kernel's arithmetic, emulated ------------------------------------


def _tf32(x):
    """float32 -> TF32 (10 explicit mantissa bits) by round to nearest,
    ties away from zero, on the bits, as the kernel forms hi."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_dropped(x):
    """What the tensor cores read of a float32 given as TF32: the low 13
    mantissa bits dropped (lo reaches them unrounded)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulated_wb_gram(spec, thetas, X, alpha, n_real, passes):
    """The gram as ``gram_wb.cu`` forms it from float32 inputs: rows
    centred on the mean of X's first 64 rows and scaled by 1/ls in
    float32; each point's |x/ls|^2 by a float32 FMA chain over its
    dimensions; the cross term from the TF32 parts hi = tf32(x) (to
    nearest) and lo = x - hi (its low 13 bits dropped, as the tensor cores
    read it) as lo.hi + hi.lo + hi.hi (``passes`` 3) or hi.hi alone (1),
    the products exact and their sum rounded once to float32
    (the tensor cores' accumulation taken as exact); d2 = (n_i + n_j) -
    2 dot in float32, clamped at 0 and exactly 0 on the diagonal; then the
    Matern, masks and diagonal in float64 (their float32 rounding is K1's
    and is not what this emulates)."""
    n_pad, d = X.shape
    packed = gram._pack_params(spec, thetas, d)
    amp, noise, ils = packed[:, 0].double(), packed[:, 1].double(), packed[:, 2:]
    centre = X[:64].mean(0)  # the kernel's centre, up to its summation order
    xs = (X - centre)[None] * ils[:, None, :]  # (B, n_pad, d) float32
    norm = torch.zeros(xs.shape[:-1], dtype=torch.float64)
    for k in range(d):  # fmaf: one rounding per step
        norm = (norm + xs[..., k].double() ** 2).float().double()
    hi = _tf32(xs)
    lo = _tf32_dropped(xs - hi)
    h, l = hi.double(), lo.double()
    dot = h @ h.transpose(1, 2)
    if passes == 3:
        dot = dot + (l @ h.transpose(1, 2) + h @ l.transpose(1, 2))
    dot = dot.float().double()
    d2 = ((norm[:, :, None] + norm[:, None, :]).float().double() - 2.0 * dot).float().double()
    idx = torch.arange(n_pad)
    eye = idx[:, None] == idx[None, :]
    d2 = torch.where(eye, 0.0, torch.clamp(d2, min=0.0))
    K = amp[:, None, None] * bk_torch.matern_from_d2(d2, spec.nu)
    real = idx < n_real
    K = torch.where(real[:, None] & real[None, :], K, 0.0)
    diag = torch.where(real, K.diagonal(dim1=-2, dim2=-1) + noise[:, None] + alpha.double(), 1.0)
    return torch.where(eye, torch.diag_embed(diag), K)


def _bench_grams(nu, B=8):
    """The bench dataset (chip_smoke.bench_dataset: n = 500 in 15-D padded
    to 512 with rows at 0.5), the bench kernel at nu, thetas at theta0 plus
    0.2 normal noise (seed 21, as chip_smoke phase 11 draws them)."""
    import chip_smoke

    X, _ = chip_smoke.bench_dataset()
    kernel = chip_smoke.bench_kernel(bk_torch, nu)
    rng = np.random.RandomState(21)
    thetas = torch.tensor(kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
                          dtype=torch.float32)
    Xt = torch.tensor(chip_smoke.padded(X), dtype=torch.float32)
    alpha = torch.full((chip_smoke.N_PAD,), 1e-6, dtype=torch.float32)
    spec = gram.match_fusable(kernel)
    ref = gram.fused_masked_gram_plain(spec, thetas.double(), Xt.double(), alpha.double(),
                                       chip_smoke.N_OBS)
    return (spec, thetas, Xt, alpha, chip_smoke.N_OBS), ref


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_3xtf32_cross_term_is_within_the_float64_tolerance(nu):
    """The kernel's 3xTF32 arithmetic on the bench dataset: within 4e-6
    max|K| of float64 (the bound K1 is held to), the diagonal exactly
    amp + noise + alpha where real and 1 where padded."""
    args, ref = _bench_grams(nu)
    K = _emulated_wb_gram(*args, passes=3)
    err = float((K - ref).abs().max())
    assert err <= 4e-6 * float(ref.abs().max()), err
    assert torch.equal(K.diagonal(dim1=-2, dim2=-1), ref.diagonal(dim1=-2, dim2=-1))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_one_pass_tf32_misses_the_float64_tolerance(nu):
    """The control: the cross term in plain TF32 (hi.hi only) misses the
    same bound on the same data, so the check can tell the two apart."""
    args, ref = _bench_grams(nu)
    K = _emulated_wb_gram(*args, passes=1)
    assert float((K - ref).abs().max()) > 4e-6 * float(ref.abs().max())


def test_tf32_control_refuses_cpu_tensors():
    kernel = _kernel(2.5)
    thetas, X, alpha = _inputs(kernel, 3, N)
    spec = gram.match_fusable(convert.kernel_spec(kernel))
    with pytest.raises(ValueError):
        gram._wb_tf32_control(spec, torch.from_numpy(thetas), torch.from_numpy(X),
                              torch.from_numpy(alpha), N, 2)
