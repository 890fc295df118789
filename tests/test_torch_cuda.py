"""The port's CUDA kernels on a card: K1 and K2 (gram, full and lower
128-tiles; every layout of thetas the in-kernel packing reads) and K3
(Cholesky + inverse of blocks up to 128 wide, also read in place)
against their plain versions, their launch counters, K1's one device
operation per call, the wrappers' refusals, and the batched LML through
the kernels (with K2, bit-equal to the K1 run), and the batch-ask shapes:
K1 at (256, 1024, 1024), the blocked factorization of that size (8 K3
launches) against ``cholesky_ex`` in float64, and one pathwise top-k
against its float64 recomputation; and the paths of the fit options:
general-nu Matern and Exponentiation LMLs (plain grams, K3 bases, no
K1), lifted and host priors on CUDA tensors, the Laplace/MAP and device
L-BFGS fits, prediction gradients and pickling on the card; K4 (the
walker-batched gram) bit-equal to K1 for every nu, spec layout, a wide
d and the batch-ask shapes that the gram wrapper routes to it, and its
refusals.

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


SPEC_VARIANTS = {  # spec, number of thetas
    "no ConstantKernel": (gram.FusedSpec(2.5, 15, False, True), 16),
    "no WhiteKernel": (gram.FusedSpec(2.5, 15, True, False), 16),
    "isotropic": (gram.FusedSpec(2.5, 1, True, True), 3),
    "isotropic, RBF, alone": (gram.FusedSpec(math.inf, 1, False, False), 1),
}


@pytest.mark.parametrize("variant", sorted(SPEC_VARIANTS))
def test_gram_kernel_packs_every_spec_variant(dev, variant):
    """The kernel forms amp, noise and 1/ls from thetas itself: against
    the plain version (which packs with ``_pack_params``) in float64."""
    spec, n_theta = SPEC_VARIANTS[variant]
    _, X, alpha = _gram_inputs(dev, False)
    thetas = torch.tensor(
        np.log(0.4) + 0.2 * np.random.RandomState(7).randn(8, n_theta),
        dtype=torch.float32, device=dev,
    )
    K = gram.fused_masked_gram_batch(spec, thetas, X, alpha, 500)
    ref = gram.fused_masked_gram_plain(spec, thetas.double(), X.double(), alpha.double(), 500)
    torch.cuda.synchronize()
    assert torch.isfinite(K).all()
    assert float((K.double() - ref).abs().max()) <= 4e-6 * float(ref.abs().max())


def test_gram_wrapper_issues_one_device_operation(dev):
    """The packing runs inside the kernel: one call, one device operation,
    also for a column slice of a wider thetas array (strided rows)."""
    from torch.profiler import ProfilerActivity, profile

    thetas, X, alpha = _gram_inputs(dev, False)
    wide = torch.cat([thetas, torch.zeros_like(thetas[:, :4])], dim=1)
    spec = gram.match_fusable(KERNEL)
    for th in (thetas, wide[:, : KERNEL.n_theta]):
        gram.fused_masked_gram_batch(spec, th, X, alpha, 500)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K = gram.fused_masked_gram_batch(spec, th, X, alpha, 500)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ops) == 1, [e.name for e in ops]
        assert torch.equal(K, gram.fused_masked_gram_batch(spec, thetas, X, alpha, 500))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
@pytest.mark.parametrize("wb", [2, 5])
def test_wb_gram_kernel_is_k1_bit_for_bit(dev, nu, wb):
    """K4 at the chain's shape (50, 512, 512), d 15, n_real 500: every
    entry equal to K1's, and one launch counted."""
    spec = gram.FusedSpec(nu=nu, n_ls=15, has_const=True, has_white=True)
    thetas, X, alpha = _gram_inputs(dev, False, B=50)
    before = gram.fused_masked_gram_wb_batch.launches
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, wb)
    torch.cuda.synchronize()
    assert gram.fused_masked_gram_wb_batch.launches == before + 1
    assert torch.equal(K4, gram.fused_masked_gram_batch(spec, thetas, X, alpha, 500))


@pytest.mark.parametrize("variant", sorted(SPEC_VARIANTS))
def test_wb_gram_kernel_is_k1_for_every_spec_variant(dev, variant):
    """K4 reads thetas as K1 does: bit-equal for each layout, with a
    ragged last block (50 walkers, 3 per block)."""
    spec, n_theta = SPEC_VARIANTS[variant]
    _, X, alpha = _gram_inputs(dev, False)
    thetas = torch.tensor(
        np.log(0.4) + 0.2 * np.random.RandomState(8).randn(50, n_theta),
        dtype=torch.float32, device=dev,
    )
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 3)
    assert torch.equal(K4, gram.fused_masked_gram_batch(spec, thetas, X, alpha, 500))


@pytest.mark.parametrize("B,wb", [(256, 4), (256, 8), (128, 4), (128, 8)])
def test_wb_gram_kernel_at_the_batch_ask_shape(dev, B, wb):
    """K4 at (B, 1024, 1024), n_real 1,000: K1's gram bit for bit. The
    gram wrapper routes these shapes to K4 (wb 8): one K4 launch, no K1
    launch, the same gram."""
    spec, (thetas, X, alpha) = _batch_ask_grams(dev, B)
    assert (B, 1024, 15) in gram._K4_SHAPES and gram._K4_WB == 8
    k1, k4 = gram.fused_masked_gram_batch.launches, gram.fused_masked_gram_wb_batch.launches
    routed = gram.fused_masked_gram_batch(spec, thetas, X, alpha, 1000)
    assert gram.fused_masked_gram_batch.launches == k1
    assert gram.fused_masked_gram_wb_batch.launches == k4 + 1
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 1000, wb)
    assert torch.equal(routed, K4)
    assert torch.equal(K4, gram._k1_gram_batch(spec, thetas, X, alpha, 1000))
    assert gram.fused_masked_gram_batch.launches == k1 + 1


def test_wb_gram_kernel_restages_a_wide_d(dev):
    """d = 40 (three 16-wide chunks, re-staged per walker), isotropic and
    ARD, 7 walkers in blocks of 3: K1's gram bit for bit."""
    rng = np.random.RandomState(9)
    X = np.full((256, 40), 0.5)
    X[:230] = rng.uniform(size=(230, 40))
    X = torch.tensor(X, dtype=torch.float32, device=dev)
    alpha = torch.full((256,), 1e-6, device=dev)
    for n_ls in (1, 40):
        spec = gram.FusedSpec(nu=1.5, n_ls=n_ls, has_const=True, has_white=True)
        thetas = torch.tensor(np.log(1.5) + 0.2 * rng.randn(7, n_ls + 2),
                              dtype=torch.float32, device=dev)
        K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 230, 3)
        assert torch.equal(K4, gram.fused_masked_gram_batch(spec, thetas, X, alpha, 230))


@pytest.mark.parametrize("d", [15, 40])
def test_gram_kernels_keep_three_blocks_per_sm(dev, d):
    """The occupancy calculator on the built kernels: K1, K2 and K4 each
    keep the three resident blocks per SM their launch bounds ask for,
    for every nu (K4 with X staged once at d 15, re-staged at d 40)."""
    for kernel in ("K1", "K2", "K4"):
        for nu in (0.5, 1.5, 2.5, math.inf):
            assert gram._blocks_per_sm(kernel, nu, d) >= 3, (kernel, nu, d)


def test_wb_gram_wrapper_refuses_and_launches_one_operation(dev):
    """K4 refuses per-walker X, wb < 1 and what K1 refuses; one call is
    one device operation."""
    from torch.profiler import ProfilerActivity, profile

    spec = gram.match_fusable(KERNEL)
    thetas, X, alpha = _gram_inputs(dev, False)
    _, Xw, _ = _gram_inputs(dev, True)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_wb_batch(spec, thetas, Xw, alpha, 500, 2)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 0)
    with pytest.raises(TypeError):
        gram.fused_masked_gram_wb_batch(spec, thetas, X.double(), alpha, 500, 2)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_wb_batch(spec, thetas, X[:500], alpha[:500], 500, 2)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_wb_batch(spec._replace(n_ls=3), thetas[:, :5], X, alpha, 500, 2)
    gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 4)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ops) == 1, [e.name for e in ops]


def _spd_batch(rng, B, m):
    Xp = rng.uniform(size=(m, 5))
    K0 = np.exp(-0.5 * ((Xp[:, None] - Xp[None]) ** 2).sum(-1) / 0.3**2) + 1e-2 * np.eye(m)
    return np.broadcast_to(K0, (B, m, m)).copy() * (1.0 + 0.1 * rng.rand(B))[:, None, None]


def _check_chol(dev, A):
    """The bounds of tests/test_pallas_chol_base.py against the float64
    factor for m <= 32, times m / 32 above (the steps add roundings)."""
    m = A.shape[-1]
    before = chol_base.chol_inv_base.launches
    L, X = chol_base.chol_inv_base(A)
    torch.cuda.synchronize()
    assert chol_base.chol_inv_base.launches == before + 1
    assert L.is_contiguous() and X.is_contiguous() and L.shape == A.shape
    Lr, _ = chol_base.chol_inv_plain(A.double())
    scale = max(1.0, m / 32)
    assert float((L.double() - Lr).abs().max()) < 5e-6 * scale
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    assert float((X.double() @ Lr - eye).abs().max()) < 5e-5 * scale
    assert torch.equal(L, torch.tril(L)) and torch.equal(X, torch.tril(X))


@pytest.mark.parametrize(
    "B,m",
    [(50, 32), (1, 32), (7, 24), (3, 16), (200, 32), (50, 64), (50, 96), (50, 128), (7, 100)],
)
def test_chol_kernel_matches_oracle(dev, B, m):
    _check_chol(dev, torch.tensor(_spd_batch(np.random.RandomState(0), B, m),
                                  dtype=torch.float32, device=dev))


def test_chol_kernel_reads_a_diagonal_block_in_place(dev):
    """A 128-block of a (B, 512, 512) SPD batch, its upper triangle
    overwritten with NaN: the kernel reads the lower triangle where it
    lies, and gives what it gives on a contiguous copy of the block."""
    big = torch.tensor(_spd_batch(np.random.RandomState(1), 6, 512), dtype=torch.float32, device=dev)
    upper = torch.ones(512, 512, dtype=torch.bool, device=dev).triu(1)
    big = torch.where(upper, math.nan, big)
    block = big[:, 256:384, 256:384]
    assert not block.is_contiguous()
    _check_chol(dev, torch.tril(block.contiguous()))
    for a, b in zip(chol_base.chol_inv_base(block), chol_base.chol_inv_base(block.contiguous())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [32, 128])
def test_chol_kernel_nan_contract(dev, m):
    bad = -torch.eye(m, device=dev).expand(4, m, m).contiguous()
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
        chol_base.chol_inv_base(torch.eye(129, device=dev))
    with pytest.raises(TypeError):
        gram.fused_masked_gram_batch(spec, thetas.double(), X, alpha, 500)


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


def _upper_tiles(n_pad, dev):
    t = torch.arange(n_pad, device=dev) // 128
    return t[None, :] > t[:, None]


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
@pytest.mark.parametrize("per_walker", [False, True])
def test_lower_gram_kernel_matches_plain_and_k1(dev, nu, per_walker):
    """K2 within K1's bound of the float64 plain version, its computed
    entries bit-equal to K1's, its strictly upper 128-tiles exactly 0."""
    spec = gram.FusedSpec(nu=nu, n_ls=15, has_const=True, has_white=True)
    thetas, X, alpha = _gram_inputs(dev, per_walker)
    before = gram.fused_masked_gram_lower_batch.launches
    K2 = gram.fused_masked_gram_lower_batch(spec, thetas, X, alpha, 500)
    K1 = gram.fused_masked_gram_batch(spec, thetas, X, alpha, 500)
    torch.cuda.synchronize()
    assert gram.fused_masked_gram_lower_batch.launches == before + 1
    ref = gram.fused_masked_gram_lower_plain(spec, thetas.double(), X.double(), alpha.double(), 500)
    assert float((K2.double() - ref).abs().max()) <= 4e-6 * float(ref.abs().max())
    upper = _upper_tiles(512, dev)
    assert torch.equal(K2[:, ~upper], K1[:, ~upper])
    assert torch.equal(K2[:, upper], torch.zeros_like(K2[:, upper]))


def test_lower_gram_refuses_non_128_buckets(dev):
    spec = gram.match_fusable(KERNEL)
    thetas, X, alpha = _gram_inputs(dev, False, n=150, n_pad=192)
    with pytest.raises(ValueError):
        gram.fused_masked_gram_lower_batch(spec, thetas, X, alpha, 150)


@pytest.mark.parametrize("per_walker", [False, True])
def test_batched_lml_lower_gram_is_bit_identical(dev, monkeypatch, per_walker):
    """The chain's LML with LOWER_GRAM on (K2) equals the run with it off
    (K1) bit for bit: the factorization reads only the lower tiles."""
    rng = np.random.RandomState(6)
    n, n_pad, d, W = 200, 256, 15, 10
    shape = (W, n_pad, d) if per_walker else (n_pad, d)
    X = np.full(shape, 0.5)
    X[..., :n, :] = rng.uniform(size=shape[:-2] + (n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    thetas = KERNEL.theta0[None] + 0.1 * rng.randn(W, KERNEL.n_theta)
    t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (thetas, X, y, np.full(n_pad, 1e-6))]
    mask = torch.tensor(np.arange(n_pad) < n, device=dev)
    off = linalg.batched_lml(KERNEL, *t, mask, n_real=n)
    monkeypatch.setattr(gram, "LOWER_GRAM", "on")
    k2 = gram.fused_masked_gram_lower_batch.launches
    on = linalg.batched_lml(KERNEL, *t, mask, n_real=n)
    assert gram.fused_masked_gram_lower_batch.launches == k2 + 1
    assert torch.isfinite(off).all() and torch.equal(on, off)


def _batch_ask_grams(dev, B):
    """K1 grams of 1,000 uniform 15-D points padded to 1,024 for ``B``
    thetas near the kernel's start, with a 1e-2 noise floor."""
    rng = np.random.RandomState(7)
    X = np.full((1024, 15), 0.5)
    X[:1000] = rng.uniform(size=(1000, 15))
    thetas = KERNEL.theta0[None] + 0.1 * rng.randn(B, KERNEL.n_theta)
    thetas[:, -1] = np.log(1e-2)
    t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (thetas, X, np.full(1024, 1e-6))]
    return gram.match_fusable(KERNEL), t


def test_gram_kernel_at_the_batch_ask_shape(dev):
    """K1 at (256, 1024, 1024): 1.07 GB written by one launch, within
    4e-6 max|K| of the float64 plain version on four rows (K1 itself:
    the wrapper sends this shape to K4)."""
    spec, (thetas, X, alpha) = _batch_ask_grams(dev, 256)
    before = gram.fused_masked_gram_batch.launches
    K = gram._k1_gram_batch(spec, thetas, X, alpha, 1000)
    assert gram.fused_masked_gram_batch.launches == before + 1
    rows = [0, 85, 170, 255]
    ref = gram.fused_masked_gram_plain(spec, thetas[rows].double(), X.double(), alpha.double(), 1000)
    assert torch.isfinite(K).all()
    assert float((K[rows].double() - ref).abs().max()) <= 4e-6 * float(ref.abs().max())


def test_blocked_factorization_at_the_batch_ask_shape(dev):
    """The (256, 1024, 1024) blocked factorization (4 panels of 256, two
    128-wide K3 bases each) against cholesky_ex in float64: the LML
    terms of each gram within eps32 (3n + cond(K)) relative, to first
    order the factorization's and the sums' rounding (the gamma_3n of a
    Cholesky backward error) plus the solve's amplification of rounding
    K to float32 (phase 8 of chip_smoke.py holds its draws to the
    same)."""
    from bask_tpu_torch.ops import fast_cholesky as fc

    spec, (thetas, X, alpha) = _batch_ask_grams(dev, 256)
    K = gram.fused_masked_gram_batch(spec, thetas, X, alpha, 1000)
    y = torch.randn(1024, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    y[1000:] = 0.0
    yb = y.expand(K.shape[:-1])
    before = chol_base.chol_inv_base.launches
    _, logdiag, quad = fc.fast_lml_terms(K, yb)
    assert chol_base.chol_inv_base.launches == before + 8
    L64, info = torch.linalg.cholesky_ex(K.double())
    assert int(info.max()) == 0
    w = torch.linalg.solve_triangular(L64, yb.double()[..., None], upper=False)[..., 0]
    ref = (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum(-1), (w * w).sum(-1))
    ev = torch.linalg.eigvalsh(K.double()[:, :1000, :1000])
    tol = float(np.finfo(np.float32).eps) * (3 * 1000 + ev[:, -1] / ev[:, 0])
    for got, want in zip((logdiag, quad), ref):
        assert bool((((got.double() - want) / want.abs().clamp(min=1.0)).abs() <= tol).all())


def test_pathwise_topk_against_float64(dev):
    """One pathwise top-k on the card (K1 gram, K3 bases, chunks of
    draws) against the same draws recomputed in float64 with the plain
    gram and cholesky_ex: within eps32 (3n + cond(K)) of each draw's
    scale (as above), and each top-1 index within that of the float64
    minimum."""
    from bask_tpu_torch.models import gp as gpc
    from bask_tpu_torch.models import pathwise

    rng = np.random.RandomState(8)
    n, n_pad, d, S, m = 400, 448, 15, 16, 8192
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    rows = KERNEL.theta0[None] + 0.1 * rng.randn(S, KERNEL.n_theta)
    rows[:, -1] = np.log(1e-2)

    def data(dtype):
        t = [torch.tensor(a, dtype=dtype, device=dev) for a in (X, y, np.full(n_pad, 1e-6))]
        return gpc.make_data(*t, np.arange(n_pad) < n)

    spec = gram.match_fusable(KERNEL)
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = pathwise.draw_pathwise_randoms(gen, spec.nu, 1024, d, n_pad, 1, batch=(S,), device=dev)
    Xq = torch.tensor(rng.uniform(size=(m, d)), dtype=torch.float32, device=dev)
    before = gram.fused_masked_gram_batch.launches, chol_base.chol_inv_base.launches
    idx, draws = pathwise.pathwise_topk_hyper(
        spec, torch.tensor(rows, dtype=torch.float32, device=dev), data(torch.float32), Xq, rand,
        0, 8, n_real=n, keep=range(S),
    )
    assert gram.fused_masked_gram_batch.launches == before[0] + 1
    assert chol_base.chol_inv_base.launches > before[1]
    d64 = data(torch.float64)
    theta64 = torch.tensor(rows, dtype=torch.float64, device=dev)
    K = gram.fused_masked_gram_plain(spec, theta64, d64.X, d64.alpha_diag, n)
    L, _ = torch.linalg.cholesky_ex(K)
    ev = torch.linalg.eigvalsh(K[:, :n, :n])
    rand64 = pathwise.PathwiseRandoms(*(r.double() for r in rand))
    ref = pathwise._draw_values(
        spec, theta64, d64.X, d64, lambda R: torch.cholesky_solve(R, L), Xq.double(), rand64
    )[..., 0]
    eps32 = float(np.finfo(np.float32).eps)
    tol = eps32 * (3 * n + ev[:, -1] / ev[:, 0]) * ref.abs().max(dim=1).values
    err = (draws.double() - ref).abs().max(dim=1).values
    assert bool((err <= tol).all()), (err, tol)
    gap = ref.gather(1, idx[:, :1])[:, 0] - ref.min(dim=1).values
    assert bool((gap <= tol).all())


@pytest.mark.parametrize("name", ["matern-1.7", "exponentiation"])
def test_general_kernel_lml_on_the_card(dev, name):
    """Non-fusable kernels: the grams are plain torch (no K1 launch), the
    factorization blocked with K3 bases; the LMLs within 1e-5 relative of
    the float64 CPU run."""
    kernel = {
        "matern-1.7": bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * 15, (0.05, 2.0), nu=1.7)
        + bk.WhiteKernel(0.05, (1e-5, 1e5)),
        "exponentiation": bk.ConstantKernel(1.0, (0.1, 2.0))
        * bk.Exponentiation(bk.Matern((0.3,) * 15, (0.05, 2.0), nu=2.5), 2.0)
        + bk.WhiteKernel(0.05, (1e-5, 1e5)),
    }[name]
    rng = np.random.RandomState(9)
    n, n_pad, d, W = 200, 256, 15, 10
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    thetas = kernel.theta0[None] + 0.1 * rng.randn(W, kernel.n_theta)
    mask = np.arange(n_pad) < n

    def run(device, dtype):
        t = [torch.tensor(a, dtype=dtype, device=device) for a in (thetas, X, y, np.full(n_pad, 1e-6))]
        return linalg.batched_lml(kernel, *t, torch.tensor(mask, device=device), n_real=n)

    assert gram.fused_spec_for(kernel, torch.zeros(n_pad, d, device=dev)) is None
    k1, k3 = gram.fused_masked_gram_batch.launches, chol_base.chol_inv_base.launches
    lml = run(dev, torch.float32).double().cpu().numpy()
    assert gram.fused_masked_gram_batch.launches == k1
    assert chol_base.chol_inv_base.launches > k3
    assert np.isfinite(lml).all()
    np.testing.assert_allclose(lml, run("cpu", torch.float64).numpy(), rtol=1e-5)


def _small_fit_data():
    rng = np.random.RandomState(10)
    X = rng.uniform(size=(60, 3))
    return X, ((X - 0.4) ** 2).sum(1) + 0.02 * rng.randn(60)


def test_priors_on_cuda_tensors(dev):
    """A frozen SciPy logpdf is lifted and runs on the card; an opaque
    NumPy prior runs through the host adapter and comes back there."""
    import scipy.stats as sps

    from bask_tpu_torch import BayesGPR
    from bask_tpu_torch.models import bayesgpr as tbg

    gp = BayesGPR(bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * 3, (0.05, 2.0), nu=2.5),
                  random_state=0, device=dev)
    X, y = _small_fit_data()
    gp.fit(X, y, n_desired_samples=32, n_walkers_per_thread=16, n_burnin=2, warn_rhat=None,
           priors=[sps.halfnorm(scale=2).logpdf] * 5)
    theta = torch.rand(7, device=dev)
    lifted = gp._resolve_priors([sps.norm(0, 2).logpdf] * 5)[0]
    assert lifted(theta).device == theta.device
    with pytest.warns(UserWarning, match="adapter"):
        host = gp._resolve_priors([lambda x: sps.norm(0, 2).logpdf(x)] * 5)[0]
    assert isinstance(host, tbg._HostPrior)
    np.testing.assert_allclose(host(theta).cpu().numpy(), lifted(theta).cpu().numpy(), rtol=1e-6)


def test_fit_options_on_the_card(dev):
    """Laplace init + MAP warm start with restarts, and the device L-BFGS,
    fit on the card; the device L-BFGS's negative LML within 1e-3
    relative of the host L-BFGS-B's (float32)."""
    from bask_tpu_torch import BayesGPR
    from bask_tpu_torch.models import bayesgpr as tbg

    X, y = _small_fit_data()
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * 3, (0.05, 2.0), nu=2.5)
    kw = dict(n_desired_samples=32, n_walkers_per_thread=16, n_burnin=2, warn_rhat=None)
    lap = BayesGPR(kernel, random_state=0, device=dev, chain_init="laplace", ml2_objective="map",
                   n_restarts_optimizer=2).fit(X, y, **kw)
    assert np.isfinite(lap.theta).all() and np.isfinite(lap.log_marginal_likelihood_value_)
    thetas = {}
    for opt in ("lbfgs-device", "lbfgs"):
        gp = BayesGPR(kernel, random_state=0, device=dev, optimizer=opt, n_restarts_optimizer=2)
        gp._spec = kernel + bk.WhiteKernel(1.0, (1e-5, 1e5))
        gp._set_data(X, y, None)
        thetas[opt] = gp._ml2_optimize()
    f = {k: float(tbg._neg_lml_plain(gp._spec, gp._tensor(v), gp._data)) for k, v in thetas.items()}
    assert f["lbfgs-device"] <= f["lbfgs"] + 1e-3 * abs(f["lbfgs"])


def test_predict_grads_and_pickle_on_the_card(dev):
    """Prediction gradients of a float64 model on the card against central
    differences; a pickled card model loads on the card and predicts the
    same."""
    import pickle

    from bask_tpu_torch import BayesGPR

    X, y = _small_fit_data()
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * 3, (0.05, 2.0), nu=1.7)
    gp = BayesGPR(kernel, random_state=0, device=dev, dtype=torch.float64).fit(
        X, y, n_desired_samples=32, n_walkers_per_thread=16, n_burnin=2, warn_rhat=None
    )
    grid = np.random.RandomState(11).uniform(0.1, 0.9, size=(7, 3))
    _, _, mg, sg = gp.predict(grid, return_std=True, return_mean_grad=True, return_std_grad=True)
    h = 1e-6
    for i in range(3):
        e = np.zeros(3)
        e[i] = h
        mp, sp_ = gp.predict(grid + e, return_std=True)
        mm, sm = gp.predict(grid - e, return_std=True)
        np.testing.assert_allclose(mg[:, i], (mp - mm) / (2 * h), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(sg[:, i], (sp_ - sm) / (2 * h), rtol=1e-5, atol=1e-7)
    back = pickle.loads(pickle.dumps(gp))
    assert back._post.L.is_cuda
    np.testing.assert_array_equal(back.predict(grid), gp.predict(grid))
