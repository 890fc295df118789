"""The port's CUDA kernels on a card: K1 and K2 (gram, full and lower
128-tiles; every layout of thetas the in-kernel packing reads) and K3
(Cholesky + inverse of blocks up to 128 wide, also read in place)
against their plain versions, their launch counters, K1's one device
operation per call (each K1 itself, as ``gram._k1_gram_batch`` calls
it), the wrappers' refusals, and the batched LML through
the kernels (with K2, bit-equal to the K1 run), and the batch-ask shapes:
K1 at (256, 1024, 1024), the blocked factorization of that size (8 K3
launches) against ``cholesky_ex`` in float64, and one pathwise top-k
against its float64 recomputation; and the paths of the fit options:
general-nu Matern and Exponentiation LMLs (plain grams, K3 bases, no
K1), lifted and host priors on CUDA tensors, the Laplace/MAP and device
L-BFGS fits, prediction gradients and pickling on the card; K4 (the
walker-batched gram) within K1's float64 tolerance and twice that of K1
for every nu, spec layout, a wide d (X resident and not), an n_pad past
what fits in shared memory and the batch-ask shapes, bit for bit the
same across B and wb, its one-pass TF32 control missing the tolerance,
the route choosing it by (n_pad, d), and its refusals; the meshes on
the one card: walker shards over [cuda:0] x 2 equal to the unsharded
LML (the routed gram and K3 in each shard), the row-sharded
LML at n = 2,048 on 4 strips against float64 (K3 on every diagonal
block), -inf for a non-PD gram, the row sweep's (256, 256) block on
two K3 bases against K3's plain version, and row mode at float64 (its
blocks by cholesky_ex) against the dense float64 model; K1, K2 and K4
with ``n_real`` as a device scalar bit-equal to the int, the chain
replayed from CUDA graphs bit-equal to the eager chain (K4, K2 on warped
X, K1, and bucket 64's cholesky_ex) with the same launch counts, and no
graph captured after ``warmup_optimizer`` (the warm tells' medians
replay); the geometric median's block of iterations captured on a key's
second call and replayed bit-equal to the eager loop; the chain at
``linalg.FAST_CHOLESKY = "off"`` (cuSOLVER) replayed bit-equal to its
eager chain with no K3, a flip of the switch capturing anew, and "on" at
float64 (K3's plain version as the bases) against "off"; K5 (the pathwise draws'
values) against its float64 plain version for every nu, R 1, 3, 8 and
11, n_pad 512 and 1,024, d 1, 15, 16, 17, 32 and 40 (the tensor-core
kernel up to 31, PR 10's FP32 kernel past it), shared and per-row
queries, with and without the cross term, Cauchy-tailed features on the
float64 path, bit-equal across launches, its launch plan, a NaN row, its
refusals, and the batch ask's draws launching it twice without a
(m, n_pad) slab; K6 and K7 (the input warp and its inverse) against
their float64 plain versions at float32 and float64 (shared and per-row
inputs, a ragged n, d past 256, x at and past the ends), one launch per
call, the card's x-gradient through the autograd Function against the
pdf (and its refusal of a gradient in the log-parameters), and both
captured in a CUDA graph, replayed bit-equal to eager.

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
from bask_tpu_torch.utils import median, trace  # noqa: E402

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
    # K1 itself: the gram wrapper sends shared X at (512, 15) to K4
    K = gram._k1_gram_batch(spec, thetas, X, alpha, 500)
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
    K = gram._k1_gram_batch(spec, thetas, X, alpha, 500)
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
        gram._k1_gram_batch(spec, th, X, alpha, 500)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K = gram._k1_gram_batch(spec, th, X, alpha, 500)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ops) == 1, [e.name for e in ops]
        assert torch.equal(K, gram._k1_gram_batch(spec, thetas, X, alpha, 500))


def _check_wb_gram(K4, spec, thetas, X, alpha, n_real, rows=None, k1=True):
    """K4's gram against the float64 plain version (K1's 4e-6 max|K|, on
    ``rows`` of the batch where given) and against K1 on the same inputs
    (twice that); exactly symmetric; the diagonal exact: amp + noise +
    alpha as K1 forms it where real, 1 where padded."""
    rows = list(range(thetas.shape[0])) if rows is None else rows
    ref = gram.fused_masked_gram_plain(spec, thetas[rows].double(), X.double(),
                                       alpha.double(), n_real)
    tol = 4e-6 * float(ref.abs().max())
    assert torch.isfinite(K4).all()
    assert torch.equal(K4, K4.transpose(1, 2))  # each tile computed once, mirrored
    assert float((K4[rows].double() - ref).abs().max()) <= tol
    diag = K4.diagonal(dim1=-2, dim2=-1)
    if k1:
        K1 = gram._k1_gram_batch(spec, thetas, X, alpha, n_real)
        assert float((K4 - K1).abs().max()) <= 2 * tol
        assert torch.equal(diag, K1.diagonal(dim1=-2, dim2=-1))
    assert torch.equal(diag[:, n_real:], torch.ones_like(diag[:, n_real:]))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
@pytest.mark.parametrize("wb", [2, 5])
def test_wb_gram_kernel_is_k1_bit_for_bit(dev, nu, wb):
    """K4 at the chain's shape (50, 512, 512), d 15, n_real 500: within
    4e-6 max|K| of float64 and twice that of K1 (its 3xTF32 cross term
    rounds otherwise than K1's FMA chain, so no longer bit for bit), the
    diagonal K1's exactly; one launch counted."""
    spec = gram.FusedSpec(nu=nu, n_ls=15, has_const=True, has_white=True)
    thetas, X, alpha = _gram_inputs(dev, False, B=50)
    before = gram.fused_masked_gram_wb_batch.launches
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, wb)
    torch.cuda.synchronize()
    assert gram.fused_masked_gram_wb_batch.launches == before + 1
    _check_wb_gram(K4, spec, thetas, X, alpha, 500)


@pytest.mark.parametrize("variant", sorted(SPEC_VARIANTS))
def test_wb_gram_kernel_is_k1_for_every_spec_variant(dev, variant):
    """K4 reads thetas as K1 does: for each layout, with a ragged last
    unit (50 walkers, 3 per unit), within the float64 tolerance and twice
    that of K1, the diagonal K1's."""
    spec, n_theta = SPEC_VARIANTS[variant]
    _, X, alpha = _gram_inputs(dev, False)
    thetas = torch.tensor(
        np.log(0.4) + 0.2 * np.random.RandomState(8).randn(50, n_theta),
        dtype=torch.float32, device=dev,
    )
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 3)
    _check_wb_gram(K4, spec, thetas, X, alpha, 500)


@pytest.mark.parametrize("B,wb", [(256, 4), (256, 8), (128, 4), (128, 8)])
def test_wb_gram_kernel_at_the_batch_ask_shape(dev, B, wb):
    """K4 at (B, 1024, 1024), n_real 1,000, against float64 on four rows
    and against K1. The gram wrapper routes (1024, 15) to K4: one K4
    launch, no K1 launch, the same gram bit for bit whatever the wb."""
    spec, (thetas, X, alpha) = _batch_ask_grams(dev, B)
    assert (1024, 15) in gram._K4_ROUTE
    k1, k4 = gram.fused_masked_gram_batch.launches, gram.fused_masked_gram_wb_batch.launches
    routed = gram.fused_masked_gram_batch(spec, thetas, X, alpha, 1000)
    assert gram.fused_masked_gram_batch.launches == k1
    assert gram.fused_masked_gram_wb_batch.launches == k4 + 1
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 1000, wb)
    assert torch.equal(routed, K4)
    _check_wb_gram(K4, spec, thetas, X, alpha, 1000, rows=[0, B // 3, 2 * B // 3, B - 1])
    assert gram.fused_masked_gram_batch.launches == k1 + 1


@pytest.mark.parametrize("n_pad", [256, 1024])
def test_wb_gram_kernel_restages_a_wide_d(dev, n_pad):
    """d = 40 (three chunks of 16 input dimensions), isotropic and ARD, 7
    walkers in units of 3: X resident in shared memory at n_pad 256, read
    per unit from global memory at 1,024 (it does not fit); within the
    float64 tolerance and twice that of K1."""
    rng = np.random.RandomState(9)
    n = n_pad - 26
    X = np.full((n_pad, 40), 0.5)
    X[:n] = rng.uniform(size=(n, 40))
    X = torch.tensor(X, dtype=torch.float32, device=dev)
    alpha = torch.full((n_pad,), 1e-6, device=dev)
    assert gram._wb_info(1.5, 7, n_pad, 40, 3)["x_resident"] == (n_pad == 256)
    for n_ls in (1, 40):
        spec = gram.FusedSpec(nu=1.5, n_ls=n_ls, has_const=True, has_white=True)
        thetas = torch.tensor(np.log(1.5) + 0.2 * rng.randn(7, n_ls + 2),
                              dtype=torch.float32, device=dev)
        K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, n, 3)
        _check_wb_gram(K4, spec, thetas, X, alpha, n)


@pytest.mark.parametrize("n_pad,resident", [(576, True), (2048, False), (2112, False)])
def test_wb_gram_kernel_past_what_fits_in_shared_memory(dev, n_pad, resident):
    """n_pad past the resident X (2,048 and 2,112 at d 15: X read per
    unit) and n_pad % 128 = 64 (576, 2,112: the last tiles half outside
    the gram), 3 walkers, nu 1/2, against float64 on every row."""
    rng = np.random.RandomState(10)
    n = n_pad - 40
    X = np.full((n_pad, 15), 0.5)
    X[:n] = rng.uniform(size=(n, 15))
    X = torch.tensor(X, dtype=torch.float32, device=dev)
    alpha = torch.full((n_pad,), 1e-6, device=dev)
    spec = gram.FusedSpec(nu=0.5, n_ls=15, has_const=True, has_white=True)
    thetas = torch.tensor(KERNEL.theta0[None] + 0.2 * rng.randn(3, KERNEL.n_theta),
                          dtype=torch.float32, device=dev)
    assert gram._wb_info(0.5, 3, n_pad, 15, 2)["x_resident"] == resident
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, n, 2)
    _check_wb_gram(K4, spec, thetas, X, alpha, n, k1=False)


def test_wb_gram_kernel_is_deterministic_across_batch_and_wb(dev):
    """A walker's gram does not depend on how many walkers share the call,
    on wb, or on which block computed it: bit for bit."""
    spec = gram.match_fusable(KERNEL)
    thetas, X, alpha = _gram_inputs(dev, False, B=50)
    ref = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 1)
    for wb in (2, 3, 8, 50, 64):
        assert torch.equal(gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, wb), ref)
    for lo, hi, wb in ((0, 7, 2), (20, 33, 4), (49, 50, 1), (10, 35, 8)):
        part = gram.fused_masked_gram_wb_batch(spec, thetas[lo:hi], X, alpha, 500, wb)
        assert torch.equal(part, ref[lo:hi]), (lo, hi, wb)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_wb_tf32_control_misses_the_tolerance(dev, nu):
    """The same kernel with a one-pass TF32 cross term misses the float64
    tolerance that the 3xTF32 kernel meets, on the same inputs."""
    spec = gram.FusedSpec(nu=nu, n_ls=15, has_const=True, has_white=True)
    thetas, X, alpha = _gram_inputs(dev, False, B=8)
    ref = gram.fused_masked_gram_plain(spec, thetas.double(), X.double(), alpha.double(), 500)
    tol = 4e-6 * float(ref.abs().max())
    before = gram.fused_masked_gram_wb_batch.launches
    control = gram._wb_tf32_control(spec, thetas, X, alpha, 500, 2)
    assert gram.fused_masked_gram_wb_batch.launches == before
    K4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, 500, 2)
    assert float((K4.double() - ref).abs().max()) <= tol
    assert not float((control.double() - ref).abs().max()) <= tol


def test_gram_route_chooses_k4_by_n_pad_and_d(dev):
    """fused_masked_gram_batch sends shared X at every (n_pad, d) of the
    route to K4 for any number of walkers, with the route's wb (the same
    gram bit for bit), and everything else to K1: per-walker X and an
    (n_pad, d) off the route."""
    spec = gram.match_fusable(KERNEL)
    for (n_pad, d), wb in gram._K4_ROUTE.items():
        for B in (1, 3, 128):
            thetas, X, alpha = _gram_inputs(dev, False, B=B, n=n_pad - 12, n_pad=n_pad, d=d)
            k1, k4 = gram.fused_masked_gram_batch.launches, gram.fused_masked_gram_wb_batch.launches
            K = gram.fused_masked_gram_batch(spec, thetas, X, alpha, n_pad - 12)
            assert gram.fused_masked_gram_batch.launches == k1
            assert gram.fused_masked_gram_wb_batch.launches == k4 + 1
            assert torch.equal(K, gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, n_pad - 12, wb))
    off_route = [(256, 15), (1024, 14)]
    assert not any(key in gram._K4_ROUTE for key in off_route)
    isotropic = gram.FusedSpec(nu=2.5, n_ls=1, has_const=True, has_white=True)
    for n_pad, d in off_route:
        thetas, X, alpha = _gram_inputs(dev, False, B=4, n=n_pad - 12, n_pad=n_pad, d=d)
        k1, k4 = gram.fused_masked_gram_batch.launches, gram.fused_masked_gram_wb_batch.launches
        gram.fused_masked_gram_batch(isotropic, thetas[:, :3], X, alpha, n_pad - 12)
        assert gram.fused_masked_gram_batch.launches == k1 + 1
        assert gram.fused_masked_gram_wb_batch.launches == k4
    thetas, Xw, alpha = _gram_inputs(dev, True, B=4)
    k1 = gram.fused_masked_gram_batch.launches
    gram.fused_masked_gram_batch(spec, thetas, Xw, alpha, 500)
    assert gram.fused_masked_gram_batch.launches == k1 + 1


@pytest.mark.parametrize("d", [15, 40])
def test_gram_kernels_keep_three_blocks_per_sm(dev, d):
    """The occupancy calculator on the built kernels: K1 and K2 each keep
    the three resident blocks per SM their launch bounds ask for, for
    every nu; K4 is persistent, one 512-thread block per SM, with X
    resident in shared memory at (1024, 15) and read per unit at d 40."""
    for kernel in ("K1", "K2"):
        for nu in (0.5, 1.5, 2.5, math.inf):
            assert gram._blocks_per_sm(kernel, nu, d) >= 3, (kernel, nu, d)
    for nu in (0.5, 1.5, 2.5, math.inf):
        assert gram._blocks_per_sm("K4", nu, d, n_pad=1024) == 1, (nu, d)
        info = gram._wb_info(nu, 256, 1024, d, 8)
        assert info["x_resident"] == (d == 15)
        assert info["grid"] == min(info["units"], torch.cuda.get_device_properties(0).multi_processor_count)


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
    K1 = gram._k1_gram_batch(spec, thetas, X, alpha, 500)
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
    """One pathwise top-k on the card (K1 gram, K3 bases, K5 values)
    against the same draws recomputed in float64 with the plain
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


# -- meshes and the row-sharded Cholesky on the card ------------------------


def _mesh_inputs(dev, W=16, n=500, n_pad=512, d=15):
    thetas, X, alpha = _gram_inputs(dev, False, B=W, n=n, n_pad=n_pad, d=d)
    rng = np.random.RandomState(9)
    y = torch.zeros(n_pad, device=dev)
    y[:n] = torch.tensor(rng.randn(n), dtype=torch.float32, device=dev)
    mask = torch.arange(n_pad, device=dev) < n
    return thetas, X, y, alpha, mask


def test_walker_sharded_lml_on_the_card(dev):
    """batched_lml over [cuda:0] x 2 against the unsharded call: every
    shard launches the gram the route gives (512, 15) (K4, else K1) and
    its K3 bases; the results agree to float32 rounding (cuBLAS may pick
    other GEMM kernels for the smaller batch)."""
    from bask_tpu_torch.parallel.mesh import Mesh

    args = _mesh_inputs(dev)
    plain = linalg.batched_lml(KERNEL, *args, n_real=500)
    routed = gram.fused_masked_gram_wb_batch if (512, 15) in gram._K4_ROUTE else gram.fused_masked_gram_batch
    k1, k3 = routed.launches, chol_base.chol_inv_base.launches
    sharded = linalg.batched_lml(KERNEL, *args, n_real=500, mesh=Mesh([dev] * 2))
    torch.cuda.synchronize()
    assert routed.launches - k1 == 2
    assert chol_base.chol_inv_base.launches - k3 == 8
    assert sharded.device == plain.device
    np.testing.assert_allclose(sharded.cpu().numpy(), plain.cpu().numpy(), rtol=1e-6)


@pytest.mark.parametrize("unroll", [False, True])
def test_row_sharded_lml_on_the_card(dev, unroll):
    """The row-sharded LML at n = 2,048 on 4 strips of the card (K3 on
    every diagonal block) against the float64 dense LML, within twice the
    float32 cholesky_ex error; a non-PD gram gives -inf with no raise."""
    from bask_tpu_torch.ops import dist_chol
    from bask_tpu_torch.parallel.mesh import Mesh

    n = 2048
    rng = np.random.RandomState(3)
    X = torch.tensor(rng.uniform(size=(n, 15)), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.randn(n), dtype=torch.float32, device=dev)
    alpha = torch.full((n,), 1e-6, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    theta = torch.tensor(KERNEL.theta0, dtype=torch.float32, device=dev)
    mesh = Mesh([dev] * 4, ("rows",))
    k3 = chol_base.chol_inv_base.launches
    got = float(dist_chol.row_sharded_lml(KERNEL, theta, X, y, alpha, mask, mesh, nb=256,
                                          unroll=unroll))
    assert chol_base.chol_inv_base.launches - k3 == 2 * n // 256
    want = float(linalg.masked_lml(KERNEL, theta.double(), X.double(), y.double(),
                                   alpha.double(), mask))
    K32 = linalg.masked_gram(KERNEL, theta, X, alpha, mask)
    L, _ = torch.linalg.cholesky_ex(K32)
    w = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    chol32 = float(-0.5 * (w * w).sum() - torch.log(L.diagonal()).sum()
                   - 0.5 * n * math.log(2 * math.pi))
    # twice cholesky_ex's float32 error, at least twice the float32
    # spacing at the LML (all three agree to its rounding at n = 32,768)
    assert abs(got - want) <= max(2 * float(np.spacing(np.float32(abs(want)))),
                                  2 * abs(chol32 - want))
    dup = torch.cat([X[: n // 2], X[: n // 2]])
    bad = theta.clone()
    bad[-1] = -math.inf
    lml_bad = dist_chol.row_sharded_lml(KERNEL, bad, dup, y, torch.zeros_like(alpha), mask,
                                        mesh, nb=256, unroll=unroll)
    assert float(lml_bad) == -math.inf


def test_row_diagonal_block_on_k3(dev):
    """The sweep's (256, 256) diagonal block factored by the recursion on
    two K3 bases against K3's plain version in float64; NaN for a non-PD
    block."""
    from bask_tpu_torch.ops import dist_chol

    rng = np.random.RandomState(5)
    A = rng.randn(256, 256)
    A = torch.tensor(A @ A.T / 256 + 1e-2 * np.eye(256), dtype=torch.float32, device=dev)
    k3 = chol_base.chol_inv_base.launches
    L, Linv = dist_chol._factor_block(A)
    torch.cuda.synchronize()
    assert chol_base.chol_inv_base.launches - k3 == 2
    Lr, Xr = chol_base.chol_inv_plain(A.double())
    np.testing.assert_allclose(L.double().cpu().numpy(), Lr.cpu().numpy(), atol=1e-5)
    eye = torch.eye(256, dtype=torch.float64, device=dev)
    assert float((Linv.double() @ Lr - eye).abs().max()) < 1e-4
    bad = A.clone()
    bad[200, 200] = -1.0
    assert torch.isnan(dist_chol._factor_block(bad)[0]).any()


def test_row_mode_at_float64_on_the_card(dev):
    """Row mode at float64 on the card: K3 takes float32 only, so the
    sweep factors its diagonal blocks by cholesky_ex, as the dense path
    does at float64. ``BayesGPR(dtype=torch.float64, row_mesh=[cuda:0] x
    2)``: the row LML and its adjoint gradient at the start theta against
    the dense float64 LML and its autograd gradient, then a short fit and
    ``predict(return_std=True)`` against the dense model at the fitted
    theta, at the CPU row-mode tests' tolerances; no K3 launch."""
    from bask_tpu_torch.models import bayesgpr as tbg
    from bask_tpu_torch.ops import dist_chol
    from bask_tpu_torch.parallel.mesh import Mesh

    rng = np.random.RandomState(9)
    n, d = 300, 3
    X = rng.uniform(size=(n, d))
    y = np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.randn(n)
    user = bk.ConstantKernel(1.0, (0.1, 10.0)) * bk.Matern((0.5,) * d, (0.05, 5.0), nu=2.5)

    def model(row_mesh=None):
        return tbg.BayesGPR(kernel=user, random_state=0, device=dev, dtype=torch.float64,
                            row_mesh=row_mesh, row_nb=64)

    mesh = Mesh([dev] * 2, ("rows",))
    row, dense = model(mesh), model()
    for gp in (row, dense):
        gp._spec = user + bk.WhiteKernel(1.0, (1e-5, 1e5))
        gp._set_data(X, y, None)
    t0 = row._tensor(row._spec.theta0)
    dd = row._data
    k3 = chol_base.chol_inv_base.launches
    v, g = dist_chol.row_sharded_lml_value_grad(row._spec, t0, dd.X, dd.y, dd.alpha_diag,
                                                dd.mask, mesh, nb=64)
    nv, ng = tbg._log_post_value_grad(dense._data, t0, dense._spec, (), 0)
    np.testing.assert_allclose(float(v), -nv, rtol=1e-10)
    np.testing.assert_allclose(g.cpu().numpy(), -ng, rtol=1e-8, atol=1e-8)
    row.fit(X, y, n_desired_samples=16, n_burnin=0, n_walkers_per_thread=8, progress=False)
    assert chol_base.chol_inv_base.launches == k3
    assert np.isfinite(row.theta).all() and math.isfinite(row.log_marginal_likelihood_value_)
    dense._spec = row._spec
    dense._set_data(X, y, None)
    dense.theta = row.theta
    np.testing.assert_allclose(row.log_marginal_likelihood_value_,
                               dense.log_marginal_likelihood(row.theta), rtol=1e-10)
    Xq = np.random.RandomState(10).uniform(size=(20, d))
    m_r, s_r = row.predict(Xq, return_std=True)
    m_d, s_d = dense.predict(Xq, return_std=True)
    np.testing.assert_allclose(m_r, m_d, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(s_r, s_d, rtol=1e-7, atol=1e-9)


# -- n_real as a device scalar, and the chain's CUDA graphs --------------------


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4"])
@pytest.mark.parametrize("n_real", [0, 1, 449, 500, 512])
def test_device_n_real_is_the_int_bit_for_bit(dev, kernel, n_real):
    """Each gram kernel reads n_real from a 1-element int32 device tensor:
    the same gram bit for bit as with the int (ragged, empty and full real
    blocks); a count outside [0, n_pad] gives a gram of NaN in its
    computed tiles, where an int is refused on the host."""
    spec = gram.match_fusable(KERNEL)
    thetas, X, alpha = _gram_inputs(dev, False)
    fn = {"K1": gram._k1_gram_batch, "K2": gram.fused_masked_gram_lower_batch,
          "K4": lambda *a: gram.fused_masked_gram_wb_batch(*a, 2)}[kernel]
    as_int = fn(spec, thetas, X, alpha, n_real)
    as_tensor = fn(spec, thetas, X, alpha, torch.tensor([n_real], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(as_int, as_tensor)
    if n_real == 512:
        bad = fn(spec, thetas, X, alpha, torch.tensor([513], dtype=torch.int32, device=dev))
        computed = ~_upper_tiles(512, dev) if kernel == "K2" else torch.ones_like(bad[0], dtype=torch.bool)
        assert torch.isnan(bad[:, computed]).all()
        with pytest.raises(ValueError, match="n_real"):
            fn(spec, thetas, X, alpha, 513)
        with pytest.raises(ValueError, match="int32"):
            fn(spec, thetas, X, alpha, torch.tensor([500], device=dev))


def _chain_model(dev, warp, n, d, W, graphs, lower="off", steps=12, route="auto"):
    """A fit (no warm start: theta0) of 6 x ``W`` samples with demix moves,
    the chain graphed or eager, ``linalg.FAST_CHOLESKY`` at ``route``;
    (chain, accepted, launches, captures)."""
    from bask_tpu_torch import BayesGPR
    from bask_tpu_torch.parallel import mcmc

    rng = np.random.RandomState(1)
    X = rng.uniform(size=(n, d))
    y = ((X - 0.4) ** 2).sum(1) + 0.05 * rng.randn(n)
    counters = (gram.fused_masked_gram_batch, gram.fused_masked_gram_lower_batch,
                gram.fused_masked_gram_wb_batch, chol_base.chol_inv_base)
    before = [f.launches for f in counters]
    captures = mcmc.graph_stats["captures"]
    old = (mcmc.CHAIN_GRAPHS, gram.LOWER_GRAM, linalg.FAST_CHOLESKY)
    mcmc.CHAIN_GRAPHS, gram.LOWER_GRAM = ("on" if graphs else "off"), lower
    linalg.FAST_CHOLESKY = route
    try:
        gp = BayesGPR(bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * d, (0.05, 2.0)),
                      random_state=3, device=dev, warp_inputs=warp, optimizer=None,
                      moves="demix")
        gp.fit(X, y, n_desired_samples=steps * W, n_walkers_per_thread=W, n_burnin=0,
               warn_rhat=None, progress=False)
    finally:
        mcmc.CHAIN_GRAPHS, gram.LOWER_GRAM, linalg.FAST_CHOLESKY = old
    torch.cuda.synchronize()
    return (gp.chain_, gp.n_accepted_, [f.launches - b for f, b in zip(counters, before)],
            mcmc.graph_stats["captures"] - captures)


@pytest.mark.parametrize("warp,n,d,lower", [
    (False, 500, 15, "off"),  # K4 + K3
    (True, 500, 15, "on"),  # K2 + K3 on warped X
    (True, 120, 4, "off"),  # K1 + K3
    (False, 40, 3, "off"),  # bucket 64: K1 + cholesky_ex
])
def test_graphed_chain_is_the_eager_chain(dev, warp, n, d, lower):
    """The replayed chain equals the eager chain bit for bit, with the
    same acceptances and the same kernel launches counted (replays times
    launches per capture); a second run of the configuration captures
    nothing new."""
    eager = _chain_model(dev, warp, n, d, 20, graphs=False, lower=lower)
    graphed = _chain_model(dev, warp, n, d, 20, graphs=True, lower=lower)
    assert np.array_equal(graphed[0], eager[0])
    assert graphed[1] == eager[1] and graphed[2] == eager[2]
    assert eager[3] == 0
    again = _chain_model(dev, warp, n, d, 20, graphs=True, lower=lower)
    assert np.array_equal(again[0], eager[0]) and again[3] == 0


def test_no_capture_after_warmup(dev):
    """After ``warmup_optimizer`` the first tell and three warm tells of
    the real loop capture no chain graph (tests/test_warmup.py's case),
    and the warm tells' medians capture none either: they replay."""
    from bask_tpu_torch import Optimizer, warmup_optimizer
    from bask_tpu_torch.parallel import mcmc

    opt = Optimizer(dimensions=[(0.0, 1.0)] * 3, n_points=64, n_initial_points=2,
                    init_strategy="random", acq_func="ei", random_state=1, device=dev,
                    gp_sample_kwargs={"n_walkers_per_thread": 16})
    assert warmup_optimizer(opt, (2, 3, 4, 5, 6), gp_samples=20, gp_burnin=2,
                            n_samples=3) == [64]
    captures = mcmc.graph_stats["captures"]
    rng = np.random.RandomState(0)
    median_spans = []  # (captures, replays) of each warm tell's median
    trace.reset()
    trace.enable()
    try:
        for _ in range(5):
            warm = opt.gp.pos_ is not None
            trace.reset()
            x = opt.ask()
            opt.tell(x, float(np.sin(3 * x[0]) + 0.05 * rng.randn()), n_samples=3,
                     gp_samples=20, gp_burnin=2)
            spans = trace.snapshot()["spans"]
            if warm:
                median_spans.append(tuple(spans.get(n, {"count": 0})["count"] for n in (
                    "span.gp.median_capture", "span.gp.median_replay")))
    finally:
        trace.disable()
        trace.reset()
    assert opt.gp.chain_ is not None
    assert mcmc.graph_stats["captures"] == captures
    # the warm tells' medians replay the graph the warm-up captured
    assert median_spans and all(c == 0 and r >= 1 for c, r in median_spans)


@pytest.mark.parametrize("warp,n,d", [(False, 500, 15), (True, 120, 4)])
def test_graphed_off_chain_is_the_eager_off_chain(dev, warp, n, d):
    """``linalg.FAST_CHOLESKY = "off"`` (cuSOLVER's ``cholesky_ex`` and
    cuBLAS's triangular solve) captures: the replayed chain equals the
    eager one bit for bit, with the same launches (the gram kernel's; K3
    none)."""
    eager = _chain_model(dev, warp, n, d, 20, graphs=False, route="off")
    graphed = _chain_model(dev, warp, n, d, 20, graphs=True, route="off")
    assert np.array_equal(graphed[0], eager[0])
    assert graphed[1] == eager[1] and graphed[2] == eager[2]
    assert graphed[2][3] == 0 and sum(graphed[2][:3]) > 0  # no K3; K1 or K4


def test_flipping_the_route_captures_a_second_graph(dev):
    """Two sample calls of one configuration at "auto", then at "off": the
    first "off" run captures its two moves anew (the graph cache keys on the
    switch), the second captures nothing, and "auto" replays K3."""
    auto = _chain_model(dev, False, 300, 5, 16, graphs=True, route="auto")
    again = _chain_model(dev, False, 300, 5, 16, graphs=True, route="auto")
    off = _chain_model(dev, False, 300, 5, 16, graphs=True, route="off")
    off2 = _chain_model(dev, False, 300, 5, 16, graphs=True, route="off")
    assert again[3] == 0 and off[3] == 2 and off2[3] == 0
    assert auto[2][3] > 0 and off[2][3] == 0
    assert np.array_equal(off[0], off2[0])


def test_on_at_float64_on_the_card(dev):
    """"on" at float64: the blocked route with K3's plain version as the
    bases (K3 takes float32 only, and is not launched), no TypeError, and "off"'s
    LML and predictions to the JAX tests' float64 tolerance (rtol 1e-8)."""
    from bask_tpu_torch import convert
    from bask_tpu_torch.models import gp as tgp

    rng = np.random.RandomState(3)
    n, n_pad, d = 450, 512, 15
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    data = convert.gp_data(X, y, np.full(n_pad, 1e-6), np.arange(n_pad) < n, device=dev,
                           dtype=torch.float64)
    thetas = torch.tensor(KERNEL.theta0[None] + 0.3 * rng.randn(4, KERNEL.n_theta),
                          dtype=torch.float64, device=dev)
    Xq = torch.tensor(rng.uniform(size=(64, d)), dtype=torch.float64, device=dev)
    out, k3 = {}, chol_base.chol_inv_base.launches
    old = linalg.FAST_CHOLESKY
    try:
        for route in ("off", "on"):
            linalg.FAST_CHOLESKY = route
            lml = linalg.masked_lml(KERNEL, thetas, data.X, data.y, data.alpha_diag, data.mask)
            post, invs = tgp.posterior_and_invs(KERNEL, thetas[0], data)
            assert (invs is None) == (route == "off")
            out[route] = (lml, *tgp.predict(KERNEL, thetas[0], post, data, Xq,
                                            return_std=True, invs=invs))
    finally:
        linalg.FAST_CHOLESKY = old
    assert chol_base.chol_inv_base.launches == k3
    assert torch.isfinite(out["on"][0]).all()
    for a, b in zip(out["on"], out["off"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-8, atol=1e-12)


# K5 (the pathwise draws' values, csrc/pathwise.cu). A draw's float32 error
# budget is chip_smoke.py's DRAW_REL_TOL: 3e-4 of its scale against float64,
# for the gram, the factorization, the solves and K5 together. K5 alone
# gets a third of it: against its plain version run in float64 on the same
# float32 inputs (so K5's rounding is the only difference), within
# K5_REL_TOL of the largest |value|.
DRAW_REL_TOL = 3e-4
K5_REL_TOL = DRAW_REL_TOL / 3


def _k5_inputs(dev, nu, B=4, m=1000, n_pad=512, d=15, R=1, per_row=False, n=500, M=1024,
               seed=0, ls=(0.2, 0.6)):
    """Seeded inputs of one K5 call: (Xq, omega, phase, W, coef, X, inv_ls,
    V, amp) float32 on the card, as ``models.pathwise._draw_values`` forms
    them (omega from the spectral measure of nu at lengthscales drawn from
    ``ls``; V zero on padded rows)."""
    rng = np.random.RandomState(seed)
    inv_ls = 1.0 / rng.uniform(*ls, (B, d))
    scale = 1.0 if math.isinf(nu) else np.sqrt(2 * nu / (2.0 * rng.gamma(nu, size=(B, M, 1))))
    omega = rng.randn(B, M, d) * scale * inv_ls[:, None, :]
    amp = rng.uniform(0.5, 2.0, B)
    X = np.full((B, n_pad, d) if per_row else (n_pad, d), 0.5)
    X[..., :n, :] = rng.uniform(size=X[..., :n, :].shape)
    V = rng.randn(B, n_pad, R)
    V[:, n:] = 0.0
    arrays = (rng.uniform(size=(B, m, d) if per_row else (m, d)), omega,
              rng.uniform(0, 2 * math.pi, (B, M)), rng.randn(B, M, R), np.sqrt(2 * amp / M),
              X, inv_ls, V, amp)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def _check_k5(nu, args):
    from bask_tpu_torch.ops import pathwise_values as pv

    before = pv.pathwise_values.launches
    out = pv.pathwise_values(nu, *args)
    torch.cuda.synchronize()
    R = args[3].shape[-1]
    assert pv.pathwise_values.launches == before + -(-R // 8)
    ref = pv.pathwise_values_plain(nu, *(a.double() for a in args))
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err = float((out.double() - ref).abs().max())
    assert err <= K5_REL_TOL * float(ref.abs().max()), (err, float(ref.abs().max()))
    return out


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
@pytest.mark.parametrize("R", [1, 3, 8])
def test_pathwise_values_kernel_matches_plain(dev, nu, R):
    """Every nu and R at m = 1,000 (not a multiple of the 128-query tile),
    shared queries, n_pad 512, d 15; and the f0 form (no cross term)."""
    args = _k5_inputs(dev, nu, R=R)
    _check_k5(nu, args)
    _check_k5(nu, args[:5])


@pytest.mark.parametrize("n_pad,d,per_row", [(512, 15, True), (1024, 15, False),
                                             (1024, 15, True), (512, 40, False),
                                             (1024, 40, True)])
def test_pathwise_values_kernel_at_each_width(dev, n_pad, d, per_row):
    """n_pad 512 and 1,024, d 15 (the query in registers) and 40 (in
    shared memory), shared and per-row queries and training points."""
    args = _k5_inputs(dev, 2.5, n_pad=n_pad, d=d, per_row=per_row, m=777, R=3, seed=1)
    _check_k5(2.5, args)
    _check_k5(0.5, args)


def test_pathwise_values_kernel_groups_columns_past_8(dev):
    """R = 11: two launches (8 + 3 columns), the plain version's values."""
    _check_k5(1.5, _k5_inputs(dev, 1.5, R=11, seed=2))


def test_pathwise_values_kernel_nan_row_and_determinism(dev):
    """A NaN row (what a NaN chain row gives: NaN amp, 1/ls and
    frequencies; or a non-PD factor: NaN V) gives NaN values in that row
    only and does not raise; two launches are bit-equal."""
    from bask_tpu_torch.ops import pathwise_values as pv

    args = _k5_inputs(dev, 2.5, seed=3)
    first = pv.pathwise_values(2.5, *args)
    assert torch.equal(first, pv.pathwise_values(2.5, *args))
    for idx in ((1, 4, 6, 8), (7,)):
        bad = [a.clone() for a in args]
        for i in idx:
            bad[i][1] = float("nan")
        out = pv.pathwise_values(2.5, *bad)
        torch.cuda.synchronize()
        assert torch.isnan(out[1]).all()
        assert torch.equal(out[[0, 2, 3]], first[[0, 2, 3]])


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("d", [15, 17, 40])
def test_pathwise_values_kernel_nan_or_huge_query(dev, d, per_row):
    """A NaN coordinate in query 10 (inside the first block, of any
    kernel) gives NaN at that query only, in every row when the queries
    are shared, and leaves every other value bit-equal, with and without
    the cross term; a huge finite query there leaves every value within
    K5_REL_TOL of the float64 plain version."""
    from bask_tpu_torch.ops import pathwise_values as pv

    args = _k5_inputs(dev, 2.5, B=3, m=777, n_pad=256, n=200, M=320, d=d, per_row=per_row,
                      seed=7)
    at = (1, 10) if per_row else (10,)  # the query in Xq; its values in every row if shared
    for a in (args, args[:5]):
        first = pv.pathwise_values(2.5, *a)
        bad = [a[0].clone(), *a[1:]]
        bad[0][at + (3,)] = float("nan")
        out = pv.pathwise_values(2.5, *bad)
        torch.cuda.synchronize()
        hit = torch.zeros(out.shape[:2], dtype=torch.bool, device=dev)
        hit[at if per_row else (slice(None), 10)] = True
        assert torch.isnan(out[hit]).all()
        assert torch.equal(out[~hit], first[~hit])
        bad[0] = a[0].clone()
        bad[0][at + (0,)] = 1e4
        _check_k5(2.5, bad)


def test_pathwise_values_kernel_refuses(dev):
    from bask_tpu_torch.ops import pathwise_values as pv

    args = _k5_inputs(dev, 2.5)
    with pytest.raises(TypeError):
        pv.pathwise_values(2.5, *(a.double() for a in args))
    with pytest.raises(ValueError):
        pv.pathwise_values(1.7, *args)
    with pytest.raises(ValueError):  # V without its training points' count
        pv.pathwise_values(2.5, *args[:7], args[7][:, :100], args[8])
    with pytest.raises(ValueError):
        pv.pathwise_values(2.5, args[0], *args[1:5], args[5], args[6], args[7], None)
    wide = _k5_inputs(dev, 2.5, d=257, m=10, n_pad=16, n=8, M=8, B=1)
    with pytest.raises(ValueError):
        pv.pathwise_values(2.5, *wide)


# d: 1 and 15 pad to 16 (the tensor-core kernel, 256 queries a block), 16
# and 17 to 32 (128 a block), 32 and 40 take PR 10's FP32 kernel
K5_WIDTHS = [1, 15, 16, 17, 32, 40]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("d", K5_WIDTHS)
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_pathwise_values_kernel_every_width(dev, nu, d, per_row):
    """Each nu at each width, shared and per-row queries and points, R 1,
    3 or 8 (by d), with and without the cross term, m = 777 (a ragged last
    block of both kernels): within K5_REL_TOL of the float64 plain version
    and bit-equal across two launches; at nu = 1/2 with lengthscales of
    0.05 the Cauchy-tailed features take the float64 argument."""
    from bask_tpu_torch.ops import pathwise_values as pv

    R = (1, 3, 8)[K5_WIDTHS.index(d) % 3]
    args = _k5_inputs(dev, nu, B=3, m=777, n_pad=256, n=200, M=320, d=d, R=R, per_row=per_row,
                      seed=5, ls=(0.05, 0.05) if nu == 0.5 else (0.2, 0.6))
    for a in (args, args[:5]):
        first = _check_k5(nu, a)
        assert torch.equal(first, pv.pathwise_values(nu, *a))
    plan = pv._plan(d, R, nu)
    assert plan["kernel"] == ("pathwise_mma_kernel" if d <= 31 else "pathwise_values_kernel")
    assert plan["blocks_per_sm"] >= 1


# the device operations of one K5 call at the batch ask's d, profiled in a
# process of its own: a torch.profiler session after earlier ones in a
# process can record nothing on the card (PERF.md section 7)
_PROFILE_ONE_K5 = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as t
from bask_tpu_torch.ops import pathwise_values as pv
args = t._k5_inputs(torch.device("cuda", 0), 2.5, m=4096)
pv.pathwise_values(2.5, *args)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    pv.pathwise_values(2.5, *args)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_pathwise_values_tensor_core_plan(dev):
    """The batch ask's launch (d 15, R 1) takes the tensor-core kernel,
    256 queries a block, at least two blocks resident per SM; R 8 as well;
    one device operation a call, the kernel the plan names."""
    import json
    import os
    import subprocess
    import sys

    from bask_tpu_torch.ops import pathwise_values as pv

    for R in (1, 8):
        plan = pv._plan(15, R, 2.5)
        assert plan["kernel"] == "pathwise_mma_kernel" and plan["queries_per_block"] == 256
        assert plan["blocks_per_sm"] >= 2, plan
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", _PROFILE_ONE_K5, here], capture_output=True,
                          text=True, cwd=os.path.dirname(here), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "pathwise_mma_kernel" in names[0], names


def test_pathwise_topk_hyper_launches_k5_without_slabs(dev):
    """The batch ask's draws at m = 65,536: two K5 launches (one chunk of
    4 draws), and the call's peak memory above what it starts with (the
    gram and its factorization ~85 MB) stays below one draw's (m, n_pad)
    float32 slab (268 MB), where the op-by-op draws held (4, m, 1,024)
    slabs."""
    from bask_tpu_torch.models import gp as gpc
    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import pathwise_values as pv

    rng = np.random.RandomState(9)
    n, n_pad, d, S, m = 1000, 1024, 15, 4, 65536
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    rows = KERNEL.theta0[None] + 0.1 * rng.randn(S, KERNEL.n_theta)
    rows[:, -1] = np.log(1e-2)
    t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (X, y, np.full(n_pad, 1e-6))]
    data = gpc.make_data(*t, np.arange(n_pad) < n)
    spec = gram.match_fusable(KERNEL)
    gen = torch.Generator(device=dev).manual_seed(2)
    rand = pathwise.draw_pathwise_randoms(gen, spec.nu, 1024, d, n_pad, 1, batch=(S,), device=dev)
    Xq = torch.tensor(rng.uniform(size=(m, d)), dtype=torch.float32, device=dev)
    rows = torch.tensor(rows, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = pv.pathwise_values.launches
    idx = pathwise.pathwise_topk_hyper(spec, rows, data, Xq, rand, 0, 8, n_real=n)
    torch.cuda.synchronize()
    assert pv.pathwise_values.launches == before + 2
    assert torch.cuda.max_memory_allocated(dev) - base < 4 * m * n_pad
    assert idx.shape == (S, 8) and bool((idx >= 0).all() and (idx < m).all())


# -- K6 and K7, the input warp and its inverse (csrc/warp.cu) --------------

# K6 and K7 against their plain versions in float64 on the same inputs:
# the largest |difference| of the warp (values in [0, 1]) and the relative
# difference of the pdf; the unwarp's x within UNWARP_TOL of the float64
# root, or its float64 CDF within WARP_TOL of z; chip_smoke.py phase 15's
# limits, set from readings on an H100 (PERF.md)
WARP_TOL = {torch.float32: 3e-6, torch.float64: 5e-15}
PDF_RTOL = {torch.float32: 5e-5, torch.float64: 1e-13}
UNWARP_TOL = {torch.float32: 1e-6, torch.float64: 2e-15}


def _warp_inputs(dev, dtype, shape, rows, seed=0):
    """X (or Z) of ``shape`` uniform in [0, 1] with its first entries at
    0, 1e-12, 1 - 1e-12 and 1 and two past the ends (clamped), and
    log-parameters of ``rows`` rows (``()``: one (d,) pair per column)
    uniform over the warp prior's 5-sigma range [-1.5, 1.5]."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=shape)
    flat = X.reshape(-1)
    flat[:6] = [0.0, 1e-12, 1.0 - 1e-12, 1.0, -0.25, 1.25]
    la, lb = (rng.uniform(-1.5, 1.5, rows + (shape[-1],)) for _ in range(2))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in (X, la, lb)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,rows", [((512, 15), (50,)), ((8, 1000, 15), (8,)),
                                        ((3, 77, 300), (3,)), ((33, 1), ())])
def test_warp_kernel_matches_float64_plain(dev, dtype, shape, rows):
    """K6 (and warping.warp, which routes a CUDA tensor to it) against the
    float64 plain version on the same inputs: the chain's shared X under
    50 walkers, per-row X at a ragged n, d past 256 (two column groups),
    one column; the pdf beside it; one launch per call."""
    from bask_tpu_torch.models import warping as twp
    from bask_tpu_torch.ops import warp_values as wv

    X, la, lb = _warp_inputs(dev, dtype, shape, rows)
    before = wv.warp_values.launches
    out, pdf = wv.warp_values(X, la, lb, with_pdf=True)
    routed = twp.warp(X, la, lb)
    torch.cuda.synchronize()
    assert wv.warp_values.launches == before + 2
    assert out.dtype == dtype and torch.equal(out, routed)
    X64, la64, lb64 = (t.double() for t in (X, la, lb))
    ref = wv.warp_plain(X64, la64, lb64)
    assert out.shape == ref.shape
    err = float((out.double() - ref).abs().max())
    assert err <= WARP_TOL[dtype], err
    pdf_ref = wv.beta_pdf_plain(X64, la64, lb64)
    finite = torch.isfinite(pdf_ref) & (pdf_ref > 1e-30)
    rel = float(((pdf.double() - pdf_ref) / pdf_ref)[finite].abs().max())
    assert rel <= PDF_RTOL[dtype], rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,rows,case", [((500, 15), (), "full"), ((3, 77, 5), (3,), "past"),
                                             ((64, 4), (), "steep")])
def test_unwarp_kernel_matches_float64_plain(dev, dtype, shape, rows, case):
    """K7 (and warping.unwarp) against the float64 plain version on the
    same inputs, shared and per-row: at the type's full depth, 70 steps
    (past it: the same x), and a steep warp (a and b down to 0.03, where
    the CDF maps z up to 0.3 below 2^-60), where z must also lie in the
    float64 CDF's image of x's cell in its type; one launch."""
    from bask_tpu_torch.models import warping as twp
    from bask_tpu_torch.ops import warp_values as wv

    Z, la, lb = _warp_inputs(dev, dtype, shape, rows, seed=1)
    if case == "steep":
        la = torch.log(torch.tensor([0.03, 1.0, 0.05, 25.0], dtype=dtype, device=dev))
        lb = la.flip(0)
    before = wv.unwarp_values.launches
    out = twp.unwarp(Z, la, lb, n_iter=60)
    torch.cuda.synchronize()
    assert wv.unwarp_values.launches == before + 1 and out.dtype == dtype
    if case == "past":
        assert torch.equal(wv.unwarp_values(Z, la, lb, 70), out)
    ref = wv.unwarp_plain(Z.double(), la.double(), lb.double())
    diff = (out.double() - ref).abs()
    if case == "steep":
        cell = [wv.warp_plain(torch.nextafter(out, torch.full_like(out, e)).double(),
                              la.double(), lb.double()) for e in (0.0, 1.0)]
        z = Z.double().clamp(0.0, 1.0)
        assert bool((cell[0] - WARP_TOL[dtype] <= z).all() & (z <= cell[1] + WARP_TOL[dtype]).all())
    resid = (wv.warp_plain(out.double(), la.double(), lb.double())
             - Z.double().clamp(0.0, 1.0)).abs()
    share = float(torch.minimum(diff / UNWARP_TOL[dtype], resid / WARP_TOL[dtype]).max())
    assert share <= 1.0, (share, float(diff.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warp_gradient_on_the_card(dev, dtype):
    """The card's x-gradient (the Function around K6 with its pdf): the
    incoming gradient times the float64 plain pdf, summed over walkers, 0
    where the clamp cut X; a gradient in the log-parameters raises."""
    from bask_tpu_torch.models import warping as twp
    from bask_tpu_torch.ops import warp_values as wv

    X, la, lb = _warp_inputs(dev, dtype, (200, 6), (10,), seed=2)
    G = torch.rand(10, 200, 6, dtype=dtype, device=dev)
    Xg = X.clone().requires_grad_(True)
    before = wv.warp_values.launches
    (g,) = torch.autograd.grad((twp.warp(Xg, la, lb) * G).sum(), Xg)
    assert wv.warp_values.launches == before + 1
    pdf = wv.beta_pdf_plain(X.double(), la.double(), lb.double())
    inside = (X >= 0) & (X <= 1)
    ref = torch.where(inside, (G.double() * pdf).sum(0), 0.0)
    ok = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(g), ok)
    rel = float(((g.double() - ref) / ref.abs().clamp(min=1e-30))[ok & (ref != 0)].abs().max())
    assert rel <= PDF_RTOL[dtype], rel
    assert float(g[0, 4]) == 0.0 and float(g[0, 5]) == 0.0  # -0.25 and 1.25, clamped
    with pytest.raises(RuntimeError, match="no derivative in log_alphas"):
        twp.warp(Xg, la.clone().requires_grad_(True), lb)


def test_warp_kernels_in_a_cuda_graph(dev):
    """K6 and K7 captured in a CUDA graph (on the capture's stream, torch
    allocations only) and replayed on refilled inputs: bit-equal to the
    eager launches."""
    from bask_tpu_torch.models import warping as twp

    X, la, lb = _warp_inputs(dev, torch.float32, (512, 15), (50,), seed=3)
    Z = X.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        twp.warp(X, la, lb), twp.unwarp(Z, la[0], lb[0])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w, u = twp.warp(X, la, lb), twp.unwarp(Z, la[0], lb[0])
    X2, la2, lb2 = _warp_inputs(dev, torch.float32, (512, 15), (50,), seed=4)
    for t, new in ((X, X2), (Z, X2), (la, la2), (lb, lb2)):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(w, twp.warp(X2, la2, lb2))
    assert torch.equal(u, twp.unwarp(X2, la2[0], lb2[0]))


def _median_counts():
    spans = trace.snapshot()["spans"]
    return tuple(spans.get(n, {"count": 0})["count"]
                 for n in ("span.gp.median_capture", "span.gp.median_replay"))


@pytest.fixture
def median_cache(monkeypatch):
    """An empty cache of the median's graphs; tracing on."""
    from bask_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "MEDIAN", graphs.Cache(first_call=False))
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.parametrize("shape", [(100, 17), (100, 47), (15000, 17)])
@pytest.mark.parametrize("max_iter", [26, 200])
def test_graphed_median_is_the_eager_loop_bit_for_bit(dev, median_cache, shape, max_iter):
    """One key's calls (eager, capture and replays, replays) on kept steps
    read in place from a chain (offset views) and on a fresh tensor whose
    steps never fall below eps (every block replayed at max_iter 200): each
    the eager loop's median bit for bit."""
    n, D = shape
    rng = np.random.RandomState(n + D)
    chain = torch.tensor(0.3 * rng.randn(11, n, D) + rng.randn(D), dtype=torch.float32,
                         device=dev)
    inputs = [chain[10], chain[4], chain[7] + 1e3, chain[10], chain[1]]
    for X in inputs:
        want = median._eager(X, 1e-5, max_iter)
        got = median.geometric_median(X, max_iter=max_iter)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert _median_counts()[0] == 1
    assert _median_counts()[1] >= len(inputs) - 1


def test_median_captures_on_a_keys_second_call(dev, median_cache):
    """A key's first call captures nothing and replays nothing, its second
    captures once, later calls only replay; another shape starts over."""
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.randn(100, 17), dtype=torch.float32, device=dev)
    counts = []
    for _ in range(4):
        trace.reset()
        median.geometric_median(X)
        counts.append(_median_counts())
    assert counts == [(0, 0), (1, 1), (0, 1), (0, 1)]  # converged at the first check
    trace.reset()
    median.geometric_median(X[:50])
    assert _median_counts() == (0, 0)


def test_a_matmul_precision_change_captures_anew(dev, median_cache):
    """A graph keeps the matmul math mode of its capture: after
    ``set_float32_matmul_precision("high")`` the key is seen anew (eager),
    its next call captures again, and the replay is the eager loop's median
    under the new setting bit for bit."""
    rng = np.random.RandomState(1)
    X = torch.tensor(rng.randn(100, 17), dtype=torch.float32, device=dev)
    for _ in range(2):
        median.geometric_median(X)
    assert _median_counts()[0] == 1
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        trace.reset()
        median.geometric_median(X)
        assert _median_counts() == (0, 0)
        got = median.geometric_median(X)
        assert _median_counts()[0] == 1
        want = median._eager(X, 1e-5, 200)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    finally:
        torch.set_float32_matmul_precision(before)
