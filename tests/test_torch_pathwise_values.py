"""K5's plain version (``bask_tpu_torch.ops.pathwise_values``) against the
JAX package, and the pathwise draws around it, on the CPU.

The function K5 computes is the part of ``bask_tpu.models.pathwise.
pathwise_samples`` after the solve: ``features(Xq) @ w`` plus
``(_cross_kernel(Xq, X) * mask) @ v``. The JAX side here is that code at
x64 (``_cross_kernel`` itself; the features as its ``features`` closure
writes them), per row; the port's side is
``pathwise_values_plain`` on the same numpy inputs, through the public
wrapper on CPU tensors (which never launches the kernel). Tolerance: 1e-10
of the largest |value|, float64 rounding of sums of ~100 terms with room
to spare.

Also: ``_draw_values`` gives what the op-by-op code before K5 gave (a
copy of it is kept here as the reference), no tensor of (.., m, M) or
(.., m, n_pad) elements is made around K5, and the unwarped
``pathwise_topk_hyper`` gives the same indices in one chunk as in chunks
of one draw.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import pathwise as jpw  # noqa: E402
from bask_tpu.ops.pallas_gram import FusedSpec as JaxSpec  # noqa: E402
from bask_tpu_torch.models import gp as gpc  # noqa: E402
from bask_tpu_torch.models import pathwise as tpw  # noqa: E402
from bask_tpu_torch.ops import pathwise_values as pv  # noqa: E402
from bask_tpu_torch.ops.gram import FusedSpec  # noqa: E402
from bask_tpu_torch.ops.kernels import matern_from_d2  # noqa: E402

REL_TOL = 1e-10  # of max |value|, float64
NUS = [0.5, 1.5, 2.5, math.inf]
B, M, N_PAD, N_REAL = 3, 40, 24, 20


def _inputs(seed, nu, has_const, iso, R, per_row, d=3, m=50):
    """Seeded numpy inputs of one call: the fused-layout thetas and what
    the port's call takes (omega from z and chi-square u as the spectral
    measure of nu gives it)."""
    rng = np.random.RandomState(seed)
    n_ls = 1 if iso else d
    theta = np.concatenate([
        np.log(rng.uniform(0.5, 2.0, (B, 1))) if has_const else np.zeros((B, 0)),
        np.log(rng.uniform(0.2, 0.8, (B, n_ls))),
    ], axis=1)
    amp = np.exp(theta[:, 0]) if has_const else np.ones(B)
    inv_ls = np.broadcast_to(np.exp(-theta[:, int(has_const):]), (B, d)).copy()
    z = rng.randn(B, M, d)
    scale = 1.0 if math.isinf(nu) else np.sqrt(2 * nu / (2.0 * rng.gamma(nu, size=(B, M, 1))))
    X = rng.uniform(size=(B, N_PAD, d) if per_row else (N_PAD, d))
    return {
        "theta": theta,
        "Xq": rng.uniform(size=(B, m, d) if per_row else (m, d)),
        "omega": z * scale * inv_ls[:, None, :],
        "phase": rng.uniform(0, 2 * math.pi, (B, M)),
        "W": rng.randn(B, M, R),
        "coef": np.sqrt(2.0 * amp / M),
        "X": X,
        "inv_ls": inv_ls,
        "v": rng.randn(B, N_PAD, R),
        "mask": np.arange(N_PAD) < N_REAL,
        "amp": amp,
    }


def _jax_values(spec, a, cross):
    """Per row, the JAX package's features(Xq) @ w [+ (k(Xq, X) mask) @ v]."""
    out = []
    for b in range(B):
        Xq = jnp.asarray(a["Xq"][b] if a["Xq"].ndim == 3 else a["Xq"])
        feats = a["coef"][b] * jnp.cos(Xq @ jnp.asarray(a["omega"][b]).T + a["phase"][b][None, :])
        f = feats @ a["W"][b]
        if cross:
            X = jnp.asarray(a["X"][b] if a["X"].ndim == 3 else a["X"])
            Kq = jpw._cross_kernel(spec, jnp.asarray(a["theta"][b]), Xq, X) * a["mask"][None, :]
            f = f + Kq @ a["v"][b]
        out.append(np.asarray(f))
    return np.stack(out)


def _port_values(nu, a, cross, fn=pv.pathwise_values):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    if not cross:
        return fn(nu, t["Xq"], t["omega"], t["phase"], t["W"], t["coef"])
    V = t["v"] * t["mask"][:, None]
    return fn(nu, t["Xq"], t["omega"], t["phase"], t["W"], t["coef"], t["X"], t["inv_ls"],
              V, t["amp"])


# every value of each option at least once with each nu:
# (has_const, isotropic, R, per-row Xq and X, cross term)
CASES = [
    (True, False, 1, False, True),
    (False, True, 3, True, True),
    (True, True, 3, False, False),
    (False, False, 1, True, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "const%d-iso%d-R%d-rows%d-cross%d" % c)
@pytest.mark.parametrize("nu", NUS)
def test_plain_k5_matches_jax(nu, case):
    has_const, iso, R, per_row, cross = case
    a = _inputs(3, nu, has_const, iso, R, per_row)
    spec = JaxSpec(nu=nu, n_ls=1 if iso else 3, has_const=has_const, has_white=False)
    ref = _jax_values(spec, a, cross)
    before = pv.pathwise_values.launches
    got = _port_values(nu, a, cross).numpy()
    assert pv.pathwise_values.launches == before  # CPU tensors: the plain version
    assert got.shape == (B, a["Xq"].shape[-2], R)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


def test_wrapper_is_the_plain_version_on_the_cpu():
    a = _inputs(4, 2.5, True, False, 3, True)
    for cross in (False, True):
        want = _port_values(2.5, a, cross, fn=pv.pathwise_values_plain)
        assert torch.equal(_port_values(2.5, a, cross), want)
    assert pv.pathwise_values.launches == 0


def test_operation_count():
    """The count of the source note: 2d + 4 per (query, feature) pair and
    2d + 8 per (query, point) pair at one column, 2 more a column; 1.22e12
    at the batch ask with its 1,000 real points."""
    assert pv.k5_operations(1, 1, 1, 0, 15) == 34
    assert pv.k5_operations(1, 1, 0, 1, 15) == 38
    assert pv.k5_operations(1, 1, 1, 1, 15, r=3) == 34 + 38 + 8
    assert abs(pv.k5_operations(256, 65536, 1024, 1000, 15) / 1.2224e12 - 1) < 1e-3


def _spec(nu, has_const=True, has_white=True, n_ls=2):
    return FusedSpec(nu=nu, n_ls=n_ls, has_const=has_const, has_white=has_white)


def _data(seed, d=2, dtype=torch.float64):
    rng = np.random.RandomState(seed)
    X = np.full((N_PAD, d), 0.5)
    X[:N_REAL] = rng.uniform(size=(N_REAL, d))
    y = np.zeros(N_PAD)
    y[:N_REAL] = rng.randn(N_REAL)
    t = [torch.tensor(a, dtype=dtype) for a in (X, y, np.full(N_PAD, 1e-4))]
    return gpc.make_data(*t, np.arange(N_PAD) < N_REAL)


def _draw_values_before(spec, theta, X, data, solve, Xq, rand):
    """``models.pathwise._draw_values`` as it was before K5, op by op."""
    n_features = rand.z.shape[-2]
    amp, noise, inv_ls = tpw._unpack(spec, theta, X.shape[-1])
    omega_t = tpw.sample_frequencies(spec, inv_ls, rand.z, rand.u).transpose(-1, -2)
    coef = torch.sqrt(2.0 * amp / n_features)[..., None, None]

    def features(A):
        return coef * torch.cos(A @ omega_t + rand.phase[..., None, :])

    f0_train = features(X) @ rand.w
    eps = torch.sqrt(noise[..., None] + data.alpha_diag)[..., None] * rand.e
    mask = data.mask[:, None]
    resid = torch.where(mask, data.y[:, None] - f0_train - eps, 0.0)
    v = solve(resid)
    off = 1 if spec.has_const else 0
    K = tpw._base_kernel(spec).eval(theta[..., off : off + spec.n_ls], Xq, X)
    if spec.has_const:
        K = torch.exp(theta[..., 0])[..., None, None] * K
    return features(Xq) @ rand.w + (K * data.mask) @ v


def _rows(seed, spec, n):
    rng = np.random.RandomState(seed)
    n_theta = int(spec.has_const) + spec.n_ls + int(spec.has_white)
    rows = np.log(rng.uniform(0.3, 0.9, (n, n_theta)))
    if spec.has_white:
        rows[:, -1] = np.log(1e-2)
    return torch.tensor(rows)


def _factor(spec, rows, X, data):
    K = tpw._fused_spec_gram(spec, rows, X, data)
    return torch.linalg.cholesky(K)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("batched", [False, True])
def test_draw_values_give_what_they_gave_before(nu, batched):
    """The consensus form (one row, S columns) and the per-row form (B
    rows, one column each, per-row warped-like X and Xq); no launch."""
    spec = _spec(nu, has_const=batched)
    data = _data(5)
    gen = torch.Generator().manual_seed(6)
    Xq = torch.rand(70, 2, generator=gen, dtype=torch.float64)
    if batched:
        theta = _rows(7, spec, B)
        X = data.X * torch.linspace(0.8, 1.2, B, dtype=torch.float64)[:, None, None]
        Xq = Xq * torch.linspace(0.9, 1.1, B, dtype=torch.float64)[:, None, None]
        rand = tpw.draw_pathwise_randoms(gen, nu, M, 2, N_PAD, 1, batch=(B,), dtype=torch.float64)
    else:
        theta = _rows(7, spec, 1)[0]
        X = data.X
        rand = tpw.draw_pathwise_randoms(gen, nu, M, 2, N_PAD, 4, dtype=torch.float64)
    L = _factor(spec, theta, X, data)

    def solve(R):
        return torch.cholesky_solve(R, L)

    before = pv.pathwise_values.launches
    got = tpw._draw_values(spec, theta, X, data, solve, Xq, rand)
    assert pv.pathwise_values.launches == before
    want = _draw_values_before(spec, theta, X, data, solve, Xq, rand)
    assert got.shape == want.shape == ((B, 70, 1) if batched else (70, 4))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=REL_TOL * float(want.abs().max()))


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The shape of every tensor an operation makes."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("n_warp", [0, 2])
def test_topk_hyper_makes_no_slab_around_k5(monkeypatch, n_warp):
    """With K5 in place (a stand-in that returns K5's (B, m, R) shape), no
    operation of ``pathwise_topk_hyper`` makes a tensor with both m and M,
    or m and n_pad, among its dims (m = 3,000, M = 40, n_pad = 24 differ
    from every other size here); K5 is called twice per chunk."""
    spec = _spec(2.5)
    data = _data(8)
    S, m = 4, 3000
    rows = torch.cat([_rows(9, spec, S), torch.zeros(S, 2 * n_warp, dtype=torch.float64)], 1)
    gen = torch.Generator().manual_seed(10)
    rand = tpw.draw_pathwise_randoms(gen, spec.nu, M, 2, N_PAD, 1, batch=(S,), dtype=torch.float64)
    Xq = torch.rand(m, 2, generator=gen, dtype=torch.float64)
    calls = []

    def k5(nu, Xq, omega, phase, W, coef, X=None, inv_ls=None, V=None, amp=None):
        calls.append(X is not None)
        return torch.zeros(omega.shape[0], Xq.shape[-2], W.shape[-1], dtype=Xq.dtype)

    monkeypatch.setattr(tpw, "_values_for", lambda Xq: k5)
    with _Recorder() as rec:
        idx = tpw.pathwise_topk_hyper(spec, rows, data, Xq, rand, n_warp, 5, n_real=N_REAL)
    assert idx.shape == (S, 5)
    assert calls == [False, True]  # one chunk: f0 at the training points, then the draws
    assert tpw.draws_per_chunk(S, m, 2, n_warp, 8) == S
    slabs = [s for s in rec.shapes if m in s and (M in s or N_PAD in s)]
    assert any(m in s for s in rec.shapes)  # the recorder saw the queries' tensors
    assert not slabs, slabs


def test_unwarped_topk_hyper_one_chunk_equals_chunks_of_one(monkeypatch):
    spec = _spec(1.5)
    data = _data(11)
    S = 5
    rows = _rows(12, spec, S)
    gen = torch.Generator().manual_seed(13)
    rand = tpw.draw_pathwise_randoms(gen, spec.nu, M, 2, N_PAD, 1, batch=(S,), dtype=torch.float64)
    Xq = torch.rand(400, 2, generator=gen, dtype=torch.float64)
    args = (spec, rows, data, Xq, rand, 0, 6)
    assert tpw.draws_per_chunk(S, 400, 2, 0, 8) == S
    whole = tpw.pathwise_topk_hyper(*args, keep=range(S))
    monkeypatch.setattr(tpw, "CHUNK_BYTES", 1)
    assert tpw.draws_per_chunk(S, 400, 2, 0, 8) == 1
    chunked = tpw.pathwise_topk_hyper(*args, keep=range(S))
    np.testing.assert_array_equal(chunked[0].numpy(), whole[0].numpy())
    np.testing.assert_allclose(chunked[1].numpy(), whole[1].numpy(), rtol=0, atol=1e-12)


def test_draws_per_chunk_at_the_batch_ask():
    """At m = 65,536 in float32 (d = 15): one chunk of 256 draws unwarped,
    two K5 launches per ask; 5 draws a chunk warped, where the warp's
    (48, m, d) coefficients per draw set the size."""
    assert tpw.draws_per_chunk(256, 65536, 15, 0, 4) == 256
    assert tpw.draws_per_chunk(8192, 65536, 15, 0, 4) == 4096
    assert tpw.draws_per_chunk(256, 65536, 15, 15, 4) == 5


# -- the tensor-core kernel's arithmetic, emulated ------------------------

# chip_smoke.K5_REL_TOL: K5 against its plain version in float64 on the
# same float32 inputs, of the largest |value|
K5_REL_TOL = 1e-4
_WIDE_REV = 256.0 / (2 * math.pi)  # csrc/pathwise.cu: kWideArg in revolutions
_MUFU_COS_ERR = 2.0 ** -20.5  # cos.approx.f32's absolute error (PTX ISA), modelled
_NEAR_SHARE = 1.0 / 64.0  # csrc/pathwise.cu: kNearShare


def _f32(x):
    return x.float().double()


def _tf32(x):
    """float32 -> TF32 by round to nearest, ties away, on the bits
    (``split_tf32``'s hi)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_dropped(x):
    """What the tensor cores read of a float32 given as TF32 (``lo``):
    the low 13 mantissa bits dropped."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mma(C, A, Bt, passes):
    """C + A Bt^T as the kernel's ``mma.sync.m16n8k8`` steps accumulate it
    from float32 operands: per k-step of 8, lo.hi, hi.lo, hi.hi (3xTF32;
    ``passes`` 1: hi.hi alone), each product exact and each step's sum
    rounded once to float32."""
    ah, bh = _tf32(A), _tf32(Bt)
    al, bl = _tf32_dropped(A - ah), _tf32_dropped(Bt - bh)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    for k0 in range(0, A.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for a, b in terms:
            C = _f32(C + a[..., ks].double() @ b[..., ks].double().transpose(-1, -2))
    return C


def _quad_sums(part, vals, wv):
    """Continue the four partial sums (4, B, m, R) of a row's quad by the
    columns of ``vals`` (B, m, N) weighted by ``wv`` (B, N, R): thread t
    takes columns 8n + 2t, then 8n + 2t + 1, of each n-tile, one float32
    FMA each."""
    quad = torch.arange(4)
    for j0 in range(0, vals.shape[-1], 8):
        for q in (0, 1):
            cols = j0 + 2 * quad + q  # (4,)
            v = vals[:, :, cols].permute(2, 0, 1)[..., None]  # (4, B, m, 1)
            w = wv[:, cols].permute(1, 0, 2)[:, :, None, :]  # (4, B, 1, R)
            part = _f32(part + v * w)
    return part


def _emulated_k5(nu, Xq, omega, phase, W, coef, X, inv_ls, V, amp, passes=3,
                 wide_rev=_WIDE_REV, near_share=_NEAR_SHARE, seed=0):
    """The values as ``pathwise_mma_kernel`` forms them from float32 inputs
    (d <= 31), float64 tensors holding float32 values, and the share of
    (block, feature) pairs on the float64 path. The centre c is 1/2 in
    every dimension; the features' argument in revolutions, ph' =
    frac((ph + <c, om>) / 2 pi) in float64 rounded to float32, plus
    <q - c, om / 2 pi> through
    :func:`_mma`; cos(2 pi (u - rint u)) with cos.approx's error modelled
    as a seeded +-2^-20.5; a feature whose |q - c|max sum|om / 2 pi| passes
    256 / (2 pi) in a block of 256 queries (128 at d > 15) takes the
    float64 argument reduced by 2 pi, then the cosine; the distance from
    :func:`_mma` with C = |q~|^2 (an FMA chain), A = [q~, 1], B = [-2 x~,
    |x~|^2] (|x~|^2 from four partial chains of the quad), formed again
    from differences (an FMA chain) where it is below ``near_share`` of
    |q~|^2 plus the largest |x~|^2 of the point's n-tile, clamped at 0;
    the Matern in float64 of the float32 d2 (its float32 rounding is the
    grams' and is not what this emulates); coef W and amp V scaled in, one
    float32 FMA an element into the quad's partials, then (p0 + p1) +
    (p2 + p3)."""
    B, M, d = omega.shape
    kd = 16 if d < 16 else 32
    block = 256 if kd == 16 else 128
    gen = torch.Generator().manual_seed(seed)
    Xq = Xq.expand(B, *Xq.shape[-2:]) if Xq.ndim == 2 else Xq
    m = Xq.shape[1]

    def pad(t, fill=None):
        out = torch.nn.functional.pad(t.double(), (0, kd - d))
        if fill is not None:
            out[..., d] = fill
        return out

    c = torch.full((B, d), 0.5, dtype=torch.float64)
    qc = _f32(Xq.double() - c[:, None])
    om_rev = _f32(omega.double() * float(np.float32(1 / (2 * math.pi))))
    turns = (phase.double() + (c[:, None, :] * omega.double()).sum(-1)) / (2 * math.pi)
    ph_rev = _f32(turns - torch.round(turns))
    u = _mma(ph_rev[:, None, :].expand(B, m, M), pad(qc, 1.0).float(), pad(om_rev).float(),
             passes)
    f = u - torch.round(u)
    noise = (2 * torch.rand(B, m, M, generator=gen, dtype=torch.float64) - 1) * _MUFU_COS_ERR
    cs = torch.cos(_f32(2 * math.pi * f)) + noise
    S = om_rev.abs().sum(-1)  # (B, M)
    wide_pairs = 0
    for i0 in range(0, m, block):
        rows = slice(i0, i0 + block)
        qmax = qc[:, rows].abs().amax((1, 2))
        wide = _f32(qmax[:, None] * S) > wide_rev  # (B, M)
        wide_pairs += int(wide.sum())
        arg = phase.double()[:, None, :] + Xq[:, rows].double() @ omega.double().transpose(-1, -2)
        red = _f32(arg - 2 * math.pi * torch.round(arg / (2 * math.pi)))
        cs[:, rows] = torch.where(wide[:, None, :], _f32(torch.cos(red)), cs[:, rows])
    part = torch.zeros(4, B, m, W.shape[-1], dtype=torch.float64)
    part = _quad_sums(part, _f32(cs), _f32(coef.double()[:, None, None] * W.double()))
    if X is not None:
        Xb = X.expand(B, *X.shape[-2:]) if X.ndim == 2 else X
        ils = inv_ls.double()[:, None, :]
        qs = _f32(qc * ils)
        xs = _f32(_f32(Xb.double() - c[:, None]) * ils)
        nq = torch.zeros(B, m, dtype=torch.float64)
        for k in range(d):
            nq = _f32(nq + qs[..., k] ** 2)
        quarters = []
        for p in range(4):
            n = torch.zeros(xs.shape[:-1], dtype=torch.float64)
            for k in range(p * kd // 4, min(d, (p + 1) * kd // 4)):
                n = _f32(n + xs[..., k] ** 2)
            quarters.append(n)
        nx = _f32(_f32(quarters[0] + quarters[1]) + _f32(quarters[2] + quarters[3]))
        d2 = _mma(nq[:, :, None].expand(B, m, xs.shape[1]), pad(qs, 1.0).float(),
                  pad(-2.0 * xs, nx).float(), passes)
        n_x = xs.shape[1]
        tiles = torch.nn.functional.pad(nx, (0, -n_x % 8)).view(B, -1, 8).amax(-1)
        nx_max = tiles.repeat_interleave(8, dim=1)[:, :n_x]
        near = d2 < _f32(near_share * _f32(nq[:, :, None] + nx_max[:, None, :]))
        if near.any():
            exact = torch.zeros_like(d2)
            for k in range(d):
                diff = _f32(qs[:, :, None, k] - xs[:, None, :, k])
                exact = _f32(exact + diff * diff)
            d2 = torch.where(near, exact, d2)
        kv = _f32(matern_from_d2(torch.clamp(d2, min=0.0), nu))
        part = _quad_sums(part, kv, _f32(amp.double()[:, None, None] * V.double()))
    out = _f32(_f32(part[0] + part[1]) + _f32(part[2] + part[3]))
    return out, wide_pairs / (B * M * (-(-m // block)))


def _tc_inputs(nu, d=15, ls=(0.2, 0.6), per_row=False, B=2, m=600, n_pad=512, n=500, M=1024,
               R=1, seed=0):
    """Seeded float32 inputs of one K5 call, as the card tests make them
    (``tests/test_torch_cuda.py::_k5_inputs``): frequencies from the
    spectral measure of nu at lengthscales drawn from ``ls``, V normal
    and zero on the padded rows."""
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
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


# (d, lengthscales, per-row queries and points, R): the batch ask's d,
# lengthscales down to 0.05 on the unit box, the 32-wide layout, and d = 1,
# where near pairs are common
TC_CASES = [
    (15, (0.2, 0.6), False, 1),
    (15, (0.05, 0.05), True, 3),
    (17, (0.2, 0.6), True, 1),
    (1, (0.05, 0.05), False, 1),
]


@pytest.mark.parametrize("case", TC_CASES,
                         ids=lambda c: "d%d-ls%g-rows%d-R%d" % (c[0], c[1][0], c[2], c[3]))
@pytest.mark.parametrize("nu", NUS)
def test_tensor_core_arithmetic_within_k5_tolerance(nu, case):
    """The kernel's 3xTF32 arithmetic, with and without the cross term,
    within K5_REL_TOL of the largest |value| from the float64 plain
    version on the same float32 inputs, for every nu (the Matern-1/2
    features with their Cauchy tail) and at lengthscale 0.05."""
    d, ls, per_row, R = case
    args = _tc_inputs(nu, d=d, ls=ls, per_row=per_row, R=R)
    for a in (args, args[:5]):
        full = a + [None] * (9 - len(a))
        ref = pv.pathwise_values_plain(nu, *(None if t is None else t.double() for t in full))
        got, share = _emulated_k5(nu, *full)
        err = float((got - ref).abs().max())
        assert err <= K5_REL_TOL * float(ref.abs().max()), (err, float(ref.abs().max()), share)


@pytest.mark.parametrize("nu", NUS)
def test_one_pass_tf32_misses_k5_tolerance(nu):
    """The control: the same arithmetic with the products in plain TF32
    (hi.hi alone) misses the tolerance on the same data."""
    args = _tc_inputs(nu)
    ref = pv.pathwise_values_plain(nu, *(t.double() for t in args))
    got, _ = _emulated_k5(nu, *args, passes=1)
    assert float((got - ref).abs().max()) > K5_REL_TOL * float(ref.abs().max())


def test_wide_features_need_the_float64_argument():
    """At nu = 1/2 and lengthscale 0.05 a share of the features takes the
    float64 argument (none at the RBF); with every feature on the tensor
    cores instead, the Cauchy tail's arguments put the values outside the
    tolerance."""
    args = _tc_inputs(0.5, ls=(0.05, 0.05))[:5] + [None] * 4
    ref = pv.pathwise_values_plain(0.5, *(None if t is None else t.double() for t in args))
    tol = K5_REL_TOL * float(ref.abs().max())
    got, share = _emulated_k5(0.5, *args)
    assert 0.0 < share < 1.0 and float((got - ref).abs().max()) <= tol
    all_tc, none = _emulated_k5(0.5, *args, wide_rev=math.inf)
    assert none == 0.0 and float((all_tc - ref).abs().max()) > tol
    assert _emulated_k5(math.inf, *(_tc_inputs(math.inf)[:5] + [None] * 4))[1] == 0.0


def test_near_pairs_need_the_difference_distance():
    """At d = 1, nu = 1/2 and lengthscale 0.05 (the card test's case:
    3 rows, 777 queries, 200 of 256 points) many query-point pairs are
    near: without forming their d2 again from differences, the
    norms-minus-dot rounding under the Matern-1/2 root misses the
    tolerance; with it the values hold."""
    args = _tc_inputs(0.5, d=1, ls=(0.05, 0.05), B=3, m=777, n_pad=256, n=200, M=320, seed=5)
    ref = pv.pathwise_values_plain(0.5, *(t.double() for t in args))
    tol = K5_REL_TOL * float(ref.abs().max())
    assert float((_emulated_k5(0.5, *args)[0] - ref).abs().max()) <= tol
    assert float((_emulated_k5(0.5, *args, near_share=0.0)[0] - ref).abs().max()) > tol
