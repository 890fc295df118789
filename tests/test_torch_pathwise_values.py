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
