"""The input warp's kernels K6 (Beta CDF) and K7 (Beta PPF) around what a
CPU can run: the autograd Function the card's warp goes through, built
around the plain forward, against ``jax.grad`` of
``bask_tpu.models.warping.warp`` at x64 and against ``warping.warp_grad``;
its refusal of a gradient in the log-parameters on the kernel route;
NumPy models of the kernels' arithmetic in their type (K6's coefficient
table, division-free fraction and shared logs; K7's bisection) within
the smoke's limits of the float64 plain versions, and the fraction's
exponent range; the kernels' argument layouts (broadcast shapes, batch and row strides) through an
emulation of their indexing; the chunk rule of the pathwise draws on
both routes; and the route rule (CPU tensors take the plain versions and
never touch the kernel library). The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15)."""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import warping as jwp  # noqa: E402
from bask_tpu_torch.models import pathwise as tpw  # noqa: E402
from bask_tpu_torch.models import warping as twp  # noqa: E402
from bask_tpu_torch.ops import _cuda  # noqa: E402
from bask_tpu_torch.ops import warp_values as wv  # noqa: E402
from bask_tpu_torch.ops.gram import FusedSpec  # noqa: E402

import chip_smoke as cs  # noqa: E402

# x-gradients of the Function against JAX's and warp_grad: relative, for
# float64 pdfs up to ~1e6 near the ends
GRAD_RTOL = 1e-10


def _plain_with_pdf(X, la, lb, with_pdf=True):
    return wv.warp_plain(X, la, lb), wv.beta_pdf_plain(X, la, lb)


def _grid_params():
    """x on a grid with both ends, and (a, b) pairs spanning 0.2 .. 5 (as
    tests/test_torch_warping.py), one pair per column."""
    x = np.concatenate([[0.0, 1e-12, 1.0 - 1e-12, 1.0], np.linspace(0.01, 0.99, 45)])
    ab = np.exp(np.linspace(np.log(0.2), np.log(5.0), 6))
    a, b = (v.ravel() for v in np.meshgrid(ab, ab))
    return np.repeat(x[:, None], len(a), axis=1), np.log(a), np.log(b)


def test_function_x_gradient_matches_jax_and_warp_grad():
    """The Function's backward (incoming gradient times the pdf) against
    jax.grad of JAX's warp, with random incoming gradients, at every x of
    the grid (inf where JAX's is, at an end where the pdf is), and
    against warp_grad away from the exact ends (where warp_grad clips x
    to 1e-12)."""
    X, la, lb = _grid_params()
    G = np.random.RandomState(0).uniform(0.5, 1.5, X.shape)
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = wv._Warp.apply(Xt, torch.from_numpy(la), torch.from_numpy(lb), _plain_with_pdf)[0]
    (g,) = torch.autograd.grad((out * torch.from_numpy(G)).sum(), Xt)
    ref = np.asarray(jax.grad(lambda x: (jwp.warp(x, jnp.asarray(la), jnp.asarray(lb))
                                         * jnp.asarray(G)).sum())(jnp.asarray(X)))
    np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL, atol=0)
    pdf = twp.warp_grad(torch.from_numpy(X), torch.from_numpy(la), torch.from_numpy(lb)).numpy()
    keep = np.ones(len(X), bool)
    keep[[0, 3]] = False  # x = 0 and x = 1
    np.testing.assert_allclose(g.numpy()[keep], (G * pdf)[keep], rtol=GRAD_RTOL, atol=0)
    assert np.isfinite(g.numpy()[keep]).all()


def test_function_gradient_sums_over_walkers_and_is_zero_past_the_ends():
    """Shared X under per-walker parameters (the chain's layout): the
    gradient sums the walkers' pdfs, as JAX's vmapped warp; entries the
    clamp cut get 0, as JAX's where the pdf at that end is 0 (where it is
    infinite JAX gives 0 * inf = NaN and the Function 0)."""
    rng = np.random.RandomState(1)
    X = rng.uniform(size=(20, 3))
    X[0] = [-0.2, 1.3, 0.5]
    # a > 1 in column 0 and b > 1 in column 1: the pdf is 0 at the cut end
    LA = np.array([[0.3, 0.4, -0.2], [0.3, 0.5, 0.1], [0.2, 0.3, -0.4], [0.6, 0.2, 0.0]])
    LB = np.array([[0.2, 0.1, 0.3], [0.4, 0.3, -0.2], [0.5, 0.1, 0.2], [0.1, 0.6, 0.3]])
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = wv._Warp.apply(Xt, torch.from_numpy(LA), torch.from_numpy(LB), _plain_with_pdf)[0]
    assert out.shape == (4, 20, 3)
    (g,) = torch.autograd.grad(out.sum(), Xt)
    ref = np.asarray(jax.grad(lambda x: jax.vmap(lambda a, b: jwp.warp(x, a, b))(
        jnp.asarray(LA), jnp.asarray(LB)).sum())(jnp.asarray(X)))
    np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL, atol=0)
    assert g[0, 0] == 0.0 and g[0, 1] == 0.0  # cut by the clamp


@pytest.fixture
def kernel_route(monkeypatch):
    """The card's route on CPU tensors: the wrappers' CUDA branches
    (``warp_values._warp_on_card``, the launch of K7), the launches of K6
    and K7 stood in by their plain versions (``(out, pdf)`` with the pdf),
    counting their calls."""
    calls = []

    def k6(X, la, lb, with_pdf=False):
        calls.append(("K6", with_pdf))
        return _plain_with_pdf(X, la, lb) if with_pdf else wv.warp_plain(X, la, lb)

    def k7(Z, la, lb, steps=None):
        calls.append(("K7", steps))
        return wv.unwarp_plain(Z, la, lb, steps)

    monkeypatch.setattr(wv, "_launch_warp", k6)
    monkeypatch.setattr(wv, "warp_values", wv._warp_on_card)
    monkeypatch.setattr(wv, "unwarp_values", k7)
    return calls


def test_kernel_route_refuses_a_gradient_in_the_log_parameters(kernel_route):
    """On the kernel route a log-parameter that requires a gradient
    raises (JAX's betainc has no derivative in a and b), with or without
    a gradient in X; without grad mode it warps."""
    X, la, lb = (torch.from_numpy(a) for a in _grid_params())
    la_g = la.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no derivative in log_alphas"):
        twp.warp(X, la_g, lb)
    with pytest.raises(RuntimeError, match="no derivative in log_alphas"):
        twp.warp(X.clone().requires_grad_(True), la, lb.clone().requires_grad_(True))
    with torch.no_grad():
        assert torch.equal(twp.warp(X, la_g, lb), wv.warp_plain(X, la, lb))


def test_kernel_route_takes_the_function_only_for_a_gradient_in_x(kernel_route):
    """Through warping.warp on the kernel route: K6 with the pdf (the
    Function) where X requires a gradient, without it elsewhere; the
    x-gradient equals autograd's through the plain version; unwarp takes
    K7 at the type's full depth, whatever the caller's n_iter."""
    rng = np.random.RandomState(3)
    X = torch.from_numpy(rng.uniform(size=(30, 4)))
    la, lb = (torch.from_numpy(0.3 * rng.randn(5, 4)) for _ in range(2))
    Xg = X.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(twp.warp(Xg, la, lb).sum(), Xg)
    Xp = X.clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(wv.warp_plain(Xp, la, lb).sum(), Xp)
    np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=1e-12, atol=0)
    twp.warp(X, la, lb)
    twp.unwarp(X, la[0], lb[0], n_iter=30)
    assert kernel_route == [("K6", True), ("K6", False), ("K7", None)]


# -- NumPy models of the kernels' arithmetic (csrc/warp.cu), in the
# kernel's type, with no FMA contraction (the card contracts the term's
# multiply-add; the limits below hold either way) --


def _column(la, lb, dt):
    """A column's constants as the kernels make them, in type ``dt``:
    (a, b, flip point, betaln, log a, log b)."""
    a, b = np.exp(la.astype(dt)), np.exp(lb.astype(dt))
    flip_at = (a + dt(1)) / (a + b + dt(2))

    def lgamma(v):
        return torch.lgamma(torch.from_numpy(np.asarray(v, dt))).numpy()

    return a, b, flip_at, lgamma(a) + lgamma(b) - lgamma(a + b), np.log(a), np.log(b)


def _coefficients(aa, bb, dt):
    """The table of one side of the flip, (48, d): c_k with d_k = c_k xx,
    made once per column."""
    out = []
    for k in range(1, wv.CF_TERMS + 1):
        m = dt(k // 2)
        num = -(aa + m) * ((aa + bb) + m) if k & 1 else m * (bb - m)
        ak = aa + dt(k)
        out.append(num / ((ak - dt(1)) * ak))
    return np.stack(out)


def _model_cdf(col, table, x, exponents=None):
    """K6's CDF at x in [0, 1] (and the pdf from the same logs): the flip,
    the front from log x and log1p(-x), and the fraction from the tail as
    (P, Q) <- (P + (c_k xx) Q, P), divided once. ``exponents`` collects
    the largest |log2| of P and Q over the terms."""
    a, b, flip_at, betaln, log_a, log_b = col
    dt = x.dtype.type
    flip = x > flip_at
    xx = np.where(flip, dt(1) - x, x)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        lx, l1x = np.log(x), np.log1p(-x)
        log_front = a * lx + b * l1x - betaln - np.where(flip, log_b, log_a)
        P, Q = np.ones_like(x), np.ones_like(x)
        for k in range(wv.CF_TERMS - 1, -1, -1):
            t = np.where(flip, table[1][k], table[0][k]) * xx
            P, Q = P + t * Q, P
            if exponents is not None:
                live = np.abs(P[(P != 0) & np.isfinite(P)])
                exponents.append(float(np.abs(np.log2(live)).max(initial=0.0)))
        front = np.exp(log_front) * (Q / P)
        pdf = np.exp((a - dt(1)) * lx + (b - dt(1)) * l1x - betaln)
    return np.where(flip, dt(1) - front, front), pdf


def _model_parts(la, lb, dt):
    col = _column(la, lb, dt)
    a, b = col[0], col[1]
    return col, (_coefficients(a, b, dt), _coefficients(b, a, dt))


def _k6_model(X, la, lb, exponents=None):
    """K6 in NumPy: (warp, pdf) of X (n, d) under one (a, b) per column,
    in X's type."""
    dt = X.dtype.type
    col, table = _model_parts(la, lb, dt)
    x = np.where(X < 0, dt(0), np.where(X > 1, dt(1), X))  # NaN stays
    return _model_cdf(col, table, x, exponents)


def _k7_model(Z, la, lb, steps=None):
    """K7 in NumPy: ``steps`` (default ``wv.full_steps``) bisection steps
    over the type's bit patterns (mid = lo + (hi - lo) // 2, kept as lo
    where the CDF there lies below z, else as hi, with the CDF at both
    ends), then the end whose CDF lies nearer z; a NaN z stays NaN."""
    dt = Z.dtype.type
    ints = np.uint32 if dt == np.float32 else np.uint64
    col, table = _model_parts(la, lb, dt)
    z = np.where(Z < 0, dt(0), np.where(Z > 1, dt(1), Z))
    lo, hi = np.zeros(z.shape, ints), np.full(z.shape, np.ones(1, dt).view(ints)[0])
    cdf_lo, cdf_hi = np.zeros_like(z), np.ones_like(z)
    for _ in range(wv.full_steps(getattr(torch, dt.__name__)) if steps is None else steps):
        mid = lo + (hi - lo) // ints(2)
        cdf = _model_cdf(col, table, mid.view(dt))[0]
        below = cdf < z
        lo, cdf_lo = np.where(below, mid, lo), np.where(below, cdf, cdf_lo)
        hi, cdf_hi = np.where(below, hi, mid), np.where(below, cdf_hi, cdf)
    x = np.where(z - cdf_lo <= cdf_hi - z, lo, hi).view(dt)
    return np.where(np.isnan(z), z, x)


def _ends(A, values):
    """A with its first entries set to ``values`` (in place) and A back."""
    A.reshape(-1)[: len(values)] = values
    return A


_AT_THE_ENDS = [0.0, 1e-12, 1e-7, 1.0 - 1e-7, 1.0 - 1e-12, 1.0, -0.25, 1.25, -0.0, 1e-30]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["prior range", "ends and NaN"])
def test_k6_model_within_the_smoke_limits(dtype, case):
    """The model of K6's new arithmetic (coefficient table, the
    division-free fraction, the shared logs, the pdf) against the float64
    plain version within the smoke's WARP_TOL and PDF_RTOL, on (a, b) over
    the warp prior's 5-sigma range, the inputs rounded to the type as the
    smoke rounds them; x inside, at, near and past the ends, and NaN, which
    stays NaN in the warp and the pdf."""
    rng = np.random.RandomState(10)
    X = rng.uniform(size=(400, 32))
    if case == "ends and NaN":
        X = _ends(X, _AT_THE_ENDS * 3 + [np.nan])
    X = X.astype(dtype)
    la, lb = (rng.uniform(-1.5, 1.5, 32).astype(dtype) for _ in range(2))
    out, pdf = _k6_model(X, la, lb)
    assert out.dtype == pdf.dtype == dtype
    X64, la64, lb64 = (torch.from_numpy(v.astype(np.float64)) for v in (X, la, lb))
    ref = wv.warp_plain(X64, la64, lb64).numpy()
    pdf_ref = wv.beta_pdf_plain(X64, la64, lb64).numpy()
    nan = np.isnan(X)
    assert np.isnan(out[nan]).all() and np.isnan(pdf[nan]).all()
    assert np.isnan(ref[nan]).all()
    key = dtype.__name__
    assert np.abs(out[~nan] - ref[~nan]).max() <= cs.WARP_TOL[key]
    ok = np.isfinite(pdf_ref) & (pdf_ref > 1e-30)
    assert np.abs((pdf[ok] - pdf_ref[ok]) / pdf_ref[ok]).max() <= cs.PDF_RTOL[key]
    # the ends: 0 and 1 exactly, as the plain version
    assert (out[X <= 0] == 0).all() and (out[X >= 1] == 1).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k6_model_fraction_stays_in_the_exponent_range(dtype):
    """Over a, b in [0.01, 100] (beyond the prior's range) and x over [0, 1]
    on both sides of the flip, P and Q of the division-free fraction stay
    far inside float32's exponent range (|log2| <= 80 of its 127), so the
    kernels need no rescaling; the warp stays finite, in [0, 1], and within
    the float64 plain version's own truncation there."""
    grid = np.linspace(np.log(0.01), np.log(100.0), 25)
    la, lb = (v.ravel() for v in np.meshgrid(grid, grid))
    x = np.concatenate([[0.0, 1e-30, 1e-7, 1.0 - 1e-7, 1.0], np.linspace(0.0, 1.0, 201)])
    X = np.repeat(x[:, None], la.size, axis=1).astype(dtype)
    exponents = []
    out, _ = _k6_model(X, la.astype(dtype), lb.astype(dtype), exponents)
    assert max(exponents) <= 80
    assert np.isfinite(out).all() and (out >= 0).all() and (out <= 1).all()
    X64, la64, lb64 = (torch.from_numpy(v.astype(dtype).astype(np.float64)) for v in (X, la, lb))
    ref = wv.warp_plain(X64, la64, lb64).numpy()
    # float64: 2e-11, the plain fraction's own bound against scipy there
    # (tests/test_torch_warping.py); float32: its rounding over the range
    assert np.abs(out - ref).max() <= (1e-4 if dtype == np.float32 else 2e-11)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("steps", [None, 70, "control"])
def test_k7_model_within_the_smoke_limit(dtype, steps):
    """The model of K7's bisection (one entry's steps, on the model of K6's
    CDF) against the float64 plain version (``warping.unwarp`` on float64
    tensors) on z inside, at, near and past the ends and NaN, with (a, b)
    over the prior's 5-sigma range: within the smoke's rule
    (``chip_smoke.unwarp_share``: x within UNWARP_TOL of the root or its
    float64 CDF within WARP_TOL of z) at the type's full depth; steps past
    it change nothing; stopped at the smoke's ``CONTROL_STEPS`` it misses
    the rule; a NaN z stays NaN, as in the plain version."""
    rng = np.random.RandomState(11)
    Z = _ends(rng.uniform(size=(160, 15)), _AT_THE_ENDS + [np.nan]).astype(dtype)
    la, lb = (rng.uniform(-1.5, 1.5, 15).astype(dtype) for _ in range(2))
    n = cs.CONTROL_STEPS[dtype.__name__] if steps == "control" else steps
    x = _k7_model(Z, la, lb, n)
    assert x.dtype == dtype
    if steps == 70:
        np.testing.assert_array_equal(x, _k7_model(Z, la, lb))
    Z64, la64, lb64 = (torch.from_numpy(v.astype(np.float64)) for v in (Z, la, lb))
    nan = np.isnan(Z)
    plain = wv.unwarp_plain(torch.from_numpy(Z), torch.from_numpy(la), torch.from_numpy(lb),
                            n).numpy()
    assert np.isnan(x[nan]).all() and np.isnan(plain[nan]).all()
    ref = wv.unwarp_plain(Z64, la64, lb64)
    keep = torch.from_numpy(~nan)
    xt = torch.from_numpy(x.astype(np.float64))
    share = cs.unwarp_share(xt[keep], ref[keep], Z64[keep],
                            la64.expand(Z.shape)[keep], lb64.expand(Z.shape)[keep],
                            dtype.__name__)
    assert (share > 1.0) if steps == "control" else (share <= 1.0), share


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k7_model_resolves_a_steep_warp_to_the_type(dtype):
    """Where a or b is well below 1 the CDF is steep at an end (at a = 0.03
    every z below 0.3 maps below 2^-60): the model of K7 and the plain
    version in the same type return an x whose cell, the CDF's image of
    x's neighbours in that type, holds z (the float64 plain CDF, within
    WARP_TOL of the type's CDF rounding), on z spread over (0, 1) in
    log scale at both ends."""
    z = np.concatenate([np.logspace(-12, -0.3, 40), 1.0 - np.logspace(-0.3, -7, 40)])
    ab = np.log([0.03, 0.05, 1.0, 4.0, 0.03, 25.0])
    la, lb = ab.astype(dtype), ab[::-1].copy().astype(dtype)
    Z = np.repeat(z[:, None], len(ab), axis=1).astype(dtype)
    tol = cs.WARP_TOL[dtype.__name__]
    for x in (_k7_model(Z, la, lb),
              wv.unwarp_plain(*(torch.from_numpy(v) for v in (Z, la, lb))).numpy()):
        xt = torch.from_numpy(x)
        cells = [torch.nextafter(xt, torch.zeros_like(xt)), torch.nextafter(xt, torch.ones_like(xt))]
        lo64, hi64 = (wv.warp_plain(c.double(), torch.from_numpy(la).double(),
                                    torch.from_numpy(lb).double()).numpy() for c in cells)
        z64 = Z.astype(np.float64)
        assert (lo64 - tol <= z64).all() and (z64 <= hi64 + tol).all()
        assert x.dtype == dtype
        # far below the 2^-61 where the JAX package's 60 halvings of [0, 1] stop
        assert 0.0 < x[:, 0][x[:, 0] > 0].min() < 2.0 ** -100


def _emulate(layout, fn):
    """The kernels' indexing on the CPU: entry (b, i, j) reads X at
    ``b * x_stride + i * d + j`` and the parameters at ``b * stride + j``
    of their storage, and is written at ``(b * n + i) * d + j`` of the
    output; ``fn(x, la, lb)`` gives one entry's value."""
    Xk, x_stride, la, lb, B, n, d, out_shape = layout
    flat_x = Xk.reshape(-1)
    pa = torch.as_strided(la, (B, d), (la.stride(0) if B > 1 else 0, 1))
    pb = torch.as_strided(lb, (B, d), (lb.stride(0) if B > 1 else 0, 1))
    out = torch.empty(B * n * d, dtype=Xk.dtype)
    for b in range(B):
        x = flat_x[b * x_stride: b * x_stride + n * d].reshape(n, d)
        out[b * n * d: (b + 1) * n * d] = fn(x, pa[b], pb[b]).reshape(-1)
    return out.reshape(out_shape)


@pytest.mark.parametrize("case", ["shared, one pair", "shared, per row", "per row",
                                  "one point", "leading dims, one pair", "strided rows"])
def test_kernel_layouts_give_the_plain_broadcast(case):
    """Every caller's layout, read as the kernels read it, gives the plain
    version's values and shape: X (n, d) with (d,) or (W, d) parameters,
    X (W, n, d) with (W, d), one point (d,), X (2, 3, n, d) with (d,), and
    (W, d) parameters sliced out of MCMC rows (row stride D, no copy)."""
    rng = np.random.RandomState(5)
    n, d, W = 7, 3, 4

    def t(*shape):
        return torch.from_numpy(rng.uniform(size=shape))

    rows = torch.from_numpy(0.3 * rng.randn(W, 2 + 2 * d))
    X, la, lb = {
        "shared, one pair": (t(n, d), t(d) - 0.5, t(d) - 0.5),
        "shared, per row": (t(n, d), t(W, d) - 0.5, t(W, d) - 0.5),
        "per row": (t(W, n, d), t(W, d) - 0.5, t(W, d) - 0.5),
        "one point": (t(d), t(d) - 0.5, t(d) - 0.5),
        "leading dims, one pair": (t(2, 3, n, d), t(d) - 0.5, t(d) - 0.5),
        "strided rows": (t(n, d), *twp.split_warp_params(rows, d)[1:]),
    }[case]
    layout = wv._layout(X, la, lb)
    ref = wv.warp_plain(X, la, lb)
    assert tuple(layout[-1]) == tuple(ref.shape)
    got = _emulate(layout, wv.warp_plain)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    if case == "strided rows":
        assert layout[2].stride(0) == 2 + 2 * d  # read in place
        assert layout[2].data_ptr() == la.data_ptr()
    back = _emulate(wv._layout(ref, la, lb), lambda z, a, b: wv.unwarp_plain(z, a, b))
    np.testing.assert_array_equal(back.numpy(), wv.unwarp_plain(ref, la, lb).numpy())


def test_layout_refuses_mixed_types_and_widths():
    X = torch.rand(5, 3, dtype=torch.float64)
    with pytest.raises(TypeError):
        wv._layout(X, torch.zeros(3), torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        wv._layout(X, torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64))


def test_draws_per_chunk_on_both_routes():
    """The batch ask's draws (256 of them, 65,536 candidates in 15-D,
    float32): one chunk of 256 on K6's route (the draws and the warped
    queries, m (1 + d) floats a draw: 2^30 / 2^22), 5 on the plain route
    (the warp's 48 coefficients of (m, d) a draw); unwarped 256 on both."""
    assert tpw.draws_per_chunk(256, 65536, 15, 15, 4, warp_on_kernels=True) == 256
    assert tpw.draws_per_chunk(256, 65536, 15, 15, 4, warp_on_kernels=False) == 5
    assert tpw.draws_per_chunk(256, 65536, 15, 15, 4) == 5
    for route in (True, False):
        assert tpw.draws_per_chunk(256, 65536, 15, 0, 4, warp_on_kernels=route) == 256
    assert tpw.draws_per_chunk(512, 65536, 15, 15, 4, warp_on_kernels=True) == 256


def test_warped_topk_hyper_on_the_kernel_route_is_one_chunk(kernel_route, monkeypatch):
    """pathwise_topk_hyper with warping on K6's route: one chunk (K6 once
    for the training X, once for the queries), and the draws and top-k
    equal the plain route's in chunks of one. (A CPU tensor's queries
    take the plain chunk rule, so CHUNK_BYTES is sized by it; K6's rule:
    ``test_draws_per_chunk_on_both_routes``.)"""
    rng = np.random.RandomState(6)
    n, n_pad, d, S, m, M = 20, 64, 2, 6, 300, 32
    spec = FusedSpec(nu=2.5, n_ls=d, has_const=True, has_white=True)
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = np.sin(4 * X[:n, 0])
    from bask_tpu_torch.models import gp as gpc

    data = gpc.make_data(*(torch.from_numpy(a) for a in (X, y, np.full(n_pad, 1e-6))),
                         torch.from_numpy(np.arange(n_pad) < n))
    rows = np.concatenate([np.log([1.0, 0.3, 0.4, 0.01])[None] + 0.1 * rng.randn(S, 4),
                           0.3 * rng.randn(S, 2 * d)], axis=1)
    rows = torch.from_numpy(rows)
    gen = torch.Generator().manual_seed(7)
    rand = tpw.draw_pathwise_randoms(gen, 2.5, M, d, n_pad, 1, batch=(S,), dtype=torch.float64)
    Xq = torch.from_numpy(rng.uniform(size=(m, d)))
    monkeypatch.setattr(tpw, "CHUNK_BYTES", m * (1 + wv.CF_TERMS * d) * 8 * S)  # S draws
    idx, draws = tpw.pathwise_topk_hyper(spec, rows, data, Xq, rand, d, 5, n_real=n,
                                         keep=range(S))
    assert [c[0] for c in kernel_route] == ["K6", "K6"]
    monkeypatch.undo()  # the plain route, in chunks of one
    monkeypatch.setattr(tpw, "CHUNK_BYTES", m * (1 + wv.CF_TERMS * d) * 8)
    assert tpw.draws_per_chunk(S, m, d, d, 8) == 1
    idx_p, draws_p = tpw.pathwise_topk_hyper(spec, rows, data, Xq, rand, d, 5, n_real=n,
                                             keep=range(S))
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())
    np.testing.assert_allclose(draws.numpy(), draws_p.numpy(), rtol=0, atol=1e-12)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """The route rule: a CPU tensor never reaches the kernel library (a
    library that raises is never loaded) and its launch counts stay; the
    wrappers on CPU tensors are the plain versions bit for bit."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    rng = np.random.RandomState(8)
    X = torch.from_numpy(rng.uniform(size=(12, 3)))
    la, lb = (torch.from_numpy(0.3 * rng.randn(4, 3)) for _ in range(2))
    k6, k7 = wv.warp_values.launches, wv.unwarp_values.launches
    w = twp.warp(X, la, lb)
    assert torch.equal(w, wv.warp_plain(X, la, lb))
    assert torch.equal(wv.warp_values(X, la, lb), w)
    out, pdf = wv.warp_values(X, la, lb, with_pdf=True)
    assert torch.equal(out, w) and torch.equal(pdf, wv.beta_pdf_plain(X, la, lb))
    u = twp.unwarp(X, la[0], lb[0], n_iter=12)
    assert torch.equal(u, wv.unwarp_plain(X, la[0], lb[0]))
    assert torch.equal(wv.unwarp_values(X, la[0], lb[0]), u)
    assert torch.equal(wv.unwarp_values(X, la[0], lb[0], 12), wv.unwarp_plain(X, la[0], lb[0], 12))
    assert (wv.warp_values.launches, wv.unwarp_values.launches) == (k6, k7)


def test_full_steps():
    """The unwarp's bisection to adjacent floats: 30 steps over the bit
    patterns of [0, 1] at float32, 62 at float64."""
    assert [wv.full_steps(t) for t in (torch.float32, torch.float64)] == [30, 62]


def _emulated_k6(X, la, lb, with_pdf=False):
    """K6 stood in by its indexing over ``_layout`` (each row warped on its
    own by the plain version)."""
    layout = wv._layout(X, la, lb)
    out = _emulate(layout, wv.warp_plain)
    return (out, _emulate(layout, wv.beta_pdf_plain)) if with_pdf else out


def _emulated_k7(Z, la, lb, steps=None):
    return _emulate(wv._layout(Z, la, lb), lambda z, a, b: wv.unwarp_plain(z, a, b, steps))


def _warped_asks(acq):
    from bask_tpu_torch import Optimizer

    rng = np.random.RandomState(9)
    opt = Optimizer(dimensions=[(0.0, 1.0)] * 2, n_initial_points=6, n_points=200,
                    acq_func=acq, acq_polish=2, gp_kwargs={"warp_inputs": True},
                    gp_sample_kwargs={"until_rhat": None}, random_state=0, device="cpu")
    X = rng.uniform(size=(8, 2))
    y = np.sin(4 * X[:, 0]) + X[:, 1] ** 2
    opt.tell(X.tolist(), y.tolist(), n_samples=2, gp_samples=20, gp_burnin=2)
    return np.asarray(opt.ask()), np.asarray(opt.ask(n_points=3))


@pytest.mark.parametrize("acq", ["pvrs", "ei"])
def test_warped_optimizer_fits_the_kernels_layouts(monkeypatch, acq):
    """A warped Optimizer's tell (the chain's per-walker X, the consensus
    warp, the acquisition over a warp-density grid, the polish's gradient
    in x through the Function), its ask and a batch ask (the joint draws
    of the exact branch) with K6 and K7 stood in by their indexing over
    ``_layout``: every caller's arguments fit the kernels' layouts, and
    the asks are the plain route's. (The pathwise branch's layouts:
    ``test_warped_topk_hyper_on_the_kernel_route_is_one_chunk``.)"""
    plain = _warped_asks(acq)
    calls = []

    def k6(*a, **k):
        calls.append("K6")
        return _emulated_k6(*a, **k)

    def k7(*a, **k):
        calls.append("K7")
        return _emulated_k7(*a, **k)

    monkeypatch.setattr(wv, "_launch_warp", k6)
    monkeypatch.setattr(wv, "warp_values", wv._warp_on_card)
    monkeypatch.setattr(wv, "unwarp_values", k7)
    routed = _warped_asks(acq)
    assert "K6" in calls and "K7" in calls
    for got, ref in zip(routed, plain):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
