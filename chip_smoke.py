#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bask_tpu_torch``) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one result line:

1. the card, torch and CUDA versions, the matmul precision, and the
   build of the hand-written kernels from ``bask_tpu_torch/csrc``;
2. K1 (fused masked gram, ``csrc/gram.cu``) against its plain PyTorch
   version run in float64 on the same inputs, at the chain's shape
   (50, 512, 512), d = 15, for all four nu, ragged n_real = 500, with
   per-walker X, and for the spec variants the in-kernel packing reads
   (no ConstantKernel, no WhiteKernel, one isotropic lengthscale); a
   profiler count that one wrapper call issues one device operation;
3. K2 (the lower 128-tiles of K1's gram, the same source) against its
   float64 plain version at the same shapes, bit-equal to K1 where it
   computes and exactly 0 in the strictly upper 128-tiles;
4. K3 (Cholesky + inverse of blocks up to 128 wide,
   ``csrc/chol_base.cu``) against the float64 factor at m = 32, 64 and
   128, read in place from a diagonal block of a (50, 512, 512) gram, and
   the NaN contract on a non-PD block at m = 128; then the factorization
   A/B: one (50, 512, 512) factorization + forward solve with 32-wide
   and 128-wide K3 bases against ``cholesky_ex`` + ``solve_triangular``,
   in turns;
5. the batched log marginal likelihood at (100, 512, d = 15) on the
   bench dataset, float32 on the card against the port's float64 run on
   the CPU; then with ``gram.LOWER_GRAM = "on"`` (K2), bit-equal to the
   K1 run, for shared X and for per-walker warped X;
6. the Optimizer end to end on the card: a cold tell of 500 points
   (ML-II, then sampling to split R-hat 1.1 in capped legs), three warm
   ask/tell rounds with PVRS, one marginalized EI pass over a 500-point
   grid; the kernels' launch counts over this phase;
7. the same Optimizer with input warping and ``LOWER_GRAM = "on"``: the
   chain's grams come from K2 on per-walker warped X; a cold tell, three
   warm PVRS tells, then one pass of each of the eight acquisitions over
   a 500-point grid; the launch counts of K1, K2 and K3 over this phase,
   which are the ``launches`` of the kernel table;
8. the batch ask at the shape of ``benchmarks/bench_batch_ask.py``
   (n = 1,000 in 15-D padded to 1,024, 256 walkers, normalized y): a cold
   tell with an EI pass over 65,536 candidates, then ``ask(n_points=256)``
   twice (pathwise Thompson top-k, K1 at (256, 1024, 1024) and its
   blocked factorization with K3 bases); K1 alone at (256, 1024, 1024)
   and (128, 1024, 1024) against its float64 plain version on a few rows,
   the (256, 1024, 1024) factorization A/B against ``cholesky_ex``, and
   4 of 256 pathwise draws held to a float64 recomputation;
9. on phase 6's fitted Optimizer (n = 500, d = 15): a warm tell with the
   PVRS polish and one with the EI polish (each polished value no lower
   than its start under the same draws), the chain's diagnostics, the
   three stopping diagnostics, and the legacy dispatcher bit-equal to
   the fused pass.

The ``launches`` of the kernel table sum phases 7-9, each counted from 0
just before the phase drives the Optimizer and read just after it.

No failure is caught: a phase that fails ends the run with a non-zero
exit. Without a CUDA card it exits non-zero at once. The last three
lines are the card's name and power limit, the kernel table and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# the north-star problem (bench.py): n = 500 points in 15-D, padded to 512
N_OBS, N_DIM, N_PAD, N_WALKERS, N_CAND = 500, 15, 512, 100, 500
# R-hat legs of 300 steps for each cold tell (the Optimizer's default is 12)
COLD_LEGS = 2
# the batch ask of BASELINE.json configs[4] (benchmarks/bench_batch_ask.py)
BATCH_OBS, BATCH_PAD, BATCH_WALKERS, BATCH_CAND, BATCH_K = 1000, 1024, 256, 65536, 256
# the draws of phase 8 recomputed in float64, and the limit of a draw's
# float32 error over its max |value|: ~3.3x the largest read on an H100
# (~9e-5, draw 0 at cond K 1.14e5; the same on every run) and ~46x
# below the worst-case eps32 (3n + cond K)
CHECK_DRAWS = (0, 85, 170, 255)
DRAW_REL_TOL = 3e-4
# published peaks of one H100 SXM (NVIDIA's datasheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def report(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=float), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events
    (after one warm-up run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bench_dataset():
    """bench.py's dataset (seed 0): X uniform in [0, 1]^15, a noisy bowl,
    y standardized."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(N_OBS, N_DIM))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(N_OBS)
    return X, (y - y.mean()) / y.std()


def bound_ms(n_bytes: float, n_ops: float):
    """(the least time for the work, what bounds it): bytes moved over the
    HBM rate against float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gram_bound(B, n_pad, d, computed_share=1.0):
    """The gram kernels' bound: read X, the packed rows and alpha once,
    write the (B, n_pad, n_pad) float32 output once; per computed entry
    2d FLOPs of distance and about 12 of Matern, mask and diagonal."""
    n_bytes = 4 * (B * n_pad * n_pad + n_pad * d + B * (d + 2) + n_pad)
    n_ops = computed_share * B * n_pad * n_pad * (2 * d + 12)
    return bound_ms(n_bytes, n_ops)


def bench_kernel(bk, nu=2.5):
    base = bk.RBF if nu == math.inf else bk.Matern
    kw = {} if nu == math.inf else {"nu": nu}
    return bk.ConstantKernel(1.0, (0.1, 2.0)) * base(
        tuple([0.3] * N_DIM), (0.05, 2.0), **kw
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))


def variant_kernel(bk, variant, nu=2.5):
    """The bench kernel with one part of the fused family changed: the
    layouts of thetas the gram kernel's in-kernel packing reads."""
    base = bk.RBF if nu == math.inf else bk.Matern
    kw = {} if nu == math.inf else {"nu": nu}
    ls = 0.3 if variant == "isotropic" else tuple([0.3] * N_DIM)
    core = base(ls, (0.05, 2.0), **kw)
    white = bk.WhiteKernel(0.05, (1e-5, 1e5))
    const = bk.ConstantKernel(1.0, (0.1, 2.0))
    return {
        "no ConstantKernel": core + white,
        "no WhiteKernel": const * core,
        "isotropic": const * core + white,
    }[variant]


def profiled(fn, reps=1, wall=False):
    """(device operations per ``fn()``, the device events) over ``reps``
    calls after one warm-up call, by torch.profiler; with ``wall``, also
    the host seconds of the ``reps`` calls alone (to the synchronize after
    them; the profiler's start and stop are outside)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if wall:
        return len(ops) / reps, ops, seconds
    return len(ops) / reps, ops


def kernel_us(ops, key):
    """Median device microseconds of the profiled kernels named ``key``."""
    times = [e.device_time for e in ops if key in e.name]
    return float(np.median(times)) if times else None


def padded(X):
    Xp = np.full((N_PAD, X.shape[1]), 0.5)
    Xp[: len(X)] = X
    return Xp


def phase_device():
    import torch

    from bask_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = [
        ln.strip() for ln in _cuda.build_info.get("ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln
    ]
    report(
        "phase 1 device",
        card=smi,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        matmul_precision=torch.get_float32_matmul_precision(),
        build_s=build_s,
        ptxas=ptxas,
    )
    return smi


def phase_gram(dev):
    """K1 against its plain version run in float64 on the same inputs, so
    the kernel's float32 rounding is the only difference."""
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    rng = np.random.RandomState(1)
    X, _ = bench_dataset()
    Xd = torch.tensor(padded(X), dtype=torch.float32, device=dev)
    alpha = torch.full((N_PAD,), 1e-6, dtype=torch.float32, device=dev)
    B = N_WALKERS // 2
    # per-walker inputs (the warped-input layout): fresh uniform points
    Xw = torch.tensor(
        np.stack([padded(rng.uniform(size=(N_OBS, N_DIM))) for _ in range(B)]),
        dtype=torch.float32, device=dev,
    )
    # |dK| <= 4e-6 max|K|: float32 rounding of d2 = |xi|^2 + |xj|^2 - 2 xi.xj
    # is ~8 d eps |x/ls|^2, at the kernel's steepest slope over these
    # points (the bound tests/test_pallas_gram.py's fused-marginal case holds)
    rtol = 4e-6
    cases, worst = [], 0.0
    runs = [(f"nu={nu}", bench_kernel(bk, nu), Xd) for nu in (0.5, 1.5, 2.5, math.inf)]
    runs.append(("nu=2.5, per-walker X", bench_kernel(bk, 2.5), Xw))
    runs += [(v, variant_kernel(bk, v), Xd)
             for v in ("no ConstantKernel", "no WhiteKernel", "isotropic")]
    for label, kernel, Xin in runs:
        spec = gram.match_fusable(kernel)
        th = torch.tensor(
            kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
            dtype=torch.float32, device=dev,
        )
        K = gram.fused_masked_gram_batch(spec, th, Xin, alpha, N_OBS)
        ref = gram.fused_masked_gram_plain(
            spec, th.double(), Xin.double(), alpha.double(), N_OBS
        )
        torch.cuda.synchronize()
        err = float((K.double() - ref).abs().max())
        bound = rtol * float(ref.abs().max())
        ok = bool(torch.isfinite(K).all()) and err <= bound
        cases.append({"case": label, "spec": spec._asdict(), "n_real": N_OBS,
                      "max_abs_err": err, "bound": bound, "ok": ok})
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {cases[-1]}")
    kernel = bench_kernel(bk, 2.5)
    spec = gram.match_fusable(kernel)
    th = torch.tensor(
        kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
        dtype=torch.float32, device=dev,
    )
    def call():
        return gram.fused_masked_gram_batch(spec, th, Xd, alpha, N_OBS)

    ops_per_call, _ = profiled(call)
    if ops_per_call != 1:
        raise AssertionError(f"K1's wrapper issued {ops_per_call} device operations, not 1")
    _, ops = profiled(call, reps=20)
    alone_us = kernel_us(ops, "gram_kernel")
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(spec, th, Xd, alpha, N_OBS))
    bound, by = gram_bound(B, N_PAD, N_DIM)
    report("phase 2 K1 gram", cases=cases, device_ops_per_call=ops_per_call,
           ms=ms, kernel_alone_us=alone_us,
           share_of_write_bound=bound * 1e3 / alone_us, plain_ms=plain_ms,
           bound_ms=bound, bound_by=by, shape=[B, N_PAD, N_PAD])
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def phase_lower_gram(dev):
    """K2 against its plain version in float64 on the same inputs, at K1's
    bound; its computed entries bit-equal to K1's on the card and its
    strictly upper 128-tiles exactly 0. Times K2, K1 and the plain K2."""
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    rng = np.random.RandomState(4)
    X, _ = bench_dataset()
    Xd = torch.tensor(padded(X), dtype=torch.float32, device=dev)
    alpha = torch.full((N_PAD,), 1e-6, dtype=torch.float32, device=dev)
    B = N_WALKERS // 2
    Xw = torch.tensor(
        np.stack([padded(rng.uniform(size=(N_OBS, N_DIM))) for _ in range(B)]),
        dtype=torch.float32, device=dev,
    )
    tiles = torch.arange(N_PAD, device=dev) // gram._SQ_TILE
    upper = tiles[None, :] > tiles[:, None]
    cases, worst = [], 0.0
    for nu in (0.5, 1.5, 2.5, math.inf):
        for Xin in (Xd, Xw):
            kernel = bench_kernel(bk, nu)
            spec = gram.match_fusable(kernel)
            th = torch.tensor(
                kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
                dtype=torch.float32, device=dev,
            )
            K2 = gram.fused_masked_gram_lower_batch(spec, th, Xin, alpha, N_OBS)
            K1 = gram.fused_masked_gram_batch(spec, th, Xin, alpha, N_OBS)
            ref = gram.fused_masked_gram_lower_plain(
                spec, th.double(), Xin.double(), alpha.double(), N_OBS
            )
            torch.cuda.synchronize()
            err = float((K2.double() - ref).abs().max())
            bound = 4e-6 * float(ref.abs().max())  # K1's bound (phase 2)
            equal_k1 = bool(torch.equal(K2[:, ~upper], K1[:, ~upper]))
            zeros = bool((K2[:, upper] == 0).all())
            ok = bool(torch.isfinite(K2).all()) and err <= bound and equal_k1 and zeros
            cases.append({"nu": nu, "mode": "per-walker X" if Xin.ndim == 3 else "shared X",
                          "max_abs_err": err, "bound": bound, "equal_to_K1": equal_k1,
                          "upper_zero": zeros, "ok": ok})
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"K2 disagrees: {cases[-1]}")
    kernel = bench_kernel(bk, 2.5)
    spec = gram.match_fusable(kernel)
    th = torch.tensor(
        kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
        dtype=torch.float32, device=dev,
    )
    args = (spec, th, Xd, alpha, N_OBS)
    # in turns: K2, K1, K1, K2
    t2a = cuda_ms(lambda: gram.fused_masked_gram_lower_batch(*args))
    t1a = cuda_ms(lambda: gram.fused_masked_gram_batch(*args))
    t1b = cuda_ms(lambda: gram.fused_masked_gram_batch(*args))
    t2b = cuda_ms(lambda: gram.fused_masked_gram_lower_batch(*args))
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_lower_plain(*args))
    _, ops = profiled(lambda: gram.fused_masked_gram_lower_batch(*args), reps=20)
    alone_us = kernel_us(ops, "gram_kernel")
    n_tiles = N_PAD // gram._SQ_TILE
    share = n_tiles * (n_tiles + 1) / 2 / n_tiles**2
    bound, by = gram_bound(B, N_PAD, N_DIM, share)
    ms = float(np.median([t2a, t2b]))
    report("phase 3 K2 lower gram", cases=cases, ms_turns=[t2a, t2b],
           k1_ms_turns=[t1a, t1b], kernel_alone_us=alone_us,
           share_of_write_bound=bound * 1e3 / alone_us, plain_ms=plain_ms, bound_ms=bound,
           bound_by=by, computed_tile_share=share, shape=[B, N_PAD, N_PAD])
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _spd_batch(rng, B, m):
    """SPD test blocks as in tests/test_pallas_chol_base.py."""
    Xp = rng.uniform(size=(m, 5))
    K0 = np.exp(
        -0.5 * ((Xp[:, None] - Xp[None]) ** 2).sum(-1) / 0.3**2
    ) + 1e-2 * np.eye(m)
    return np.broadcast_to(K0, (B, m, m)).copy() * (
        1.0 + 0.1 * rng.rand(B)
    )[:, None, None]


def phase_chol(dev):
    """K3 against the float64 factor (its plain version in float64 on the
    same inputs), at the tolerances of tests/test_pallas_chol_base.py for
    m <= 32 and those bounds times m / 32 above."""
    import torch

    from bask_tpu_torch.ops import chol_base

    rng = np.random.RandomState(0)
    cases, worst = [], 0.0

    def check(label, A):
        m = A.shape[-1]
        L, Xi = chol_base.chol_inv_base(A)
        Lr, _ = chol_base.chol_inv_plain(A.double())
        torch.cuda.synchronize()
        err_l = float((L.double() - Lr).abs().max())
        eye = torch.eye(m, dtype=torch.float64, device=dev)
        err_x = float((Xi.double() @ Lr - eye).abs().max())
        tril = bool((L == torch.tril(L)).all() and (Xi == torch.tril(Xi)).all())
        scale = max(1.0, m / 32)
        ok = err_l < 5e-6 * scale and err_x < 5e-5 * scale and tril
        cases.append({"case": label, "shape": list(A.shape), "L_err": err_l,
                      "L_bound": 5e-6 * scale, "XL_minus_I": err_x,
                      "XL_bound": 5e-5 * scale, "ok": ok})
        if not ok:
            raise AssertionError(f"K3 disagrees with the float64 factor: {cases[-1]}")
        return err_l

    for B, m in ((50, 32), (50, 64), (50, 128), (1, 32), (7, 24), (7, 100)):
        A = torch.tensor(_spd_batch(rng, B, m), dtype=torch.float32, device=dev)
        worst = max(worst, check("contiguous", A))
    # a diagonal 128-block of the chain's (50, 512, 512) gram, read in place
    big = chain_gram(dev)
    block = big[:, 128:256, 128:256]
    assert not block.is_contiguous()
    worst = max(worst, check("diagonal block of (50, 512, 512), in place", block))
    bad = -torch.eye(128, device=dev).expand(4, 128, 128).contiguous()
    Ln, Xn = chol_base.chol_inv_base(bad)
    nan_ok = bool(torch.isnan(Ln[:, -1, -1]).all() and torch.isnan(Xn[:, -1, -1]).all())
    if not nan_ok:
        raise AssertionError("K3 lost the NaN of a non-PD block at m = 128")
    B, m = 50, 128
    A = torch.tensor(_spd_batch(rng, B, m), dtype=torch.float32, device=dev)
    eye = torch.eye(m, device=dev).expand(B, m, m)

    def library():
        # the PyTorch pair that computes the same function
        L, _ = torch.linalg.cholesky_ex(A)
        return L, torch.linalg.solve_triangular(L, eye, upper=False)

    ms = cuda_ms(lambda: chol_base.chol_inv_base(A))
    _, ops = profiled(lambda: chol_base.chol_inv_base(A), reps=20)
    alone_us = kernel_us(ops, "chol_inv_kernel")
    plain_ms = cuda_ms(lambda: chol_base.chol_inv_plain(A))
    library_ms = cuda_ms(library)
    # read the lower triangle of A once, write L and L^-1 once; m^3/3
    # FLOPs of factor and about m^3/3 of inverse per matrix (the m
    # dependent steps are a latency floor this count does not see)
    bound, by = bound_ms(4 * B * (m * (m + 1) // 2 + 2 * m * m), B * 2 * m**3 / 3)
    report("phase 4 K3 chol_base", cases=cases, nan_contract_m128=nan_ok, ms=ms,
           kernel_alone_us=alone_us, plain_ms=plain_ms, library_ms=library_ms,
           library="cholesky_ex + solve_triangular(L, I)", bound_ms=bound,
           bound_by=by, shape=[B, m, m])
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def chain_gram(dev):
    """The chain's (50, 512, 512) masked gram of the bench data (K1)."""
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    X, _ = bench_dataset()
    kernel = bench_kernel(bk)
    th = 0.05 * np.random.RandomState(1).randn(N_WALKERS // 2, kernel.n_theta)
    th[:, -1] += np.log(0.05)
    return gram.fused_masked_gram_batch(
        gram.match_fusable(kernel), torch.tensor(th, dtype=torch.float32, device=dev),
        torch.tensor(padded(X), dtype=torch.float32, device=dev),
        torch.full((N_PAD,), 1e-6, dtype=torch.float32, device=dev), N_OBS,
    )


def phase_factor_ab(dev):
    """The base-width A/B: one (50, 512, 512) factorization + forward
    solve + LML terms with 128-wide and 32-wide K3 bases, and
    ``cholesky_ex`` + ``solve_triangular`` as the yardstick, in turns
    (128, 32, library, library, 32, 128), by CUDA events."""
    import torch

    from bask_tpu_torch.ops import chol_base
    from bask_tpu_torch.ops import fast_cholesky as fc

    Kp = chain_gram(dev)
    _, y = bench_dataset()
    yp = np.zeros(N_PAD)
    yp[:N_OBS] = y
    yb = torch.tensor(yp, dtype=torch.float32, device=dev).expand(Kp.shape[:-1])
    default = fc._BASE

    def blocked(base):
        def run():
            fc._BASE = base
            try:
                return fc.fast_lml_terms(Kp, yb)[1:]
            finally:
                fc._BASE = default
        return run

    def library():
        L, _ = torch.linalg.cholesky_ex(Kp)
        w = torch.linalg.solve_triangular(L, yb[..., None], upper=False)[..., 0]
        return torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1), (w * w).sum(-1)

    runs = {"base 128": blocked(128), "base 32": blocked(32), "cholesky_ex": library}
    terms, launches = {}, {}
    for name, fn in runs.items():
        before = chol_base.chol_inv_base.launches
        terms[name] = [t.double() for t in fn()]
        launches[name] = chol_base.chol_inv_base.launches - before
    ref = terms["cholesky_ex"]
    agree = {name: max(float(((a - b) / b.abs().clamp(min=1.0)).abs().max())
                       for a, b in zip(t, ref)) for name, t in terms.items()}
    turns = {name: [] for name in runs}
    for name in ["base 128", "base 32", "cholesky_ex", "cholesky_ex", "base 32", "base 128"]:
        turns[name].append(cuda_ms(runs[name]))
    ops = {name: profiled(fn)[0] for name, fn in runs.items()}
    report("phase 4b factorization A/B", shape=list(Kp.shape), ms_turns=turns,
           median_ms={k: float(np.median(v)) for k, v in turns.items()},
           k3_launches=launches, device_ops=ops,
           rel_diff_vs_cholesky_ex=agree, base_in_use=default)
    if not all(v <= 1e-4 for v in agree.values()):
        raise AssertionError(f"the factorizations disagree: {agree}")


def phase_lml(dev):
    """Batched LML (K1 gram + blocked factorization with K3 bases) at the
    bench shape, against the port's float64 CPU path (plain gram and
    LAPACK factorization) on the same thetas."""
    import torch

    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.ops import linalg

    X, y = bench_dataset()
    kernel = bench_kernel(bk)
    yp = np.zeros(N_PAD)
    yp[:N_OBS] = y
    # bench.py's initial ensemble: a 0.05 ball, noise channel at log(0.05)
    thetas = 0.05 * np.random.RandomState(1).randn(N_WALKERS, kernel.n_theta)
    thetas[:, -1] += np.log(0.05)
    mask = np.arange(N_PAD) < N_OBS

    def run(device, dtype):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        args = (t(thetas), t(padded(X)), t(yp), t(np.full(N_PAD, 1e-6)),
                torch.as_tensor(mask, device=device))
        return lambda: linalg.batched_lml(kernel, *args, n_real=N_OBS)

    gpu = run(dev, torch.float32)
    lml = gpu().double().cpu().numpy()
    ref = run("cpu", torch.float64)().numpy()
    err = np.abs(lml - ref)
    # float32 LML error at this conditioning: measured ~2e-4 on the CPU
    # f32 path; the bound leaves a wide margin for another summation order
    bound = 1e-5 * np.maximum(1.0, np.abs(ref))
    ok = bool(np.isfinite(lml).all() and (err <= bound).all())
    ms = cuda_ms(gpu, reps=10)
    if not ok:
        raise AssertionError("batched LML on the card disagrees with float64")
    # LOWER_GRAM on (K2) against off (K1): bit for bit, shared X and
    # per-walker warped X (each walker's own warp of the bench inputs)
    from bask_tpu_torch.models import warping
    from bask_tpu_torch.ops import gram

    warp_params = 0.3 * np.random.RandomState(2).randn(2, N_WALKERS, N_DIM)
    Xwarp = warping.warp(
        torch.as_tensor(padded(X), dtype=torch.float32, device=dev),
        *(torch.as_tensor(p, dtype=torch.float32, device=dev) for p in warp_params),
    )
    lower = {}
    for mode, Xin in (("shared X", padded(X)), ("warped per-walker X", Xwarp)):
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (thetas, Xin, yp, np.full(N_PAD, 1e-6))]
        args.append(torch.as_tensor(mask, device=dev))
        off = linalg.batched_lml(kernel, *args, n_real=N_OBS)
        k2 = gram.fused_masked_gram_lower_batch.launches
        gram.LOWER_GRAM = "on"
        try:
            on = linalg.batched_lml(kernel, *args, n_real=N_OBS)
        finally:
            gram.LOWER_GRAM = "off"
        lower[mode] = {
            "bit_equal": bool(torch.equal(on, off)),
            "finite": bool(torch.isfinite(off).all()),
            "k2_launched": gram.fused_masked_gram_lower_batch.launches > k2,
        }
    report("phase 5 batched LML", shape=[N_WALKERS, N_PAD, N_DIM],
           lml_range=[float(lml.min()), float(lml.max())],
           max_abs_err=float(err.max()), bound=float(bound.min()), ok=ok, ms=ms,
           lower_gram=lower)
    if not all(all(v.values()) for v in lower.values()):
        raise AssertionError(f"LML with LOWER_GRAM on differs from off: {lower}")


def _kernel_counters():
    from bask_tpu_torch.ops import chol_base, gram

    return {
        "K1": gram.fused_masked_gram_batch,
        "K2": gram.fused_masked_gram_lower_batch,
        "K3": chol_base.chol_inv_base,
    }


def _drive_optimizer(dev, gp_kwargs=None):
    """Build the Optimizer on the bench problem, zero the launch counts,
    then a cold tell of N_OBS points and three warm ask/tell rounds (PVRS).
    Returns (optimizer, cold seconds, the cold tell's R-hat result, warm
    seconds, asks)."""
    import torch

    from bask_tpu_torch import Optimizer

    X, _ = bench_dataset()

    def objective(x, rng=np.random.RandomState(2)):
        return float(np.sum((np.asarray(x) - 0.5) ** 2) + 0.05 * rng.randn())

    y = [objective(x) for x in X]
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * N_DIM, n_points=N_CAND, n_initial_points=N_OBS,
        random_state=0, gp_kwargs=gp_kwargs, device=dev, dtype=torch.float32,
        gp_sample_kwargs={"max_extensions": COLD_LEGS, "extension_steps": 300},
    )
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in _kernel_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    opt.tell(X.tolist(), y)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rhat = opt.gp.until_rhat_result_
    warm_s, asks = [], []
    for _ in range(3):
        x = opt.ask()
        asks.append(x)
        t0 = time.perf_counter()
        opt.tell(x, objective(x))
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    return opt, cold_s, rhat, warm_s, asks


def _consensus_lml_f64(gp):
    """The consensus LML recomputed by the port's float64 CPU path on the
    posterior's own (warped, where warping) data."""
    import torch

    from bask_tpu_torch.models import gp as gpc

    d = gp._post_data
    data64 = gpc.make_data(
        *(t.detach().cpu().double() for t in (d.X, d.y, d.alpha_diag)),
        d.mask.cpu(), d.y_mean, d.y_std,
    )
    return float(gpc.log_marginal_likelihood(
        gp._spec, torch.as_tensor(gp.theta, dtype=torch.float64), data64
    ))


def phase_optimizer(dev):
    """The Optimizer's main path on the card (K1 gram, K3 bases)."""
    import torch

    from bask_tpu_torch import ExpectedImprovement
    from bask_tpu_torch.acquisition import evaluate_acquisitions_fused

    opt, cold_s, rhat, warm_s, asks = _drive_optimizer(dev)
    grid = np.random.RandomState(3).uniform(size=(N_CAND, N_DIM))
    t0 = time.perf_counter()
    ei = evaluate_acquisitions_fused(
        grid, gpr=opt.gp, acq=ExpectedImprovement(), n_samples=N_WALKERS
    )
    torch.cuda.synchronize()
    ei_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _kernel_counters().items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    gp = opt.gp
    acceptance = gp.n_accepted_ / gp.n_proposals_
    lml = gp.log_marginal_likelihood_value_
    lml64 = _consensus_lml_f64(gp)
    inside = all(0.0 <= v <= 1.0 for x in asks for v in x)
    report(
        "phase 6 optimizer",
        cold_tell_s=cold_s, rhat=rhat, warm_tell_s=warm_s,
        ei_pass_s=ei_s, last_timings=opt.last_timings_, acceptance=acceptance,
        consensus_lml=lml, consensus_lml_f64=lml64,
        ei_shape=list(ei.shape), ei_finite=bool(np.isfinite(ei).all()),
        asks_inside_bounds=inside, launches=launches, peak_mem_gb=peak_gb,
    )
    checks = {
        "K1 launched": launches["K1"] > 0,
        "K3 launched": launches["K3"] > 0,
        "consensus LML finite": math.isfinite(lml),
        "consensus LML matches f64": abs(lml - lml64) <= 1e-5 * max(1.0, abs(lml64)),
        "acceptance in (0.05, 0.99)": 0.05 < acceptance < 0.99,
        "asks inside bounds": inside,
        "EI finite (1, 500)": ei.shape == (1, N_CAND) and bool(np.isfinite(ei).all()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"optimizer phase failed: {failed}")
    return opt


def phase_warped_optimizer(dev):
    """This slice's main path: the Optimizer with input warping and
    LOWER_GRAM on, so the chain's grams come from K2 on per-walker warped
    X; then one pass of each of the eight acquisitions. Returns the
    launch counts of the phase."""
    import torch

    from bask_tpu_torch.acquisition import evaluate_acquisitions_fused
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.optimizer import ACQUISITION_FUNC

    gram.LOWER_GRAM = "on"
    try:
        opt, cold_s, rhat, warm_s, asks = _drive_optimizer(dev, {"warp_inputs": True})
        grid = opt._candidate_grid()  # warp-density candidates
        acq_s, acq_ok = {}, {}
        for name, acq in sorted(ACQUISITION_FUNC.items()):
            t0 = time.perf_counter()
            vals = evaluate_acquisitions_fused(
                grid, gpr=opt.gp, acq=acq, n_samples=N_WALKERS // 5, random_state=5
            )
            torch.cuda.synchronize()
            acq_s[name] = time.perf_counter() - t0
            acq_ok[name] = vals.shape == (1, N_CAND) and bool(np.isfinite(vals).all())
        launches = {k: fn.launches for k, fn in _kernel_counters().items()}
    finally:
        gram.LOWER_GRAM = "off"
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    gp = opt.gp
    acceptance = gp.n_accepted_ / gp.n_proposals_
    lml = gp.log_marginal_likelihood_value_
    lml64 = _consensus_lml_f64(gp)
    inside = all(0.0 <= v <= 1.0 for x in asks for v in x)
    report(
        "phase 7 warped optimizer",
        cold_tell_s=cold_s, rhat=rhat, warm_tell_s=warm_s,
        last_timings=opt.last_timings_, acceptance=acceptance,
        acquisition_pass_s=acq_s, acquisition_finite=acq_ok,
        consensus_lml=lml, consensus_lml_f64=lml64,
        warp_alphas=gp.warp_alphas_.tolist(), warp_betas=gp.warp_betas_.tolist(),
        chain_dims=int(gp.chain_.shape[1]), asks_inside_bounds=inside,
        launches=launches, peak_mem_gb=peak_gb,
    )
    checks = {
        "K1 launched": launches["K1"] > 0,
        "K2 launched": launches["K2"] > 0,
        "K3 launched": launches["K3"] > 0,
        "consensus LML finite": math.isfinite(lml),
        "consensus LML matches f64": abs(lml - lml64) <= 1e-5 * max(1.0, abs(lml64)),
        "chain carries 2d warp dims": gp.chain_.shape[1] == gp._spec.n_theta + 2 * N_DIM,
        "asks inside bounds": inside,
        "every acquisition finite": all(acq_ok.values()) and len(acq_ok) == 8,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"warped optimizer phase failed: {failed}")
    return launches


def _counts():
    return {k: fn.launches for k, fn in _kernel_counters().items()}


def _since(before):
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def _uncounted(fn):
    """``fn()`` with the launch counts put back as they were after it: a
    launch made to check a result is not one of the path's."""
    saved = _counts()
    try:
        return fn()
    finally:
        for k, f in _kernel_counters().items():
            f.launches = saved[k]


def batch_dataset():
    """bench_batch_ask.py's data (seed 0): X uniform in [0, 1]^15, a noisy
    bowl (raw; the GP normalizes y)."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(BATCH_OBS, N_DIM))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(BATCH_OBS)
    return X, y


def _gram_at(dev, kernel, B, thetas_of, X):
    """K1 at (B, BATCH_PAD, BATCH_PAD) on the batch data for ``B`` chain
    rows, held to its float64 plain version on 4 rows (4e-6 max|K|, the
    bound of phase 2); the wrapper's and the kernel's time."""
    import torch

    from bask_tpu_torch.ops import gram

    spec = gram.match_fusable(kernel)
    th = thetas_of(B)
    Xd = torch.tensor(X, dtype=torch.float32, device=dev)
    alpha = torch.full((BATCH_PAD,), 1e-6, dtype=torch.float32, device=dev)
    args = (spec, th, Xd, alpha, BATCH_OBS)
    K = gram.fused_masked_gram_batch(*args)
    rows = [0, B // 3, 2 * B // 3, B - 1]
    ref = gram.fused_masked_gram_plain(
        spec, th[rows].double(), Xd.double(), alpha.double(), BATCH_OBS
    )
    err = float((K[rows].double() - ref).abs().max())
    bound_err = 4e-6 * float(ref.abs().max())
    del K, ref
    ms = cuda_ms(lambda: gram.fused_masked_gram_batch(*args), reps=10)
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(*args), reps=3)
    _, ops = profiled(lambda: gram.fused_masked_gram_batch(*args), reps=5)
    bound, by = gram_bound(B, BATCH_PAD, N_DIM)
    out = {"shape": [B, BATCH_PAD, BATCH_PAD], "max_abs_err": err, "err_bound": bound_err,
           "ms": ms, "kernel_alone_us": kernel_us(ops, "gram_kernel"), "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    if not err <= bound_err:
        raise AssertionError(f"K1 disagrees with its plain version: {out}")
    return out


def _factor_ab(dev, Kp, yb):
    """The (B, 1024, 1024) factorization + forward solve + LML terms:
    blocked with K3 bases against cholesky_ex + solve_triangular, in turns
    (blocked, library, library, blocked)."""
    import torch

    from bask_tpu_torch.ops import chol_base
    from bask_tpu_torch.ops import fast_cholesky as fc

    def blocked():
        return fc.fast_lml_terms(Kp, yb)[1:]

    def library():
        L, _ = torch.linalg.cholesky_ex(Kp)
        w = torch.linalg.solve_triangular(L, yb[..., None], upper=False)[..., 0]
        return torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1), (w * w).sum(-1)

    before = chol_base.chol_inv_base.launches
    terms = [t.double() for t in blocked()]
    k3 = chol_base.chol_inv_base.launches - before
    ref = [t.double() for t in library()]
    agree = max(float(((a - b) / b.abs().clamp(min=1.0)).abs().max()) for a, b in zip(terms, ref))
    turns = {"blocked": [], "cholesky_ex": []}
    for name in ("blocked", "cholesky_ex", "cholesky_ex", "blocked"):
        turns[name].append(cuda_ms(blocked if name == "blocked" else library, reps=5))
    out = {"shape": list(Kp.shape), "ms_turns": turns, "k3_launches": k3,
           "device_ops": {"blocked": profiled(blocked)[0], "cholesky_ex": profiled(library)[0]},
           "rel_diff_vs_cholesky_ex": agree}
    if not agree <= 1e-4:
        raise AssertionError(f"the (·, 1024, 1024) factorizations disagree: {out}")
    return out


def _draws_f64(gp, spec, rows, rand, Xq):
    """The pathwise draws of ``rows`` (one each) recomputed in float64:
    the plain gram and cholesky_ex, the same randoms, one draw at a time."""
    import torch

    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import gram

    d = gp._data
    data = d._replace(X=d.X.double(), y=d.y.double(), alpha_diag=d.alpha_diag.double())
    out, conds = [], []
    for i in range(rows.shape[0]):
        theta = rows[i : i + 1].double()
        K = gram.fused_masked_gram_plain(spec, theta, data.X, data.alpha_diag, BATCH_OBS)
        L, _ = torch.linalg.cholesky_ex(K)
        ev = torch.linalg.eigvalsh(K[0, :BATCH_OBS, :BATCH_OBS])
        conds.append(float(ev[-1] / ev[0]))

        def solve(R, L=L):
            return torch.cholesky_solve(R, L)

        part = pathwise.PathwiseRandoms(*(None if r is None else r[i : i + 1].double() for r in rand))
        out.append(pathwise._draw_values(spec, theta, data.X, data, solve, Xq.double(), part)[0, :, 0])
    return torch.stack(out), conds


def _draws_tf32(gp, spec, rows, rand, Xq):
    """The control the draws' limit must reject: the draws of ``rows``
    (one each) with the gram and the factor in float32 as the path makes
    them, then the features, the blocked solves and k(x, X) v as TF32
    matmuls (10-bit mantissas). With the factorization in TF32 as well,
    the factor of these grams (cond K ~1e5) is NaN."""
    import torch

    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import fast_cholesky as fc
    from bask_tpu_torch.ops import gram

    d = gp._data
    L, invs = fc.block_cholesky(
        gram.fused_masked_gram_batch(spec, rows, d.X, d.alpha_diag, BATCH_OBS)
    )

    def solve(R):
        return fc.block_solve_upper_mat(L, invs, fc.block_solve_lower_mat(L, invs, R))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        return pathwise._draw_values(spec, rows, d.X, d, solve, Xq, rand)[..., 0].double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def phase_batch_ask(dev):
    """BASELINE configs[4] through the Optimizer: a cold batch tell of
    1,000 points (256 walkers, EI over 65,536 candidates), then two
    256-point batch asks; K1 at the path's shapes, the factorization A/B
    and 4 draws against float64. Returns (launches, K1 and K3 extras)."""
    import torch

    from bask_tpu_torch import Optimizer
    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    X, y = batch_dataset()
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * N_DIM, (0.05, 2.0), nu=2.5)
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * N_DIM, n_points=BATCH_CAND, n_initial_points=BATCH_OBS,
        gp_kernel=kernel, gp_kwargs={"normalize_y": True}, acq_func="ei",
        gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": BATCH_WALKERS},
        random_state=0, device=dev,
    )
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in _kernel_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    opt.tell(X.tolist(), y.tolist(), n_samples=5, gp_samples=BATCH_WALKERS, gp_burnin=10)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    per_step = {"tell": _counts()}
    ask_s, points = [], []
    for i in range(2):
        before = _counts()
        t0 = time.perf_counter()
        points.append(np.asarray(opt.ask(n_points=BATCH_K)))
        torch.cuda.synchronize()
        ask_s.append(time.perf_counter() - t0)
        per_step[f"ask {i + 1}"] = _since(before)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # where an ask's time goes: a fourth ask under the profiler, after a
    # third as its warm-up (neither in the counts or the timings above):
    # busy share = the ask's summed kernel time over the host wall time of
    # that ask alone, top kernels
    _, ops, wall_s = profiled(lambda: opt.ask(n_points=BATCH_K), reps=1, wall=True)
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ask_profile = {"device_ops": len(ops), "device_us": sum(by_name.values()),
                   "wall_us": 1e6 * wall_s, "busy_share": sum(by_name.values()) / (1e6 * wall_s),
                   "top_kernels_us": [[k[:60], v] for k, v in top]}
    distinct = [len({tuple(p) for p in pts}) for pts in points]
    inside = all(bool(((pts >= 0.0) & (pts <= 1.0)).all()) for pts in points)

    # 4 of 256 draws against float64, on the grid and rows an ask uses
    gp = opt.gp
    spec = gram.match_fusable(gp._spec)
    grid = gp._tensor(np.random.RandomState(8).uniform(size=(BATCH_CAND, N_DIM)))
    rows = gp._tensor(gp.chain_[np.random.RandomState(9).choice(len(gp.chain_), BATCH_K)])
    rand = gp._pathwise_randoms(spec, 9, 1024, 1, batch=(BATCH_K,))
    idx, draws32 = pathwise.pathwise_topk_hyper(
        spec, rows, gp._data, grid, rand, 0, 8, n_real=BATCH_OBS, keep=CHECK_DRAWS
    )
    keep = list(CHECK_DRAWS)
    sub = pathwise.PathwiseRandoms(*(None if r is None else r[keep] for r in rand))
    draws64, conds = _draws_f64(gp, spec, rows[keep], sub, grid)
    err = (draws32.double() - draws64).abs().max(dim=1).values
    scale = draws64.abs().max(dim=1).values
    # the limit, from readings: DRAW_REL_TOL x the draw's scale. The
    # worst-case first-order bound, eps32 (3n + cond K) x scale (3n eps32
    # from the factorization's and the n-term sums' rounding, eps32 cond K
    # from the solve amplifying K's rounding), is reported beside it only
    eps32 = float(np.finfo(np.float32).eps)
    tol = DRAW_REL_TOL * scale
    upper = torch.tensor([eps32 * (3 * BATCH_OBS + c) for c in conds], dtype=torch.float64,
                         device=dev) * scale
    top1 = idx[keep, 0]
    gap = draws64.gather(1, top1[:, None])[:, 0] - draws64.min(dim=1).values
    draws_ok = bool((err <= tol).all() and (gap <= tol).all())
    err_tf32 = (_draws_tf32(gp, spec, rows[keep], sub, grid) - draws64).abs().max(dim=1).values
    control_fails = bool((~(err_tf32 <= tol)).all())  # NaN misses too

    # K1 alone at the path's shapes and the factorization A/B at 256
    theta_rows = gp.chain_[np.random.RandomState(10).choice(len(gp.chain_), BATCH_WALKERS)]
    Xp = np.full((BATCH_PAD, N_DIM), 0.5)
    Xp[:BATCH_OBS] = X

    def thetas_of(B):
        return torch.tensor(theta_rows[:B], dtype=torch.float32, device=dev)

    k1 = [_gram_at(dev, gp._spec, B, thetas_of, Xp) for B in (BATCH_WALKERS, BATCH_WALKERS // 2)]
    Kp = gram.fused_masked_gram_batch(
        spec, thetas_of(BATCH_WALKERS), gp._data.X, gp._data.alpha_diag, BATCH_OBS
    )
    factor = _factor_ab(dev, Kp, gp._data.y.expand(Kp.shape[:-1]))
    del Kp
    report(
        "phase 8 batch ask", n=BATCH_OBS, n_pad=BATCH_PAD, walkers=BATCH_WALKERS,
        candidates=BATCH_CAND, batch=BATCH_K, cold_tell_s=cold_s, ask_s=ask_s,
        candidates_x_draws_per_s=[BATCH_CAND * BATCH_K / t for t in ask_s],
        last_timings=opt.last_timings_, distinct_points=distinct, inside_bounds=inside,
        launches=per_step, peak_mem_gb=peak_gb, chunk_bytes=pathwise.CHUNK_BYTES,
        ask_profile=ask_profile,
        k1=k1, factorization_ab=factor,
        draws_f64={"draws": keep, "max_abs_err": err.tolist(), "scale": scale.tolist(),
                   "rel_err": (err / scale).tolist(), "tol": tol.tolist(),
                   "upper_bound_cond_K": upper.tolist(), "cond_K": conds,
                   "top1_gap_to_f64_min": gap.tolist(), "ok": draws_ok,
                   "tf32_control_max_abs_err": err_tf32.tolist(),
                   "tf32_control_fails": control_fails},
    )
    checks = {
        "256 distinct points per ask": distinct == [BATCH_K, BATCH_K],
        "points inside bounds": inside,
        "K1 ran in each ask": all(per_step[f"ask {i}"]["K1"] >= 1 for i in (1, 2)),
        "K3 8 per factorization in each ask": all(
            per_step[f"ask {i}"]["K3"] == 8 * per_step[f"ask {i}"]["K1"] for i in (1, 2)),
        "factorization: 8 K3 launches": factor["k3_launches"] == 8,
        "4 draws agree with float64": draws_ok,
        "the TF32 control misses the draws' limit": control_fails,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"batch-ask phase failed: {failed}")
    k3_ab = {"shape": factor["shape"], "blocked_ms": float(np.median(factor["ms_turns"]["blocked"])),
             "library_ms": float(np.median(factor["ms_turns"]["cholesky_ex"])),
             "launches_per_factorization": factor["k3_launches"]}
    return launches, k1, k3_ab


def phase_stopping_polish(opt, dev):
    """Phase 6's fitted Optimizer: a warm tell with the PVRS polish (800
    kept samples, so the chain has the 8 kept steps the diagnostics
    need), the diagnostics, the stopping rules, a warm tell with the EI
    polish, and the legacy dispatcher against the fused pass. Returns the
    launch counts of the two polished tells."""
    import torch

    from bask_tpu_torch import acquisition as acq_mod
    from bask_tpu_torch.acquisition import evaluate_acquisitions, evaluate_acquisitions_fused
    from bask_tpu_torch.optimizer import ACQUISITION_FUNC

    calls = []
    polish = acq_mod.polish_acquisition

    def recorded(X0, **kw):
        k1 = _counts()["K1"]
        out = polish(X0, **kw)
        calls.append({"X0": X0, "kw": kw, "out": out, "k1": _counts()["K1"] - k1})
        return out

    def objective(x, rng=np.random.RandomState(11)):
        return float(np.sum((np.asarray(x) - 0.5) ** 2) + 0.05 * rng.randn())

    def polished_tell(acq, **tell_kw):
        opt.acq_func = ACQUISITION_FUNC[acq]
        x = opt.ask()
        t0 = time.perf_counter()
        opt.tell(x, objective(x), **tell_kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        call = calls[-1]
        # the starts' own values under the same draws (the same seed, 0
        # steps); a separate call, so allow its last bits to differ, and a
        # check, so its launches are not counted
        _, v0 = _uncounted(lambda: polish(call["X0"], **{**call["kw"], "n_steps": 0}))
        xb, vb = call["out"]
        nxt = np.asarray(opt.ask())
        return {"tell_s": seconds, "start_values": v0.tolist(), "polished_values": vb.tolist(),
                "no_lower": bool((vb >= v0 - 1e-6 * np.abs(v0)).all()),
                # the best value is kept from t = 0, so "no lower" holds for
                # any gradient; a climb shows the gradient leads uphill
                "climbs": bool((vb > v0 + 1e-3 * np.abs(v0)).any()),
                "next_inside_bounds": bool(((nxt >= 0.0) & (nxt <= 1.0)).all()),
                "k1_in_polish": call["k1"]}

    opt.acq_polish = 20
    acq_mod.polish_acquisition = recorded
    try:
        for fn in _kernel_counters().values():
            fn.launches = 0
        pvrs = polished_tell("pvrs", gp_samples=800)
        t0 = time.perf_counter()
        diag = opt.gp.mcmc_diagnostics()  # the 8 kept steps of this tell
        t_diag = time.perf_counter() - t0
        ei = polished_tell("ei", n_samples=10)
        launches = _counts()
    finally:
        acq_mod.polish_acquisition = polish
        opt.acq_polish = 0
    width = opt.gp.chain_.shape[1]
    diag_ok = all(
        v.shape == (width,) and bool(np.isfinite(v).all())
        for v in (diag["rhat"], diag["ess"], diag["autocorr_time"])
    )
    t0 = time.perf_counter()
    probs = opt.probability_of_optimality([0.1, 1.0], random_state=12)
    t_prob = time.perf_counter() - t0
    t0 = time.perf_counter()
    intervals = opt.optimum_intervals(random_state=13)
    t_int = time.perf_counter() - t0
    gap_kw = dict(n_probabilities=20, n_space_samples=200, n_gp_samples=100, n_random_starts=20)
    t0 = time.perf_counter()
    gap = opt.expected_optimality_gap(random_state=14, **gap_kw)
    t_gap = time.perf_counter() - t0
    grid = np.random.RandomState(15).uniform(size=(N_CAND, N_DIM))
    equal = {}
    for name in ("ei", "lcb", "ts"):
        acq = ACQUISITION_FUNC[name]
        legacy = evaluate_acquisitions(grid, opt.gp, (acq,), n_samples=10, random_state=16)
        fused = evaluate_acquisitions_fused(grid, opt.gp, acq, n_samples=10, random_state=16)
        equal[name] = bool(np.array_equal(legacy, fused))
    intervals_ok = len(intervals) == N_DIM and all(
        iv.ndim == 2 and iv.shape[1] == 2 and bool(np.isfinite(iv).all()) for iv in intervals
    )
    report(
        "phase 9 stopping, diagnostics, polish, legacy dispatch",
        pvrs_polish=pvrs, ei_polish=ei, launches=launches,
        diagnostics={"rhat_max": float(np.max(diag["rhat"])), "ess_min": float(np.min(diag["ess"])),
                     "autocorr_time_max": float(np.max(diag["autocorr_time"])),
                     "acceptance": diag["acceptance"], "n_steps": diag["n_steps"],
                     "n_walkers": diag["n_walkers"], "width": width, "finite": diag_ok},
        probability_of_optimality={"thresholds": [0.1, 1.0], "p": probs},
        optimum_intervals_modes=[len(iv) for iv in intervals],
        expected_optimality_gap=gap, gap_reduced_to=gap_kw,
        seconds={"diagnostics": t_diag, "probability_of_optimality": t_prob,
                 "optimum_intervals": t_int, "expected_optimality_gap": t_gap},
        legacy_equals_fused=equal,
    )
    checks = {
        "diagnostics finite, chain width": diag_ok,
        "probabilities monotone": probs[0] <= probs[1],
        "optimum intervals finite": intervals_ok,
        "gap finite": math.isfinite(gap),
        "PVRS polish no lower than its start": pvrs["no_lower"],
        "EI polish no lower than its start": ei["no_lower"],
        "PVRS polish climbs from one start at least": pvrs["climbs"],
        "EI polish climbs from one start at least": ei["climbs"],
        "polished points inside bounds": pvrs["next_inside_bounds"] and ei["next_inside_bounds"],
        "K1 ran in the EI polish": ei["k1_in_polish"] > 0,
        "legacy == fused": all(equal.values()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9 failed: {failed}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("1", phase_device)
    k1 = timed("2", phase_gram, dev)
    k2 = timed("3", phase_lower_gram, dev)
    k3 = timed("4", phase_chol, dev)
    timed("4b", phase_factor_ab, dev)
    timed("5", phase_lml, dev)
    opt = timed("6", phase_optimizer, dev)
    by_path = {"phase 7 warped tell": timed("7", phase_warped_optimizer, dev)}
    by_path["phase 8 batch ask"], k1_batch, k3_batch = timed("8", phase_batch_ask, dev)
    by_path["phase 9 polish"] = timed("9", phase_stopping_polish, opt, dev)
    report("phase seconds", **seconds, total=sum(seconds.values()))

    def launches(key):
        return {"launches": sum(c[key] for c in by_path.values()),
                "launches_by_path": {p: c[key] for p, c in by_path.items()}}

    table = [
        {"name": "K1 fused masked gram", "route": "cuda",
         "source": "bask_tpu_torch/csrc/gram.cu",
         "replaces": "bask_tpu/ops/pallas_gram.py:193",
         **launches("K1"), **k1, "at_batch_ask_shapes": k1_batch},
        {"name": "K2 fused masked gram, lower 128-tiles", "route": "cuda",
         "source": "bask_tpu_torch/csrc/gram.cu",
         "replaces": "bask_tpu/ops/pallas_gram.py:264",
         **launches("K2"), **k2},
        {"name": "K3 base Cholesky + inverse", "route": "cuda",
         "source": "bask_tpu_torch/csrc/chol_base.cu",
         "replaces": "bask_tpu/ops/pallas_chol_base.py:105",
         **launches("K3"), **k3, "in_batch_ask_factorization": k3_batch},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
