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
   tell with an EI pass over 65,536 candidates (its (128 | 256, 1024,
   1024) grams from K4, to which ``gram._K4_SHAPES`` sends them), then
   ``ask(n_points=256)`` twice (pathwise Thompson top-k, the rows'
   (256, 1024, 1024) gram from K4 and its blocked factorization with K3
   bases); the grams at (256, 1024, 1024) and (128, 1024, 1024) through
   the route (K4) and from K1 itself, each alone and against its float64
   plain version on a few rows,
   the (256, 1024, 1024) factorization A/B against ``cholesky_ex``, and
   4 of 256 pathwise draws held to a float64 recomputation;
9. on phase 6's fitted Optimizer (n = 500, d = 15): a warm tell with the
   PVRS polish and one with the EI polish (each polished value no lower
   than its start under the same draws), the chain's diagnostics, the
   three stopping diagnostics, and the legacy dispatcher bit-equal to
   the fused pass;
10. the fit options at the north-star shape (n = 500, d = 15, 100
   walkers, float32): (a) a cold fit with the Laplace chain init, the
   MAP warm start with 2 restarts and frozen SciPy priors (lifted to
   torch, no host adapter); (b) the device L-BFGS warm start against
   SciPy's L-BFGS-B from the same 3 starts, then a fit with it; (c) a
   fit warm-started on a 128-point subsample; (d) fits with
   ``Matern(nu=1.7)`` and with ``Exponentiation`` (plain grams: K1 not
   launched, K3 bases); (e) on phase 6's model, prediction gradients in
   float64 against central differences; (f) ``save_optimizer`` /
   ``load_optimizer`` of phase 6's Optimizer on the card; (g) short
   chains with opaque priors (a NumPy and a SciPy lambda) through the
   host adapter, timed beside the same chain with the lifted prior. Each
   fit's consensus LML is held to float64 at phase 6's bound or, where
   cond(K) makes float32 miss that, at twice the error of the float32
   ``cholesky_ex`` path at the same theta;
11. K4 (the walker-batched gram, ``csrc/gram.cu``): against its plain
   version in float64 at (50, 512, 512), d = 15, for all four nu; bit-equal
   to K1 at (50, 512, 512) with 2 and 5 walkers per block, at
   (256, 1024, 1024) with 2, 4 and 8 and at (128, 1024, 1024) with 4 and
   8, for the spec variants; one device operation per call; its device
   time alone next to K1's at (50, 512, 512), (128, 1024, 1024) and
   (256, 1024, 1024), in turns; registers from nvcc's report and resident
   blocks per SM from CUDA's occupancy calculator; the batched LML at each
   shape of ``gram._K4_SHAPES``, bit-equal to K1's; then the path that
   reaches K4,
   ``scripts/bench_gram_wb.run`` (2 and 5 walkers per block). It runs
   after phase 4b, with the other kernel phases.

The ``launches`` of the kernel table sum phases 7-11, each counted from 0
just before the phase drives its path and read just after it.

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
        "K4": gram.fused_masked_gram_wb_batch,
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


def _lml_plain32_and_cond(gp):
    """(the consensus LML by the float32 plain path on the card: the spec's
    gram, ``cholesky_ex`` and a triangular solve, no K1 or K3; cond(K) of
    the unpadded gram in float64)."""
    import torch

    from bask_tpu_torch.models import bayesgpr as tbg
    from bask_tpu_torch.ops.linalg import masked_gram

    d = gp._post_data
    theta = gp._tensor(gp.theta)
    plain32 = -float(tbg._neg_lml_plain(gp._spec, theta, d))
    K = masked_gram(gp._spec, theta.double(), d.X.double(), d.alpha_diag.double(), d.mask)
    n = int(d.mask.sum())
    ev = torch.linalg.eigvalsh(K[:n, :n])
    return plain32, float(ev[-1] / ev[0])


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


def _gram_at(dev, kernel, B, thetas_of, X, routed):
    """The gram at (B, BATCH_PAD, BATCH_PAD) on the batch data for ``B``
    chain rows: through ``gram.fused_masked_gram_batch`` as the path calls
    it (``routed``: K4 at the shapes of ``gram._K4_SHAPES``), or K1 itself.
    Held to its float64 plain version on 4 rows (4e-6 max|K|, the bound of
    phase 2); the wrapper's and the kernel's time."""
    import torch

    from bask_tpu_torch.ops import gram

    spec = gram.match_fusable(kernel)
    th = thetas_of(B)
    Xd = torch.tensor(X, dtype=torch.float32, device=dev)
    alpha = torch.full((BATCH_PAD,), 1e-6, dtype=torch.float32, device=dev)
    args = (spec, th, Xd, alpha, BATCH_OBS)
    fn = gram.fused_masked_gram_batch if routed else gram._k1_gram_batch
    counters = _kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    K = fn(*args)
    launched = [k for k, f in counters.items() if f.launches > before[k]]
    rows = [0, B // 3, 2 * B // 3, B - 1]
    ref = gram.fused_masked_gram_plain(
        spec, th[rows].double(), Xd.double(), alpha.double(), BATCH_OBS
    )
    err = float((K[rows].double() - ref).abs().max())
    bound_err = 4e-6 * float(ref.abs().max())
    del K, ref
    ms = cuda_ms(lambda: fn(*args), reps=10)
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(*args), reps=3)
    _, ops = profiled(lambda: fn(*args), reps=5)
    bound, by = gram_bound(B, BATCH_PAD, N_DIM)
    name = "gram_wb_kernel" if launched == ["K4"] else "gram_kernel"
    out = {"shape": [B, BATCH_PAD, BATCH_PAD], "kernel": launched, "max_abs_err": err,
           "err_bound": bound_err, "ms": ms, "kernel_alone_us": kernel_us(ops, name),
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}
    if not err <= bound_err:
        raise AssertionError(f"{launched} disagrees with its plain version: {out}")
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
    blocked_ops, ops = profiled(blocked, reps=5)
    # one K3 launch factors and inverts B 128-wide diagonal blocks: read
    # their lower triangles, write L and L^-1 (phase 4's count); its plain
    # version and the PyTorch pair on the first diagonal block
    B, m = Kp.shape[0], fc._BASE
    k3_bound, k3_by = bound_ms(4 * B * (m * (m + 1) // 2 + 2 * m * m), B * 2 * m**3 / 3)
    A = Kp[:, :m, :m].contiguous()
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(B, m, m)

    def library_base():
        L, _ = torch.linalg.cholesky_ex(A)
        return L, torch.linalg.solve_triangular(L, eye, upper=False)

    out = {"shape": list(Kp.shape), "ms_turns": turns, "k3_launches": k3,
           "device_ops": {"blocked": blocked_ops, "cholesky_ex": profiled(library)[0]},
           "k3_launch": {"shape": [B, m, m], "alone_us": kernel_us(ops, "chol_inv_kernel"),
                         "bound_us": 1e3 * k3_bound, "bound_by": k3_by,
                         "plain_ms": cuda_ms(lambda: chol_base.chol_inv_plain(A), reps=3),
                         "library_ms": cuda_ms(library_base, reps=5)},
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
    256-point batch asks; the routed grams (K4) and K1 itself at the
    path's shapes, the factorization A/B and 4 draws against float64.
    Returns (launches, K1, K4 and K3 extras)."""
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

    # the grams the path launches (K4 through the route) and K1 itself,
    # each against float64
    shapes = (BATCH_WALKERS, BATCH_WALKERS // 2)
    k4 = [_gram_at(dev, gp._spec, B, thetas_of, Xp, routed=True) for B in shapes]
    k1 = [_gram_at(dev, gp._spec, B, thetas_of, Xp, routed=False) for B in shapes]
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
        k4=k4, k1=k1, factorization_ab=factor,
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
        # the rows' (256, 1024, 1024) gram: K4, by gram._K4_SHAPES
        "K4 ran in each ask": all(per_step[f"ask {i}"]["K4"] >= 1 for i in (1, 2)),
        "K3 8 per factorization in each ask": all(
            per_step[f"ask {i}"]["K3"] == 8 * (per_step[f"ask {i}"]["K1"] + per_step[f"ask {i}"]["K4"])
            for i in (1, 2)),
        "the route launched K4 at both shapes": all(r["kernel"] == ["K4"] for r in k4),
        "K1 itself launched at both shapes": all(r["kernel"] == ["K1"] for r in k1),
        "factorization: 8 K3 launches": factor["k3_launches"] == 8,
        "K3 launch timed under the profiler": factor["k3_launch"]["alone_us"] is not None,
        "4 draws agree with float64": draws_ok,
        "the TF32 control misses the draws' limit": control_fails,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"batch-ask phase failed: {failed}")
    k3_ab = {"shape": factor["shape"], "blocked_ms": float(np.median(factor["ms_turns"]["blocked"])),
             "library_ms": float(np.median(factor["ms_turns"]["cholesky_ex"])),
             "launches_per_factorization": factor["k3_launches"], "per_launch": factor["k3_launch"]}
    return launches, k1, k4, k3_ab


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


def phase_fit_options(opt, dev, progress=True):
    """Phase 10: the fit options at the north-star shape, then checks on
    phase 6's Optimizer (``opt``). The fits show ``fit``'s progress bar
    unless ``progress`` is False. Returns the launch counts of (a)-(d)
    and (g), each fit counted from 0."""
    import tempfile
    import warnings

    import scipy.stats as sps
    import torch

    from bask_tpu_torch import BayesGPR
    from bask_tpu_torch.models import bayesgpr as tbg
    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.utils import serialization

    X, y = bench_dataset()
    kernel = bench_kernel(bk)
    # frozen SciPy priors on the log parameters: amplitude, 15 lengthscales,
    # noise (the port lifts these to torch; no host adapter)
    lifted = ([sps.norm(0.0, 1.0).logpdf] + [sps.norm(math.log(0.3), 1.0).logpdf] * N_DIM
              + [sps.norm(math.log(0.05), 2.0).logpdf])
    fit_kw = dict(n_desired_samples=10 * N_WALKERS, n_walkers_per_thread=N_WALKERS, n_burnin=10,
                  warn_rhat=None, progress=progress)
    by_fit, seconds, out = {}, {}, {}

    def run_fit(name, gp_kernel, priors=None, steps=fit_kw, **gp_kw):
        gp = BayesGPR(gp_kernel, random_state=0, device=dev, **gp_kw)
        ml2_s = []
        warm_start = gp._ml2_optimize

        def timed_warm_start():
            t0 = time.perf_counter()
            theta = warm_start()
            ml2_s.append(time.perf_counter() - t0)
            return theta

        gp._ml2_optimize = timed_warm_start
        before = _counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gp.fit(X, y, priors=priors, **steps)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        by_fit[name] = _since(before)
        lml, lml64 = gp.log_marginal_likelihood_value_, _uncounted(lambda: _consensus_lml_f64(gp))
        plain32, cond = _uncounted(lambda: _lml_plain32_and_cond(gp))
        out[name] = {"fit_s": seconds[name], "ml2_s": ml2_s[0], "launches": by_fit[name],
                     "consensus_lml": lml, "consensus_lml_f64": lml64,
                     "plain_float32_lml": plain32, "cond_K": cond,
                     "warnings": [str(w.message)[:80] for w in caught]}
        return gp, caught

    # (a) Laplace init + MAP warm start with restarts + lifted SciPy priors
    positions = {}
    laplace = tbg.BayesGPR._laplace_positions

    def recorded(self, *args):
        t0 = time.perf_counter()
        positions["pos"] = laplace(self, *args)
        positions["seconds"] = time.perf_counter() - t0
        return positions["pos"]

    tbg.BayesGPR._laplace_positions = recorded
    try:
        gp_a, _ = run_fit("a laplace+map+restarts", kernel, lifted, chain_init="laplace",
                          ml2_objective="map", n_restarts_optimizer=2)
    finally:
        tbg.BayesGPR._laplace_positions = laplace
    pos = positions.get("pos")
    spread = None if pos is None else float(pos.std(0).min())
    out["a laplace+map+restarts"]["walker_spread_min"] = spread
    out["a laplace+map+restarts"]["laplace_s"] = positions.get("seconds")

    # (b) the device L-BFGS against SciPy's L-BFGS-B from the same starts
    ml2 = {}
    for opt_name in ("lbfgs-device", "lbfgs"):
        gp = BayesGPR(kernel, random_state=0, device=dev, optimizer=opt_name,
                      n_restarts_optimizer=2)
        gp._spec = kernel
        gp._set_data(X, y, None)
        t0 = time.perf_counter()
        theta = gp._ml2_optimize()
        torch.cuda.synchronize()
        d64 = gp._data._replace(X=gp._data.X.double(), y=gp._data.y.double(),
                                alpha_diag=gp._data.alpha_diag.double())
        nll = float(tbg._neg_lml_plain(kernel, torch.as_tensor(theta, device=dev), d64))
        ml2[opt_name] = {"seconds": time.perf_counter() - t0, "neg_lml_f64": nll}
    ml2_margin = 1e-3 * abs(ml2["lbfgs"]["neg_lml_f64"])
    gp_b, _ = run_fit("b lbfgs-device", kernel, lifted, chain_init="laplace",
                      optimizer="lbfgs-device", n_restarts_optimizer=2)
    out["b lbfgs-device"]["ml2"] = ml2

    # (c) the warm start on a 128-point subsample
    run_fit("c ml2_subsample=128", kernel, ml2_subsample=128)

    # (d) kernels outside the fused family: plain grams, K3 bases
    matern17 = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3,) * N_DIM, (0.05, 2.0), nu=1.7) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    powered = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Exponentiation(
        bk.Matern((0.3,) * N_DIM, (0.05, 2.0), nu=2.5), 2.0) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    # 3 chain steps: each general-nu half-step evaluates K_nu in float64
    # over the (50, 512, 512) distances
    short = dict(fit_kw, n_desired_samples=N_WALKERS, n_burnin=2)
    run_fit("d Matern(nu=1.7)", matern17, steps=short)
    run_fit("d Exponentiation", powered, steps=short)

    # (g) short warm chains, 3 steps each: opaque priors through the host
    # adapter (a NumPy lambda, whose own cost is ~1 us a call, and a SciPy
    # lambda that builds a frozen distribution at each call) beside the
    # lifted prior
    numpy_prior = [lambda x: -0.125 * float(np.square(x))] * kernel.n_theta
    scipy_prior = [lambda x: sps.norm(0.0, 2.0).logpdf(x)] * kernel.n_theta
    chain = {}
    before = _counts()
    for name, priors in (("lifted", lifted), ("host adapter, NumPy lambda", numpy_prior),
                         ("host adapter, SciPy lambda", scipy_prior), ("lifted again", lifted)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gp_a.sample(n_desired_samples=3 * N_WALKERS, priors=priors, warn_rhat=None)
            torch.cuda.synchronize()
        chain[name] = {"ms_per_step": 1e3 * (time.perf_counter() - t0) / 3,
                       "consensus_lml": gp_a.log_marginal_likelihood_value_}
    by_fit["g chains"] = _since(before)
    host_types = {type(p).__name__ for p in gp_a._resolve_priors(numpy_prior + scipy_prior)}

    # (e) prediction gradients of phase 6's model: float32 on the card, and
    # a float64 copy (saved and loaded) against central differences
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/gp.npz"
        serialization.save_gpr(opt.gp, path)
        gp64 = serialization.load_gpr(path, device=dev, dtype=torch.float64)
        grid = np.random.RandomState(17).uniform(0.1, 0.9, size=(64, N_DIM))
        _, _, mg, sg = gp64.predict(grid, return_std=True, return_mean_grad=True,
                                    return_std_grad=True)
        _, _, mg32, sg32 = opt.gp.predict(grid, return_std=True, return_mean_grad=True,
                                          return_std_grad=True)
        h, fd_err = 1e-5, {"mean": 0.0, "std": 0.0}
        for i in range(N_DIM):
            e = np.zeros(N_DIM)
            e[i] = h
            mp, sp_ = gp64.predict(grid + e, return_std=True)
            mm, sm = gp64.predict(grid - e, return_std=True)
            fd_err["mean"] = max(fd_err["mean"], float(np.abs(mg[:, i] - (mp - mm) / (2 * h)).max()))
            fd_err["std"] = max(fd_err["std"], float(np.abs(sg[:, i] - (sp_ - sm) / (2 * h)).max()))
        grad_scale = {"mean": float(np.abs(mg).max()), "std": float(np.abs(sg).max())}
        f32_err = {"mean": float(np.abs(mg32 - mg).max()), "std": float(np.abs(sg32 - sg).max())}

        # (f) the Optimizer through save_optimizer / load_optimizer on the card
        opath = f"{tmp}/opt.npz"
        t0 = time.perf_counter()
        serialization.save_optimizer(opt, opath)
        loaded = serialization.load_optimizer(opath, device=dev)
        torch.cuda.synchronize()
        roundtrip_s = time.perf_counter() - t0
    same_ask = list(loaded.ask()) == list(opt.ask())
    pred_err = float(np.abs(loaded.gp.predict(grid) - opt.gp.predict(grid)).max())
    pred_scale = float(np.abs(opt.gp.predict(grid)).max())
    # The float32 LML's error grows with cond(K), so a well-fitted model
    # (little noise) can miss phase 6's 1e-5 of |LML| through conditioning
    # alone; it then still has to be within twice the error of the float32
    # cholesky_ex path (no K1, no K3) at the same theta.
    for v in out.values():
        v["lml_err"] = abs(v["consensus_lml"] - v["consensus_lml_f64"])
        v["lml_limit"] = max(1e-5 * max(1.0, abs(v["consensus_lml_f64"])),
                             2.0 * abs(v["plain_float32_lml"] - v["consensus_lml_f64"]))
    report(
        "phase 10 fit options", fits=out, ml2_device_vs_host=ml2, ml2_margin=ml2_margin,
        host_adapter_chain=chain, host_prior_types=sorted(host_types),
        predict_grads={"fd_max_abs_err": fd_err, "grad_scale": grad_scale,
                       "float32_vs_float64_max_abs": f32_err, "h": h, "points": len(grid)},
        checkpoint={"seconds": roundtrip_s, "same_next_ask": same_ask,
                    "predict_max_abs_diff": pred_err, "predict_scale": pred_scale},
        launches=by_fit,
    )
    fusable = ("a laplace+map+restarts", "b lbfgs-device", "c ml2_subsample=128")
    general = ("d Matern(nu=1.7)", "d Exponentiation")
    checks = {
        "(a) the SciPy priors were lifted (no host adapter)":
            not any("adapter" in w for w in out["a laplace+map+restarts"]["warnings"]),
        "(a) Laplace positions drawn": pos is not None,
        "(a) walker spread finite, >= 0.8 x the Laplace floor":
            spread is not None and math.isfinite(spread) and spread >= 0.8 * tbg._LAPLACE_STD_MIN,
        "(b) device L-BFGS no worse than L-BFGS-B by 1e-3 relative":
            ml2["lbfgs-device"]["neg_lml_f64"] <= ml2["lbfgs"]["neg_lml_f64"] + ml2_margin,
        "K1 and K3 launched in each fusable fit":
            all(by_fit[k]["K1"] >= 1 and by_fit[k]["K3"] >= 1 for k in fusable),
        "K1 not launched, K3 launched in the general fits":
            all(by_fit[k]["K1"] == 0 and by_fit[k]["K3"] >= 1 for k in general),
        "consensus LMLs match float64 (phase 6's bound, or twice cuSOLVER's float32 error)": all(
            math.isfinite(v["consensus_lml"]) and v["lml_err"] <= v["lml_limit"]
            for v in out.values()),
        "(e) float64 gradients match central differences (1e-5 of scale)": all(
            fd_err[k] <= 1e-5 * max(1.0, grad_scale[k]) for k in fd_err),
        "(f) loaded optimizer: same next ask": same_ask,
        "(f) loaded optimizer: same predictions (1e-5 of scale)":
            pred_err <= 1e-5 * max(1.0, pred_scale),
        "(g) host adapter in use": host_types == {"_HostPrior"},
        "(g) chains finite": all(math.isfinite(v["consensus_lml"]) for v in chain.values()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 10 failed: {failed}")
    total = {k: sum(c[k] for c in by_fit.values()) for k in _kernel_counters()}
    return total


def _ptxas_entries(kernel_name, report_text=None):
    """[(entry, registers, spill bytes, shared bytes)] of the built entry
    functions whose name holds ``kernel_name``, from nvcc's -Xptxas=-v
    report (``report_text``, by default the one in ``_cuda.build_info``,
    which only a run that built the library fills)."""
    import re

    from bask_tpu_torch.ops import _cuda

    if report_text is None:
        report_text = _cuda.build_info.get("ptxas", "")
    out, entry, spill = [], None, 0
    for ln in report_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
        if m and entry and kernel_name in entry:
            out.append((entry, int(m.group(1)), spill, int(m.group(2))))
    return out


def _load_script(name):
    """A module of ``scripts/`` beside this file."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_wb_gram(dev):
    """Phase 11: K4, the walker-batched gram (``csrc/gram.cu``,
    ``gram.fused_masked_gram_wb_batch``): within 4e-6 max|K| of the float64
    plain version at (50, 512, 512), d 15, for all four nu; bit-equal to K1
    (``gram._k1_gram_batch``) at (50, 512, 512) with wb 2 and 5, at
    (256, 1024, 1024) with wb 2, 4 and 8 and at (128, 1024, 1024) with wb
    4 and 8, for the spec variants; one device operation per call; its
    device time alone next to K1's (wb = 1) at (50 | 128 | 256, ...) in
    turns; registers from nvcc's report and resident blocks per SM from
    the occupancy calculator; the batched LML at each routed shape against
    K1's; then ``scripts/bench_gram_wb.run`` with the counts from 0.
    Returns (the kernel table's row, the launch counts of the script)."""
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    rng = np.random.RandomState(21)
    X, _ = bench_dataset()
    Xb, _ = batch_dataset()
    Xp = np.full((BATCH_PAD, N_DIM), 0.5)
    Xp[:BATCH_OBS] = Xb
    data = {N_PAD: (torch.tensor(padded(X), dtype=torch.float32, device=dev), N_OBS),
            BATCH_PAD: (torch.tensor(Xp, dtype=torch.float32, device=dev), BATCH_OBS)}
    alphas = {n: torch.full((n,), 1e-6, dtype=torch.float32, device=dev) for n in data}

    def inputs(kernel, B, n_pad):
        th = torch.tensor(kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
                          dtype=torch.float32, device=dev)
        Xd, n_real = data[n_pad]
        return gram.match_fusable(kernel), th, Xd, alphas[n_pad], n_real

    def k4(args, wb):
        return gram.fused_masked_gram_wb_batch(*args, wb)

    # (a) against float64, the bound of phase 2
    B = N_WALKERS // 2
    to_f64, worst = [], 0.0
    for nu in (0.5, 1.5, 2.5, math.inf):
        args = inputs(bench_kernel(bk, nu), B, N_PAD)
        K = k4(args, 5)
        spec, th, Xd, alpha, n_real = args
        ref = gram.fused_masked_gram_plain(spec, th.double(), Xd.double(), alpha.double(), n_real)
        err = float((K.double() - ref).abs().max())
        bound = 4e-6 * float(ref.abs().max())
        to_f64.append({"nu": nu, "wb": 5, "max_abs_err": err, "bound": bound,
                       "ok": bool(torch.isfinite(K).all()) and err <= bound})
        worst = max(worst, err)
        del K, ref
    # (b) bit-equal to K1
    kernels = [(f"nu={nu}", bench_kernel(bk, nu)) for nu in (0.5, 1.5, 2.5, math.inf)]
    kernels += [(v, variant_kernel(bk, v)) for v in ("no ConstantKernel", "no WhiteKernel", "isotropic")]
    equal = []
    for B, n_pad, wbs, cases in ((N_WALKERS // 2, N_PAD, (2, 5), kernels),
                                 (BATCH_WALKERS, BATCH_PAD, (2, 4, 8), kernels[2:]),
                                 (BATCH_WALKERS // 2, BATCH_PAD, (4, 8), kernels[2:])):
        for label, kernel in cases:
            args = inputs(kernel, B, n_pad)
            K1 = gram._k1_gram_batch(*args)
            for wb in wbs:
                same = bool(torch.equal(k4(args, wb), K1))
                equal.append({"case": label, "shape": [B, n_pad, n_pad], "n_real": args[-1],
                              "wb": wb, "bit_equal": same})
            del K1
    # (c) one device operation per call
    args = inputs(bench_kernel(bk), N_WALKERS // 2, N_PAD)
    ops_per_call, _ = profiled(lambda: k4(args, 5))
    failed = [c for c in to_f64 if not c["ok"]] + [c for c in equal if not c["bit_equal"]]
    if failed or ops_per_call != 1:
        raise AssertionError(f"K4 failed: {failed}, {ops_per_call} device operations per call")

    # (d) alone, in turns: each wb in order then reversed, twice; wb = 1
    # is K1 itself
    timing = []
    for B, n_pad, wbs in ((N_WALKERS // 2, N_PAD, (1, 2, 5)),
                          (BATCH_WALKERS // 2, BATCH_PAD, (1, 2, 4, 8)),
                          (BATCH_WALKERS, BATCH_PAD, (1, 2, 4, 8))):
        args = inputs(bench_kernel(bk), B, n_pad)
        turns = {wb: [] for wb in wbs}
        for wb in (list(wbs) + list(wbs)[::-1]) * 2:
            if wb == 1:
                _, ops = profiled(lambda: gram._k1_gram_batch(*args), reps=10)
                turns[wb].append(kernel_us(ops, "gram_kernel"))
            else:
                _, ops = profiled(lambda: k4(args, wb), reps=10)
                turns[wb].append(kernel_us(ops, "gram_wb_kernel"))
        bound, by = gram_bound(B, n_pad, N_DIM)
        med = {wb: float(np.median(t)) for wb, t in turns.items()}
        spread = {wb: float(max(t) - min(t)) for wb, t in turns.items()}
        timing.append({
            "shape": [B, n_pad, n_pad], "alone_us_turns": turns, "median_us": med,
            "spread_us": spread, "bound_us": 1e3 * bound, "bound_by": by,
            "k4_wins_beyond_spreads": {wb: med[1] - med[wb] > spread[1] + spread[wb]
                                       for wb in wbs if wb > 1},
            "blocks": {wb: -(-B // wb) * (n_pad // 64) * -(-n_pad // 128) for wb in wbs},
        })
    args = inputs(bench_kernel(bk), N_WALKERS // 2, N_PAD)
    ms = cuda_ms(lambda: k4(args, 5))
    k1_ms = cuda_ms(lambda: gram._k1_gram_batch(*args))
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(*args))
    bound, by = gram_bound(N_WALKERS // 2, N_PAD, N_DIM)
    resources = {name: [{"registers": r, "spill_bytes": s, "smem_bytes": m}
                        for _, r, s, m in _ptxas_entries(key)]
                 for name, key in (("K4", "gram_wb_kernel"), ("K1 and K2", "11gram_kernel"))}
    # K4 stages X once at d 15 and re-stages it per chunk at d 40
    resources["blocks_per_sm"] = {
        f"{name} d={d}": [gram._blocks_per_sm(name, nu, d) for nu in (0.5, 1.5, 2.5, math.inf)]
        for name in ("K1", "K2", "K4") for d in (N_DIM, 40)}

    # the shapes that gram.fused_masked_gram_batch sends to K4: did this
    # run find K4 faster there beyond both spreads?
    won = {(*t["shape"][:2], N_DIM): t["k4_wins_beyond_spreads"] for t in timing}
    route = [{"walkers_n_pad_d": list(key), "wb": gram._K4_WB,
              "k4_wins_in_this_run": won.get(key, {}).get(gram._K4_WB)}
             for key in sorted(gram._K4_SHAPES)]
    # (f) the batched LML at each routed shape (the batch ask's data): K4's
    # grams give K1's LMLs bit for bit
    from bask_tpu_torch.ops import linalg

    _, yb = batch_dataset()
    yp = np.zeros(BATCH_PAD)
    yp[:BATCH_OBS] = (yb - yb.mean()) / yb.std()
    y_t = torch.tensor(yp, dtype=torch.float32, device=dev)
    mask = torch.tensor(np.arange(BATCH_PAD) < BATCH_OBS, device=dev)
    kernel = bench_kernel(bk)
    for r in route:
        B, n_pad, d = r["walkers_n_pad_d"]
        if (n_pad, d) != (BATCH_PAD, N_DIM):
            raise AssertionError(f"phase 11 has no data for the routed shape {r}")
        spec, th, Xd, alpha, n_real = inputs(kernel, B, n_pad)
        before = gram.fused_masked_gram_wb_batch.launches
        via_k4 = linalg.batched_lml(kernel, th, Xd, y_t, alpha, mask, n_real=n_real)
        r["k4_launches_in_lml"] = gram.fused_masked_gram_wb_batch.launches - before
        via_k1 = linalg.batched_lml_from_gram(gram._k1_gram_batch(spec, th, Xd, alpha, n_real),
                                              y_t, mask)
        r["lml_bit_equal_to_k1"] = bool(torch.equal(via_k4, via_k1))
        r["lml_finite"] = bool(torch.isfinite(via_k4).all())
    if not all(r["k4_launches_in_lml"] == 1 and r["lml_bit_equal_to_k1"] for r in route):
        raise AssertionError(f"the LML through the K4 route differs from K1's: {route}")

    # (e) the port's bench_gram_wb.py, the path that reaches K4
    bench = _load_script("bench_gram_wb")
    for fn in _kernel_counters().values():
        fn.launches = 0
    script = [bench.run(wb, 20) for wb in (2, 5)]
    launches = _counts()
    report("phase 11 K4 walker-batched gram", to_float64=to_f64, bit_equal_to_k1=equal,
           device_ops_per_call=ops_per_call, alone=timing, ms=ms, k1_ms=k1_ms,
           plain_ms=plain_ms, bound_ms=bound, bound_by=by, resources=resources,
           route=route, bench_gram_wb=script, launches=launches)
    if launches["K4"] == 0:
        raise AssertionError("scripts/bench_gram_wb.py did not launch K4")
    row = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": None, "routed_shapes": route,
           "alone_us": [{"shape": t["shape"], "median_us": t["median_us"],
                         "spread_us": t["spread_us"]} for t in timing]}
    return row, launches


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
    # phase 11 runs with the other kernel phases: on the H100, a profiler
    # session that starts seconds after an earlier one can record no device
    # operation at all (scripts/profiler_after_fits.py)
    k4, k4_path = timed("11", phase_wb_gram, dev)
    timed("5", phase_lml, dev)
    opt = timed("6", phase_optimizer, dev)
    by_path = {"phase 7 warped tell": timed("7", phase_warped_optimizer, dev)}
    by_path["phase 8 batch ask"], k1_batch, k4_batch, k3_batch = timed("8", phase_batch_ask, dev)
    by_path["phase 9 polish"] = timed("9", phase_stopping_polish, opt, dev)
    by_path["phase 10 fit options"] = timed("10", phase_fit_options, opt, dev)
    by_path["phase 11 bench_gram_wb"] = k4_path
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
        {"name": "K4 walker-batched gram", "route": "cuda",
         "source": "bask_tpu_torch/csrc/gram.cu",
         "replaces": "benchmarks/bench_gram_wb.py:59",
         **launches("K4"), **k4, "at_batch_ask_shapes": k4_batch},
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
