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
   the CPU (its grams from the route: K1, or K4 where ``gram._K4_ROUTE``
   sends (512, 15)); then with ``gram.LOWER_GRAM = "on"`` (K2), bit-equal
   to the LML of K1's gram (``gram._k1_gram_batch``), for shared X and
   for per-walker warped X;
6. the Optimizer end to end on the card: a cold tell of 500 points
   (ML-II, then sampling to split R-hat 1.1 in capped legs), three warm
   ask/tell rounds with PVRS, one marginalized EI pass over a 500-point
   grid; the kernels' launch counts over this phase;
7. the same Optimizer with input warping and ``LOWER_GRAM = "on"``: the
   chain's grams come from K2 on per-walker X warped by K6, the candidate
   grids from K7; a cold tell, three warm PVRS tells, then one pass of
   each of the eight acquisitions over a 500-point grid; the launch counts
   of K1, K2, K3, K6 and K7 over this phase;
8. the batch ask at the shape of ``benchmarks/bench_batch_ask.py``
   (n = 1,000 in 15-D padded to 1,024, 256 walkers, normalized y): a cold
   tell with an EI pass over 65,536 candidates (its (128 | 256, 1024,
   1024) grams from K4, to which ``gram._K4_ROUTE`` sends (1024, 15)), then
   ``ask(n_points=256)`` twice (pathwise Thompson top-k, the rows'
   (256, 1024, 1024) gram from K4 and its blocked factorization with K3
   bases); the grams at (256, 1024, 1024) and (128, 1024, 1024) through
   the route (K4) and from K1 itself, each alone and against its float64
   plain version on a few rows,
   the (256, 1024, 1024) factorization A/B against ``cholesky_ex``,
   4 of 256 pathwise draws held to a float64 recomputation (and a TF32
   control through K5's plain version that must miss), K5 (the draws'
   values, ``csrc/pathwise.cu``, its tensor-core kernel at d = 15)
   launched twice in each ask (one chunk of 256 draws), against its
   float64 plain version on the 4 draws' inputs at the full shape, timed
   alone (profiler and CUDA events) beside its plain version, its bound
   with the depth-d products on the tensor cores, its launch plan, and,
   computed from the inputs on the report line only, PR 10's all-FP32
   bound, the modelled MUFU floor and the host's estimate of the share of
   its features on the float64 argument; the same launch at nu = 1/2 on seeded synthetic
   inputs (``k5_synthetic``), against float64 and timed; nvcc's report of
   K5's instantiations; and a profiled ask under 700 device operations;
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
11. K4 (the walker-batched gram, ``csrc/gram_wb.cu``): against its plain
   version in float64 (4e-6 max|K|) for all four nu, the spec variants,
   ragged n_real and the B % wb tail at (50, 512, 512), d = 15, at d = 40
   with X resident in shared memory and not, and at n_pad 2,048, the
   diagonal exact; within twice that of K1 at (50, 512, 512) with 2 and
   5 walkers per unit, (256, 1024, 1024) with 2, 4 and 8 and
   (128, 1024, 1024) with 4 and 8, for the spec variants; bit for bit the
   same across B and wb; its one-pass TF32 control missing the float64
   bound; one device operation per call; its device time alone next to
   K1's at (50, 512, 512), (128, 1024, 1024) and (256, 1024, 1024), in
   turns; registers and spills from nvcc's report, shared memory, blocks
   per SM and the grid from K4's launch plan; the batched LML through each
   (n_pad, d) of ``gram._K4_ROUTE`` against float64; then the path that
   reaches K4, ``scripts/bench_gram_wb.run`` (2 and 5 walkers per unit).
   It runs after phase 4b, with the other kernel phases.

12. meshes (``bask_tpu_torch.parallel``) and the row-sharded Cholesky
   (``ops/dist_chol.py``) on the one card, whose entries a mesh repeats:
   (a) ``batched_lml(mesh=)`` over [cuda:0] x P, P = 1, 2, 4, at the
   north-star shape (100, 512, d = 15) and over [cuda:0] x 2 at the batch
   ask's (256, 1024), each shard's gram from K1 or K4 by the route,
   against the unsharded call (bit for bit at P = 1, 2) and float64,
   with the launches per shard;
   one warm tell of ``Optimizer(mesh=...)`` against the unsharded one;
   (b) the row-sharded LML at n = 32,768, d = 15, nb 256 on 4 strips
   (the sweep's diagonal blocks on K3), ``unroll`` both ways, against a
   float64 dense factor, bounded by twice the float32 ``cholesky_ex``
   error with twice the float32 spacing at the LML as its floor, and
   against the dense float32 port path (K1's gram) within the same
   limit; a sweep with TF32 matmuls must miss it; a non-PD theta (-inf); times, peak
   memory, K3 launches per sweep; the same LML through a world-size-1
   NCCL process group, bit-equal to the in-process mesh; K3 at the row
   path's block against ``cholesky_ex`` + ``solve_triangular``; (c)
   row-mode ``BayesGPR`` on a (2 walkers x 2 rows) mesh at n = 8,192:
   the adjoint, jvp and dense float32 gradients against float64, an ML-II
   warm start and a 16-walker x 6-step chain, ``predict`` at 1,000
   queries and 4 draws from given normals against the dense models, each
   within ``RM_ERR_MULTIPLE`` times the dense float32 model's own error.
13. the production-loop tooling: (a) chain ms per step with the step
   replayed from CUDA graphs against the eager step, in turns, on phase
   6's unwarped model (K4 + K3) and phase 7's warped model with
   ``LOWER_GRAM = "on"`` (K2 + K3), and the card's busy share in each;
   (b) the replayed chains bit-equal to the eager chains (same seed,
   demix moves), one replay under the profiler naming its kernels; (c)
   the first tell of a fresh process (a child of this one, running
   ``python3 chip_smoke.py --first-tell cold|warm CACHE``) without and
   with ``warmup_optimizer``; (d) no graph captured after the warmup; (e)
   those children load the kernel library from a cache that this process
   filled with ``enable_aot_cache`` after its build, running no nvcc; (f)
   their warm tells; (g) a chain with an opaque NumPy prior tabulated on
   the device (``host_prior_mode="interp"``), graphed, beside the same
   chain eager and the lifted prior's, its log posterior held to the exact
   one. Since this slice every chain of phases 6-11 and 13 on one card
   replays graphs (phase 10's host-adapter chains and general kernels,
   and phase 12's meshes, stay eager).
14. the module switches: (a) ``linalg.FAST_CHOLESKY`` "auto" (the
   blocked factorization, K3 bases) against "off" (``cholesky_ex`` and a
   triangular solve: cuSOLVER and cuBLAS) inside the chain's CUDA graph
   on phase 6's model (100 walkers, n_pad 512) and phase 8's (256
   walkers, n_pad 1,024): ms per step graphed in turns (auto, off, off,
   auto) and eager, the card's busy share, device operations and K3
   launches per replay (none at "off"), the graphed "off" chain bit-equal
   to the eager one, both routes' LMLs of the chain's positions against
   float64 within phase 5's limit or, where cond(K) makes float32 miss
   it, each route's largest error over the batch within twice the other
   route's (phase 10's rule); (b) phase 6's warm tell at each route
   in turns, and a PVRS tell with ``acquisition.FUSED_ACQUISITION`` "off"
   (the legacy dispatcher) on a reloaded copy of the Optimizer, whose
   next ask equals the fused tell's on another copy; (c) the example
   scripts on the card, as child processes at their default sizes:
   ``examples/torch_production_loop.py`` alone (its library from a fresh
   cache this process fills), then ``torch_optimize_1d.py`` and
   ``torch_fit_gp.py`` side by side; each exits 0, and the loop's printed
   numbers (warmup seconds, median warm iteration, first fitted
   iteration, best y) are reported.
15. the input warp on its kernels (``csrc/warp.cu``): (a) K6 (the Beta-CDF
   warp) at the chain's half-batch (50, 512, 15) from shared X, the
   draws' training X (256, 1,024, 15), a ragged per-row (64, 999, 7) and
   the batch ask's queries (256, 65,536, 15); K7 (the Beta PPF) at
   (500, 15) and (65,536, 15); each at float32 and float64 with log-
   parameters over the warp prior's 5-sigma range and x at and past the
   ends, against the float64 plain version (``WARP_TOL``, ``PDF_RTOL``,
   ``UNWARP_TOL``), controls that must miss the limits (a short continued
   fraction; for K7 also the plain unwarp stopped early), one device
   operation per call, the time alone and through the
   wrapper beside the plain version's and the bound, nvcc's registers
   and spills; (b) phase 8's batch ask with ``warp_inputs=True``: the
   cold tell (11 steps, EI over 65,536 warp-density candidates) and two
   ``ask(n_points=256)``, K7 for each grid, K6 for the chain's
   per-walker X and the draws' training X and queries, K1 for the
   per-walker grams, K3, K5 exactly twice an ask in one chunk; 4 draws
   against float64; the asks', the cold tell's and the grid's seconds, a
   profiled ask's device operations and busy share, peak memory; (c) the
   warped numbers with K6 and K7 in place are phase 7's warm tells and
   phase 13 (a)'s warped chain, graphed and eager, with the device
   operations of a replay, in those phases' report lines. Phases 7 and 13
   check that K6 and K7 launched (phase 13 adds one warm tell of the
   warped model, (h), and checks that the warped replay runs K6). (a)
   runs after phase 11, with the other kernel phases, and (b) right after
   it; (c), last, profiles (b)'s ask and grid again at the end of the run,
   where a session may miss the grid's operations (PERF.md section 7).

The ``launches`` of the kernel table sum phases 7-15, each counted from 0
just before the phase drives its path and read just after it; a replayed
step counts the launches its graph captured.

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
# K5 alone against its plain version in float64 on the same float32
# inputs: a third of the draws' limit (the rest is the gram's, the
# factorization's and the solves'), of the largest |value|
K5_REL_TOL = DRAW_REL_TOL / 3
# the most device operations a profiled 256-point ask may run (6,679-6,683
# when the draws ran op by op in 64 chunks)
ASK_MAX_DEVICE_OPS = 700
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


def _bowl(rng):
    """The Optimizer phases' objective: a noisy bowl centred in the cube,
    its noise drawn from ``rng``."""

    def objective(x):
        return float(np.sum((np.asarray(x) - 0.5) ** 2) + 0.05 * rng.randn())

    return objective


def bound_ms(n_bytes: float, n_ops: float, flops: float = F32_FLOPS):
    """(the least time for the work, what bounds it): bytes moved over the
    HBM rate against operations over the peak rate (float32's by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flops
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


def alone_us(fn, key, reps=10, tries=3):
    """``kernel_us`` of ``reps`` calls of ``fn`` under the profiler, the
    session repeated where it recorded no device operation (a profiler
    session on the card can come back empty, PERF.md section 7); None if
    every try did."""
    for _ in range(tries):
        _, ops = profiled(fn, reps=reps)
        us = kernel_us(ops, key)
        if us is not None:
            return us
    return None


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
        built=_cuda.build_info["built"],
        library=_cuda.build_info["library"],
        toolchain=_cuda._toolchain(),
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
        K = gram._k1_gram_batch(spec, th, Xin, alpha, N_OBS)
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
        return gram._k1_gram_batch(spec, th, Xd, alpha, N_OBS)

    ops_per_call, _ = profiled(call)
    if ops_per_call != 1:
        raise AssertionError(f"K1's wrapper issued {ops_per_call} device operations, not 1")
    k1_us = alone_us(call, "gram_kernel", reps=20)
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(spec, th, Xd, alpha, N_OBS))
    bound, by = gram_bound(B, N_PAD, N_DIM)
    report("phase 2 K1 gram", cases=cases, device_ops_per_call=ops_per_call,
           ms=ms, kernel_alone_us=k1_us,
           share_of_write_bound=bound * 1e3 / k1_us if k1_us else None, plain_ms=plain_ms,
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
            K1 = gram._k1_gram_batch(spec, th, Xin, alpha, N_OBS)
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
    t1a = cuda_ms(lambda: gram._k1_gram_batch(*args))
    t1b = cuda_ms(lambda: gram._k1_gram_batch(*args))
    t2b = cuda_ms(lambda: gram.fused_masked_gram_lower_batch(*args))
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_lower_plain(*args))
    k2_us = alone_us(lambda: gram.fused_masked_gram_lower_batch(*args), "gram_kernel", reps=20)
    n_tiles = N_PAD // gram._SQ_TILE
    share = n_tiles * (n_tiles + 1) / 2 / n_tiles**2
    bound, by = gram_bound(B, N_PAD, N_DIM, share)
    ms = float(np.median([t2a, t2b]))
    report("phase 3 K2 lower gram", cases=cases, ms_turns=[t2a, t2b],
           k1_ms_turns=[t1a, t1b], kernel_alone_us=k2_us,
           share_of_write_bound=bound * 1e3 / k2_us if k2_us else None, plain_ms=plain_ms,
           bound_ms=bound,
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
    k3_us = alone_us(lambda: chol_base.chol_inv_base(A), "chol_inv_kernel", reps=20)
    plain_ms = cuda_ms(lambda: chol_base.chol_inv_plain(A))
    library_ms = cuda_ms(library)
    # read the lower triangle of A once, write L and L^-1 once; m^3/3
    # FLOPs of factor and about m^3/3 of inverse per matrix (the m
    # dependent steps are a latency floor this count does not see)
    bound, by = bound_ms(4 * B * (m * (m + 1) // 2 + 2 * m * m), B * 2 * m**3 / 3)
    report("phase 4 K3 chol_base", cases=cases, nan_contract_m128=nan_ok, ms=ms,
           kernel_alone_us=k3_us, plain_ms=plain_ms, library_ms=library_ms,
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
    """Batched LML (the routed gram, K4 at (512, 15); the blocked
    factorization with K3 bases) at the bench shape, against the port's
    float64 CPU path (plain gram and LAPACK factorization) on the same
    thetas."""
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
    # LOWER_GRAM on (K2) against K1's gram: bit for bit, shared X and
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
        th_, X_, y_, alpha_, mask_ = args
        k1 = linalg.batched_lml_from_gram(
            gram._k1_gram_batch(gram.match_fusable(kernel), th_, X_, alpha_, N_OBS), y_, mask_)
        off = linalg.batched_lml(kernel, *args, n_real=N_OBS)
        k2 = gram.fused_masked_gram_lower_batch.launches
        gram.LOWER_GRAM = "on"
        try:
            on = linalg.batched_lml(kernel, *args, n_real=N_OBS)
        finally:
            gram.LOWER_GRAM = "off"
        lower[mode] = {
            "bit_equal": bool(torch.equal(on, k1)),
            "finite": bool(torch.isfinite(on).all()),
            "k2_launched": gram.fused_masked_gram_lower_batch.launches > k2,
        }
        # the route's LML (K4 where routed) beside it, reported only
        lower[mode + ", route"] = {"kernel": "K4" if Xin.ndim == 2 and _shared_x_gram() == "K4"
                                   else "K1", "max_abs_diff": float((off - on).abs().max())}
    report("phase 5 batched LML", shape=[N_WALKERS, N_PAD, N_DIM],
           lml_range=[float(lml.min()), float(lml.max())],
           max_abs_err=float(err.max()), bound=float(bound.min()), ok=ok, ms=ms,
           lower_gram=lower)
    if not all(all(v.values()) for k, v in lower.items() if not k.endswith("route")):
        raise AssertionError(f"LML with LOWER_GRAM on differs from K1's: {lower}")


def _kernel_counters():
    from bask_tpu_torch.ops import chol_base, gram, pathwise_values, warp_values

    return {
        "K1": gram.fused_masked_gram_batch,
        "K2": gram.fused_masked_gram_lower_batch,
        "K3": chol_base.chol_inv_base,
        "K4": gram.fused_masked_gram_wb_batch,
        "K5": pathwise_values.pathwise_values,
        "K6": warp_values.warp_values,
        "K7": warp_values.unwarp_values,
    }


def _shared_x_gram(n_pad=N_PAD):
    """The gram kernel ("K1" or "K4") that ``gram.fused_masked_gram_batch``
    launches for shared X of (n_pad, N_DIM): K4 where ``gram._K4_ROUTE``
    sends it."""
    from bask_tpu_torch.ops import gram

    return "K4" if (n_pad, N_DIM) in gram._K4_ROUTE else "K1"


def _drive_optimizer(dev, gp_kwargs=None, before_tell=None):
    """Build the Optimizer on the bench problem, zero the launch counts,
    then a cold tell of N_OBS points and three warm ask/tell rounds (PVRS);
    ``before_tell(opt)`` runs between the Optimizer's construction and the
    cold tell. Returns (optimizer, cold seconds, the cold tell's R-hat
    result, warm seconds, asks)."""
    import torch

    from bask_tpu_torch import Optimizer

    X, _ = bench_dataset()
    objective = _bowl(np.random.RandomState(2))
    y = [objective(x) for x in X]
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * N_DIM, n_points=N_CAND, n_initial_points=N_OBS,
        random_state=0, gp_kwargs=gp_kwargs, device=dev, dtype=torch.float32,
        gp_sample_kwargs={"max_extensions": COLD_LEGS, "extension_steps": 300},
    )
    if before_tell is not None:
        before_tell(opt)
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
    """The Optimizer's main path on the card (the routed gram, K3 bases)."""
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
        f"{_shared_x_gram()} (the shared-X gram) launched": launches[_shared_x_gram()] > 0,
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
    X (warped by K6), its candidate grids unwarped by K7; then one pass of
    each of the eight acquisitions. Returns the launch counts of the
    phase, the Optimizer and the warm tells' seconds."""
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
        "K6 launched": launches["K6"] > 0,
        "K7 launched": launches["K7"] > 0,
        "consensus LML finite": math.isfinite(lml),
        "consensus LML matches f64": abs(lml - lml64) <= 1e-5 * max(1.0, abs(lml64)),
        "chain carries 2d warp dims": gp.chain_.shape[1] == gp._spec.n_theta + 2 * N_DIM,
        "asks inside bounds": inside,
        "every acquisition finite": all(acq_ok.values()) and len(acq_ok) == 8,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"warped optimizer phase failed: {failed}")
    return launches, opt, warm_s


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
    it (``routed``: K4 at the (n_pad, d) of ``gram._K4_ROUTE``), or K1 itself.
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
    bound, by = gram_bound(B, BATCH_PAD, N_DIM)
    name = "gram_wb_kernel" if launched == ["K4"] else "gram_kernel"
    out = {"shape": [B, BATCH_PAD, BATCH_PAD], "kernel": launched, "max_abs_err": err,
           "err_bound": bound_err, "ms": ms, "kernel_alone_us": alone_us(lambda: fn(*args), name, 5),
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
    them, then the features' dot, the blocked solves and the reductions
    against w and v as TF32 matmuls (10-bit mantissas), through K5's plain
    version: what a faster, coarser dot would give. With the
    factorization in TF32 as well, the factor of these grams (cond K ~1e5)
    is NaN."""
    import torch

    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import fast_cholesky as fc
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import pathwise_values as pv

    d = gp._data
    L, invs = fc.block_cholesky(
        gram.fused_masked_gram_batch(spec, rows, d.X, d.alpha_diag, BATCH_OBS)
    )

    def solve(R):
        return fc.block_solve_upper_mat(L, invs, fc.block_solve_lower_mat(L, invs, R))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        return pathwise._draw_values(spec, rows, d.X, d, solve, Xq, rand,
                                     values=pv.pathwise_values_plain)[..., 0].double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def _k5_args(gp, spec, rows, rand, Xq):
    """The arguments of the draws' K5 launch (the queries' call) for
    ``rows``, one draw each, as the path forms them: the rows' gram and
    blocked factor in float32, f0 at the training points from K5's plain
    version; the launch itself is not made."""
    import torch

    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import fast_cholesky as fc
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import pathwise_values as pv

    d = gp._data
    L, invs = _uncounted(lambda: fc.block_cholesky(
        gram.fused_masked_gram_batch(spec, rows, d.X, d.alpha_diag, BATCH_OBS)))

    def solve(R):
        return fc.block_solve_upper_mat(L, invs, fc.block_solve_lower_mat(L, invs, R))

    calls = []

    def values(nu, Xq, omega, phase, W, coef, *cross):
        calls.append((nu, Xq, omega, phase, W, coef, *cross))
        if not cross:  # f0 at the training points
            return pv.pathwise_values_plain(nu, Xq, omega, phase, W, coef)
        return torch.zeros(omega.shape[0], Xq.shape[-2], W.shape[-1], device=Xq.device)

    pathwise._draw_values(spec, rows, d.X, d, solve, Xq, rand, values=values)
    return calls[1]


# K5's floor by the MUFU, modelled (not measured): transcendental results
# (a cosine per (query, feature) pair, a root and an exponential per
# (query, real point) pair) at 16 a clock per SM on 132 SMs at the H100
# SXM's 1.98 GHz boost clock
MUFU_PER_S = 16 * 132 * 1.98e9


def k5_costs(B, m, M, n_real, d, R, n_bytes):
    """K5's bounds for one call, computed from its shapes (none is
    measured): the least time with the depth-d products on the tensor
    cores (``bound_ms``, by ``scripts/kernel_costs.k5_bound_ms``), the first design's
    all-FP32 count (``bound_ms_f32``) and the modelled MUFU floor of the
    transcendentals (``mufu_floor_ms``)."""
    costs = _load_script("kernel_costs")

    ops = costs.k5_operations(B, m, M, n_real, d, R)
    products, other = costs.k5_operations_split(B, m, M, n_real, d, R)
    bound, by = costs.k5_bound_ms(B, m, M, n_real, d, R, n_bytes)
    f32_bound, f32_by = bound_ms(n_bytes, ops)
    transcendental = float(B) * m * (M + 2 * n_real)
    return {"operations": ops, "tensor_core_operations": products, "other_operations": other,
            "bytes": n_bytes, "bound_ms": bound, "bound_by": by, "bound_ms_f32": f32_bound,
            "bound_by_f32": f32_by, "transcendentals": transcendental,
            "mufu_floor_ms": 1e3 * transcendental / MUFU_PER_S}


def k5_wide_share(Xq, omega, queries_per_block):
    """The host's estimate of the share of (block, feature) pairs that the
    tensor-core kernel sends to the float64 argument: its rule re-derived
    here from the inputs (shared queries ``Xq`` (m, d) centred on 1/2, a
    block's largest |q - c| times the feature's sum of |omega / 2 pi|
    above 256 / (2 pi)), not a count the kernel makes."""
    import torch

    m, d = Xq.shape
    qc = (Xq - 0.5).abs().amax(1)
    blocks = -(-m // queries_per_block)
    qc = torch.cat([qc, qc[-1:].expand(blocks * queries_per_block - m)])
    qmax = qc.view(blocks, queries_per_block).amax(1)
    turns = (omega / (2 * math.pi)).abs().sum(-1)  # (B, M)
    wide = qmax[None, :, None] * turns[:, None, :] > 256.0 / (2 * math.pi)
    return float(wide.float().mean())


def k5_synthetic(dev, nu, B, m, R=1):
    """Seeded arguments of a K5 launch at a batch ask's query shape (B
    rows, m shared queries uniform in the unit box, 1,024 features, the
    batch dataset's BATCH_OBS points padded to BATCH_PAD): frequencies by
    ``pathwise.sample_frequencies`` at lengthscales drawn from U(0.2, 0.6)
    and amplitudes from U(0.5, 2); W and V standard normal, V zero on the
    padded rows."""
    import torch

    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops.gram import FusedSpec

    gen = torch.Generator(device=dev).manual_seed(31)
    kw = dict(generator=gen, device=dev)
    rand = pathwise.draw_pathwise_randoms(gen, nu, 1024, N_DIM, BATCH_PAD, R, batch=(B,),
                                          device=dev)
    inv_ls = 1.0 / (0.2 + 0.4 * torch.rand(B, N_DIM, **kw))
    amp = 0.5 + 1.5 * torch.rand(B, **kw)
    spec = FusedSpec(nu=nu, n_ls=N_DIM, has_const=True, has_white=False)
    omega = pathwise.sample_frequencies(spec, inv_ls, rand.z, rand.u)
    Xp = np.full((BATCH_PAD, N_DIM), 0.5)
    Xp[:BATCH_OBS] = batch_dataset()[0]
    V = rand.e.clone()
    V[:, BATCH_OBS:] = 0.0
    Xq = torch.rand(m, N_DIM, **kw)
    return (nu, Xq, omega, rand.phase, rand.w, torch.sqrt(2.0 * amp / 1024),
            torch.tensor(Xp, dtype=torch.float32, device=dev), inv_ls, V, amp)


def k5_check_and_time(args, keep, plain=True):
    """K5 on ``args`` against its float64 plain version on rows ``keep``
    (K5_REL_TOL of the largest |value|), its device time alone (profiler)
    and through the wrapper (CUDA events), its plain version in chunks of 4
    rows (``plain``), its bound; its launch plan, and under
    ``computed_from_inputs`` what is computed and not measured (the
    costs, the other bounds, the host's estimate of the wide share);
    launches uncounted."""
    import torch

    from bask_tpu_torch.ops import pathwise_values as pv

    nu, Xq, omega, phase, W, coef, X, inv_ls, V, amp = args
    B, M, d = omega.shape
    m, R, n_pad = Xq.shape[-2], W.shape[-1], X.shape[-2]
    sub = (nu, Xq, omega[keep], phase[keep], W[keep], coef[keep], X, inv_ls[keep], V[keep],
           amp[keep])
    out = _uncounted(lambda: pv.pathwise_values(*sub))
    ref = pv.pathwise_values_plain(*(a.double() if torch.is_tensor(a) else a for a in sub))
    err = float((out.double() - ref).abs().max())
    scale = float(ref.abs().max())
    finite = bool(torch.isfinite(out).all())
    del out, ref
    plan = pv._plan(d, R, nu)

    def launch():
        return pv.pathwise_values(*args)

    def plain_in_chunks():
        for lo in range(0, B, 4):
            sl = slice(lo, lo + 4)
            pv.pathwise_values_plain(nu, Xq, omega[sl], phase[sl], W[sl], coef[sl], X,
                                     inv_ls[sl], V[sl], amp[sl])

    ms, alone = _uncounted(lambda: (cuda_ms(launch, reps=5),
                                    alone_us(launch, plan["kernel"], reps=3)))
    plain_ms = _uncounted(lambda: cuda_ms(plain_in_chunks, reps=2)) if plain else None
    n_real = int((V.abs().sum((0, 2)) != 0).sum())
    n_bytes = sum(a.numel() * a.element_size() for a in args[1:]) + 4 * B * m * R
    costs = k5_costs(B, m, M, n_real, d, R, n_bytes)
    return {"nu": nu, "shape": {"rows": B, "queries": m, "features": M, "n_pad": n_pad,
                                "n_real": n_real, "d": d, "R": R},
            "checked_rows": list(keep), "max_abs_err": err, "scale": scale,
            "tol": K5_REL_TOL * scale, "finite": finite, "ms": ms,
            "alone_ms": None if alone is None else alone / 1e3, "plain_ms": plain_ms,
            "bound_ms": costs.pop("bound_ms"), "bound_by": costs.pop("bound_by"),
            "library_ms": None, "ok": finite and err <= K5_REL_TOL * scale, "plan": plan,
            "computed_from_inputs": {
                **costs, "wide_share_host_estimate":
                    k5_wide_share(Xq, omega, plan["queries_per_block"])}}


def _k5_phase8(gp, spec, rows, rand, Xq, keep):
    """K5 at the batch ask's query launch (the inputs of ``rows``, as the
    path forms them): against its plain version in float64 on the draws
    ``keep``, timed alone and through the wrapper beside its plain version
    in chunks of 4 draws (the op-by-op path's chunks), its bounds, its
    plan and the share of its features on the float64 argument; then the
    same launch at nu = 1/2 on seeded synthetic inputs (``k5_synthetic``);
    nvcc's report of its instantiations."""
    args = _uncounted(lambda: _k5_args(gp, spec, rows, rand, Xq))
    ask = k5_check_and_time(args, keep)
    del args
    half = k5_check_and_time(k5_synthetic(Xq.device, 0.5, B=rows.shape[0], m=Xq.shape[0]), keep,
                             plain=False)
    return {**ask, "at_nu_half": half,
            "ptxas": [{"entry": e, "registers": r, "spill_bytes": sp, "static_smem_bytes": sm}
                      for e, r, sp, sm in _ptxas_entries("pathwise_")]}


def phase_batch_ask(dev):
    """BASELINE configs[4] through the Optimizer: a cold batch tell of
    1,000 points (256 walkers, EI over 65,536 candidates), then two
    256-point batch asks; the routed grams (K4) and K1 itself at the
    path's shapes, the factorization A/B, 4 draws against float64, and K5
    (the draws' values) against its plain version and timed alone.
    Returns (launches, K1, K4, K3 and K5 extras, the fitted model)."""
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
    ops, wall_s = _profiled_retry(lambda: opt.ask(n_points=BATCH_K))
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ask_profile = {"device_ops": len(ops), "device_us": sum(by_name.values()),
                   "wall_us": 1e6 * wall_s, "busy_share": sum(by_name.values()) / (1e6 * wall_s),
                   "top_kernels_us": [[k[:60], v] for k, v in top]}
    # the ask's two parts on their own (host clock, uncounted): the fresh
    # candidate grid (host) and the pathwise top-k on it (to the synchronize)
    t0 = time.perf_counter()
    cand = opt._candidate_grid()
    ask_profile["candidate_grid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _uncounted(lambda: opt.gp.thompson_argmin_pathwise(
        cand, n_samples=BATCH_K, top_k=2 * BATCH_K, random_state=1, sample_mean=False))
    torch.cuda.synchronize()
    ask_profile["thompson_argmin_pathwise_s"] = time.perf_counter() - t0
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
    k5 = _k5_phase8(gp, spec, rows, rand, grid, keep)
    k5_per_ask = 2 * -(-BATCH_K // pathwise.draws_per_chunk(BATCH_K, BATCH_CAND, N_DIM, 0, 4))

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
        k4=k4, k1=k1, factorization_ab=factor, k5=k5, k5_launches_per_ask_predicted=k5_per_ask,
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
        # the rows' (256, 1024, 1024) gram: K4, by gram._K4_ROUTE
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
        # the draws' values: K5, twice per chunk of draws (one chunk here)
        "K5 ran in each ask, as the chunk rule predicts": all(
            per_step[f"ask {i}"]["K5"] == k5_per_ask >= 1 for i in (1, 2)),
        "K5 agrees with its plain version": k5["ok"],
        "K5 timed under the profiler": k5["alone_ms"] is not None,
        "the ask's K5 launch takes the tensor-core kernel":
            k5["plan"]["kernel"] == "pathwise_mma_kernel",
        "K5 at nu = 1/2 agrees with its plain version": k5["at_nu_half"]["ok"],
        "K5 at nu = 1/2 timed under the profiler": k5["at_nu_half"]["alone_ms"] is not None,
        f"a profiled ask runs 1-{ASK_MAX_DEVICE_OPS - 1} device operations":
            0 < ask_profile["device_ops"] < ASK_MAX_DEVICE_OPS,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"batch-ask phase failed: {failed}")
    k3_ab = {"shape": factor["shape"], "blocked_ms": float(np.median(factor["ms_turns"]["blocked"])),
             "library_ms": float(np.median(factor["ms_turns"]["cholesky_ex"])),
             "launches_per_factorization": factor["k3_launches"], "per_launch": factor["k3_launch"]}
    # the kernels line takes what this run measured, and the bound
    row_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    launch_keys = ("nu", "shape", "checked_rows", "scale", "tol", "alone_ms") + row_keys
    k5_row = {key: k5[key] for key in row_keys}
    k5_row["at_batch_ask"] = {**{key: k5[key] for key in launch_keys},
                              "at_nu_half": {key: k5["at_nu_half"][key] for key in launch_keys}}
    return launches, k1, k4, k3_ab, k5_row, opt.gp


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
        k1 = _counts()[_shared_x_gram()]
        out = polish(X0, **kw)
        calls.append({"X0": X0, "kw": kw, "out": out, "k1": _counts()[_shared_x_gram()] - k1})
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
        f"{_shared_x_gram()} (the shared-X gram) ran in the EI polish": ei["k1_in_polish"] > 0,
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
        f"{_shared_x_gram()} (the shared-X gram) and K3 launched in each fusable fit":
            all(by_fit[k][_shared_x_gram()] >= 1 and by_fit[k]["K3"] >= 1 for k in fusable),
        "no gram kernel, K3 launched in the general fits":
            all(by_fit[k]["K1"] == by_fit[k]["K4"] == 0 and by_fit[k]["K3"] >= 1
                for k in general),
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
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and entry and kernel_name in entry:
            out.append((entry, int(m.group(1)), spill, int(m.group(2) or 0)))
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


# K4's walkers per unit timed in phase 11 at each shape (B, n_pad); K1 is
# timed beside them in the same turns
K4_TIMED_WB = {(N_WALKERS // 2, N_PAD): (1, 2, 5),
               (BATCH_WALKERS // 2, BATCH_PAD): (1, 2, 4, 8),
               (BATCH_WALKERS, BATCH_PAD): (1, 2, 4, 8)}


def phase_wb_gram(dev):
    """Phase 11: K4, the walker-batched gram (``csrc/gram_wb.cu``,
    ``gram.fused_masked_gram_wb_batch``): (a) within 4e-6 max|K| of the
    float64 plain version for all four nu, the spec variants, ragged
    n_real and the B % wb tail at (50, 512, 512), d 15, at d 40 with X
    resident (n_pad 256) and read per unit (1,024), and at n_pad 2,048
    (X read per unit), the diagonal exact (K1's where real, 1 where
    padded); (b) within twice that of K1 (``gram._k1_gram_batch``) at
    (50, 512, 512) with wb 2 and 5, (256, 1024, 1024) with 2, 4 and 8 and
    (128, 1024, 1024) with 4 and 8, for the spec variants; exactly
    symmetric; (c) bit for
    bit the same across B and wb; (d) the one-pass TF32 control missing
    (a)'s bound; (e) one device operation per call; (f) its device time
    alone next to K1's at (50 | 128 | 256, ...) in turns (K1, K4 wb...,
    reversed, twice); registers and spills from nvcc's report, dynamic
    shared memory, resident blocks per SM and the grid from K4's launch
    plan; (g) the batched LML through each (n_pad, d) of
    ``gram._K4_ROUTE`` within phase 5's float64 bound; then
    ``scripts/bench_gram_wb.run`` with the counts from 0.
    Returns (the kernel table's row, the launch counts of the script)."""
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    rng = np.random.RandomState(21)
    X, _ = bench_dataset()
    Xb, _ = batch_dataset()
    Xp = np.full((BATCH_PAD, N_DIM), 0.5)
    Xp[:BATCH_OBS] = Xb
    data = {(N_PAD, N_DIM): (padded(X), N_OBS), (BATCH_PAD, N_DIM): (Xp, BATCH_OBS)}
    for n_pad, d in ((256, 40), (1024, 40), (2048, N_DIM)):  # wide d, large n_pad
        Xw = np.full((n_pad, d), 0.5)
        Xw[: n_pad - 30] = rng.uniform(size=(n_pad - 30, d))
        data[(n_pad, d)] = (Xw, n_pad - 30)

    def inputs(kernel, B, n_pad, d=N_DIM):
        th = torch.tensor(kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
                          dtype=torch.float32, device=dev)
        Xn, n_real = data[(n_pad, d)]
        return (gram.match_fusable(kernel), th, torch.tensor(Xn, dtype=torch.float32, device=dev),
                torch.full((n_pad,), 1e-6, dtype=torch.float32, device=dev), n_real)

    def k4(args, wb):
        return gram.fused_masked_gram_wb_batch(*args, wb)

    def wide_kernel(d, n_ls, nu=1.5):
        core = bk.Matern((1.5,) * n_ls if n_ls > 1 else 1.5, (0.05, 20.0), nu=nu)
        return bk.ConstantKernel(1.0, (0.1, 2.0)) * core + bk.WhiteKernel(0.05, (1e-5, 1e5))

    # (a) against float64, K1's bound (phase 2); the diagonal exact
    B = N_WALKERS // 2
    cases = [(f"nu={nu}", bench_kernel(bk, nu), B, N_PAD, N_DIM, 3)
             for nu in (0.5, 1.5, 2.5, math.inf)]
    cases += [(v, variant_kernel(bk, v), B, N_PAD, N_DIM, 3)
              for v in ("no ConstantKernel", "no WhiteKernel", "isotropic")]
    cases += [(f"d=40 n_ls={n_ls}", wide_kernel(40, n_ls), 7, n_pad, 40, 3)
              for n_pad in (256, 1024) for n_ls in (1, 40)]
    cases.append(("n_pad=2048 nu=0.5", bench_kernel(bk, 0.5), 3, 2048, N_DIM, 2))
    to_f64, worst = [], 0.0
    for label, kernel, B, n_pad, d, wb in cases:
        args = inputs(kernel, B, n_pad, d)
        K = k4(args, wb)
        spec, th, Xd, alpha, n_real = args
        ref = gram.fused_masked_gram_plain(spec, th.double(), Xd.double(), alpha.double(), n_real)
        err = float((K.double() - ref).abs().max())
        bound = 4e-6 * float(ref.abs().max())
        diag = K.diagonal(dim1=-2, dim2=-1)
        k1_diag = gram._k1_gram_batch(*args).diagonal(dim1=-2, dim2=-1)
        diag_exact = bool(torch.equal(diag, k1_diag) and (diag[:, n_real:] == 1).all())
        symmetric = bool(torch.equal(K, K.transpose(1, 2)))
        plan = gram._wb_info(spec.nu, B, n_pad, d, wb)
        to_f64.append({"case": label, "shape": [B, n_pad, n_pad], "d": d, "n_real": n_real,
                       "wb": wb, "x_resident": plan["x_resident"], "max_abs_err": err,
                       "bound": bound, "diagonal_exact": diag_exact, "symmetric": symmetric,
                       "ok": bool(torch.isfinite(K).all()) and err <= bound and diag_exact
                       and symmetric})
        worst = max(worst, err)
        del K, ref
    # (b) against K1, twice the bound
    to_k1 = []
    for B, n_pad, wbs, kernels in (
            (N_WALKERS // 2, N_PAD, (2, 5), cases[:7]),
            (BATCH_WALKERS, BATCH_PAD, (2, 4, 8), cases[2:3] + cases[4:7]),
            (BATCH_WALKERS // 2, BATCH_PAD, (4, 8), cases[2:3] + cases[4:7])):
        for label, kernel, *_ in kernels:
            args = inputs(kernel, B, n_pad)
            K1 = gram._k1_gram_batch(*args)
            bound = 2 * 4e-6 * float(K1.abs().max())
            for wb in wbs:
                diff = float((k4(args, wb) - K1).abs().max())
                to_k1.append({"case": label, "shape": [B, n_pad, n_pad], "wb": wb,
                              "max_abs_diff": diff, "bound": bound, "ok": diff <= bound})
            del K1
    # (c) bit for bit across B and wb: the batch ask's 256 walkers with wb
    # 8 against halves of them (the shards of phase 12) and other wb
    args = inputs(bench_kernel(bk), BATCH_WALKERS, BATCH_PAD)
    full = k4(args, 8)
    same = {f"wb={wb}": bool(torch.equal(k4(args, wb), full)) for wb in (1, 3)}
    for lo, hi, wb in ((0, 128, 8), (128, 256, 4), (37, 38, 1)):
        part = k4((args[0], args[1][lo:hi], *args[2:]), wb)
        same[f"walkers {lo}:{hi} wb={wb}"] = bool(torch.equal(part, full[lo:hi]))
    del full
    # (d) the TF32 control against float64
    control = []
    for nu in (0.5, 1.5, 2.5, math.inf):
        spec, th, Xd, alpha, n_real = inputs(bench_kernel(bk, nu), 8, N_PAD)
        ref = gram.fused_masked_gram_plain(spec, th.double(), Xd.double(), alpha.double(), n_real)
        control32 = gram._wb_tf32_control(spec, th, Xd, alpha, n_real, 2)
        err = float((control32.double() - ref).abs().max())
        bound = 4e-6 * float(ref.abs().max())
        control.append({"nu": nu, "max_abs_err": err, "bound": bound, "misses": not err <= bound})
    # (e) one device operation per call
    args = inputs(bench_kernel(bk), N_WALKERS // 2, N_PAD)
    ops_per_call, _ = profiled(lambda: k4(args, 5))
    failed = ([c for c in to_f64 if not c["ok"]] + [c for c in to_k1 if not c["ok"]]
              + [k for k, v in same.items() if not v] + [c for c in control if not c["misses"]])
    if failed or ops_per_call != 1:
        raise AssertionError(f"K4 failed: {failed}, {ops_per_call} device operations per call")

    # (f) alone, in turns: K1 and each wb in order, then reversed, twice
    timing = []
    for (B, n_pad), wbs in K4_TIMED_WB.items():
        args = inputs(bench_kernel(bk), B, n_pad)
        keys = ["K1"] + [f"K4 wb={wb}" for wb in wbs]
        turns = {k: [] for k in keys}
        for key in (keys + keys[::-1]) * 2:
            if key == "K1":
                turns[key].append(alone_us(lambda: gram._k1_gram_batch(*args), "gram_kernel"))
            else:
                wb = int(key.split("=")[1])
                turns[key].append(alone_us(lambda: k4(args, wb), "gram_wb_kernel"))
        bound, by = gram_bound(B, n_pad, N_DIM)
        seen = {k: [v for v in t if v is not None] for k, t in turns.items()}
        med = {k: float(np.median(t)) if t else None for k, t in seen.items()}
        spread = {k: float(max(t) - min(t)) if t else None for k, t in seen.items()}
        timing.append({
            "shape": [B, n_pad, n_pad], "alone_us_turns": turns, "median_us": med,
            "spread_us": spread, "bound_us": 1e3 * bound, "bound_by": by,
            "share_of_bound": {k: 1e3 * bound / v if v else None for k, v in med.items()},
            "k4_wins_beyond_spreads": {
                k: med["K1"] - med[k] > spread["K1"] + spread[k]
                if seen["K1"] and seen[k] else None for k in keys[1:]},
            "k4_plan": {f"wb={wb}": gram._wb_info(2.5, B, n_pad, N_DIM, wb) for wb in wbs},
        })
    args = inputs(bench_kernel(bk), N_WALKERS // 2, N_PAD)
    ms = cuda_ms(lambda: k4(args, 5))
    k1_ms = cuda_ms(lambda: gram._k1_gram_batch(*args))
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(*args))
    bound, by = gram_bound(N_WALKERS // 2, N_PAD, N_DIM)
    resources = {name: [{"entry": e, "registers": r, "spill_bytes": sp, "static_smem_bytes": m}
                        for e, r, sp, m in _ptxas_entries(key)]
                 for name, key in (("K4", "gram_wb_kernel"), ("K1 and K2", "11gram_kernel"))}
    resources["k4_plan"] = {f"n_pad={n_pad} d={d}": gram._wb_info(2.5, 256, n_pad, d, 8)
                            for n_pad, d in ((N_PAD, N_DIM), (BATCH_PAD, N_DIM), (256, 40),
                                             (1024, 40), (2048, N_DIM))}
    resources["blocks_per_sm"] = {
        f"{name} d={d}": [gram._blocks_per_sm(name, nu, d) for nu in (0.5, 1.5, 2.5, math.inf)]
        for name in ("K1", "K2", "K4") for d in (N_DIM, 40)}

    # the route: did this run find K4 faster beyond both spreads at each
    # (n_pad, d) it sends to K4, for every timed number of walkers?
    route = []
    for (n_pad, d), wb in sorted(gram._K4_ROUTE.items()):
        won = {str(t["shape"]): t["k4_wins_beyond_spreads"].get(f"K4 wb={wb}")
               for t in timing if t["shape"][1] == n_pad and d == N_DIM}
        route.append({"n_pad_d": [n_pad, d], "wb": wb, "k4_wins_in_this_run": won})
    # (g) the batched LML through each routed (n_pad, d) on the batch
    # ask's data: K4's grams, within phase 5's float64 bound
    from bask_tpu_torch.ops import linalg

    _, yb = batch_dataset()
    kernel = bench_kernel(bk)
    for r in route:
        n_pad, d = r["n_pad_d"]
        n_obs = BATCH_OBS if n_pad == BATCH_PAD else N_OBS
        if (n_pad, d) not in ((BATCH_PAD, N_DIM), (N_PAD, N_DIM)):
            raise AssertionError(f"phase 11 has no data for the routed (n_pad, d) {r}")
        yp = np.zeros(n_pad)
        yp[:n_obs] = (yb[:n_obs] - yb[:n_obs].mean()) / yb[:n_obs].std()
        thetas = 0.05 * np.random.RandomState(2).randn(BATCH_WALKERS // 2, kernel.n_theta)
        thetas[:, -1] += np.log(0.05)
        Xn, _ = data[(n_pad, d)]
        mask = np.arange(n_pad) < n_obs

        def lml(dtype, th=thetas, Xn=Xn, yp=yp, mask=mask, n_obs=n_obs):
            t = [torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in (th, Xn, yp, np.full(len(yp), 1e-6))]
            return linalg.batched_lml(kernel, *t, torch.as_tensor(mask, device=dev), n_real=n_obs)

        before = gram.fused_masked_gram_wb_batch.launches
        via_k4 = lml(torch.float32)
        r["k4_launches_in_lml"] = gram.fused_masked_gram_wb_batch.launches - before
        ref = lml(torch.float64)
        r["lml_max_abs_err_vs_f64"] = float((via_k4.double() - ref).abs().max())
        r["lml_within_phase5_bound"] = bool(
            ((via_k4.double() - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)).all())
    if not all(r["k4_launches_in_lml"] == 1 and r["lml_within_phase5_bound"] for r in route):
        raise AssertionError(f"the LML through the K4 route misses float64: {route}")

    # (h) the port's bench_gram_wb.py, the path that reaches K4
    bench = _load_script("bench_gram_wb")
    for fn in _kernel_counters().values():
        fn.launches = 0
    script = [bench.run(wb, 20) for wb in (2, 5)]
    launches = _counts()
    report("phase 11 K4 walker-batched gram", to_float64=to_f64, to_k1=to_k1,
           same_across_b_and_wb=same, tf32_control=control,
           device_ops_per_call=ops_per_call, alone=timing, ms=ms, k1_ms=k1_ms,
           plain_ms=plain_ms, bound_ms=bound, bound_by=by, resources=resources,
           route=route, bench_gram_wb=script, launches=launches)
    if launches["K4"] == 0:
        raise AssertionError("scripts/bench_gram_wb.py did not launch K4")
    row = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": None, "route": route,
           "alone_us": [{"shape": t["shape"], "median_us": t["median_us"],
                         "spread_us": t["spread_us"]} for t in timing]}
    return row, launches



# -- phase 12: meshes, the row-sharded Cholesky, the multi-process runtime --

# the row-sharded LML at full width: n = 32,768 in 15-D, nb 256, 4 strips
ROW_OBS, ROW_STRIPS, ROW_NB = 32768, 4, 256
# row-mode BayesGPR on a (2 walkers x 2 rows) mesh of the card
RM_OBS, RM_WALKERS, RM_STEPS, RM_QUERIES, RM_DRAWS = 8192, 16, 6, 1000, 4
# the multiple of the dense float32 path's own error against float64 that
# the row path may reach in (c), fixed before the first run (PERF.md section 6)
RM_ERR_MULTIPLE = 4.0


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _row_data(n, seed, dev, dtype):
    """(X, y, alpha, mask) of n points in [0, 1]^15 (a noisy bowl, y
    standardized), no padding."""
    import torch

    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n, N_DIM))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(n)
    y = (y - y.mean()) / y.std()

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return t(X), t(y), t(np.full(n, 1e-6)), torch.ones(n, dtype=torch.bool, device=dev)


def _strip_gram(kernel, theta, X, alpha, mask, rows=4096):
    """The (n, n) masked gram assembled from row strips of the sweep's own
    strip builder (never more than one strip of temporaries)."""
    import torch

    from bask_tpu_torch.ops import dist_chol

    n = X.shape[0]
    K = torch.empty((n, n), dtype=X.dtype, device=X.device)
    for r0 in range(0, n, rows):
        s = slice(r0, r0 + rows)
        K[s] = dist_chol._gram_strip(kernel, theta, X, X[s], alpha[s], mask, mask[s], r0)
    return K


def _chol_lml(K, y):
    """LML through cholesky_ex and one triangular solve (-inf where not PD)."""
    import torch

    L, info = torch.linalg.cholesky_ex(K)
    if int(info) > 0:
        return -math.inf
    w = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    n = K.shape[0]
    return float(-0.5 * (w * w).sum() - torch.log(L.diagonal()).sum()
                 - 0.5 * n * math.log(2 * math.pi))


def phase12_walkers(dev):
    """(a) batched_lml(mesh=) over [cuda:0] x P against the unsharded call at
    the north-star shape and at the batch ask's (K4 per shard); launch
    counts per shard; one warm tell of Optimizer(mesh=) against the
    unsharded one."""
    import torch

    from bask_tpu_torch import Optimizer
    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.ops import linalg
    from bask_tpu_torch.parallel.mesh import Mesh

    out, checks = {}, {}

    def args_of(X, y, n_obs, n_pad, thetas, dtype):
        Xp = np.full((n_pad, N_DIM), 0.5)
        Xp[:n_obs] = X
        yp = np.zeros(n_pad)
        yp[:n_obs] = y
        t = [torch.as_tensor(a, dtype=dtype, device=dev)
             for a in (thetas, Xp, yp, np.full(n_pad, 1e-6))]
        return t + [torch.as_tensor(np.arange(n_pad) < n_obs, device=dev)]

    kernel = bench_kernel(bk)
    X, y = bench_dataset()
    thetas = 0.05 * np.random.RandomState(1).randn(N_WALKERS, kernel.n_theta)
    thetas[:, -1] += np.log(0.05)
    a32 = args_of(X, y, N_OBS, N_PAD, thetas, torch.float32)
    ref = _uncounted(lambda: linalg.batched_lml(kernel, *a32, n_real=N_OBS))
    ref64 = _uncounted(lambda: linalg.batched_lml(
        kernel, *args_of(X, y, N_OBS, N_PAD, thetas, torch.float64)))
    bound = 1e-5 * torch.clamp(ref64.abs(), min=1.0)  # phase 5's float64 bound
    for P in (1, 2, 4):
        mesh = Mesh([dev] * P, ("walkers",))
        before = _counts()
        got = linalg.batched_lml(kernel, *a32, n_real=N_OBS, mesh=mesh)
        torch.cuda.synchronize()
        per = _since(before)
        out[f"north star P={P}"] = {
            "bit_equal": bool(torch.equal(got, ref)),
            "max_abs_diff": float((got - ref).abs().max()),
            "max_abs_err_vs_f64": float((got.double() - ref64).abs().max()),
            "launches_per_shard": {k: v / P for k, v in per.items()},
        }
        checks[f"north star P={P} within phase 5's float64 bound"] = bool(
            ((got.double() - ref64).abs() <= bound).all())
        if P <= 2:  # each shard's gram and GEMMs keep their sizes' kernels
            checks[f"north star P={P} bit-equal to the unsharded call"] = bool(
                torch.equal(got, ref))
        gram_k = _shared_x_gram()
        checks[f"north star P={P}: {gram_k} and K3 in every shard"] = (
            per[gram_k] == P and per["K3"] == 4 * P)
    Xb, yb = batch_dataset()
    yb = (yb - yb.mean()) / yb.std()
    tb = 0.05 * np.random.RandomState(2).randn(BATCH_WALKERS, kernel.n_theta)
    tb[:, -1] += np.log(0.05)
    b32 = args_of(Xb, yb, BATCH_OBS, BATCH_PAD, tb, torch.float32)
    refb = _uncounted(lambda: linalg.batched_lml(kernel, *b32, n_real=BATCH_OBS))
    refb64 = _uncounted(lambda: linalg.batched_lml(
        kernel, *args_of(Xb, yb, BATCH_OBS, BATCH_PAD, tb, torch.float64)))
    before = _counts()
    gotb = linalg.batched_lml(kernel, *b32, n_real=BATCH_OBS, mesh=Mesh([dev] * 2))
    torch.cuda.synchronize()
    per = _since(before)
    boundb = 1e-5 * torch.clamp(refb64.abs(), min=1.0)
    out["batch ask P=2"] = {
        "bit_equal": bool(torch.equal(gotb, refb)),
        "max_abs_diff": float((gotb - refb).abs().max()),
        "max_abs_err_vs_f64": float((gotb.double() - refb64).abs().max()),
        "unsharded_max_abs_err_vs_f64": float((refb.double() - refb64).abs().max()),
        "launches_per_shard": {k: v / 2 for k, v in per.items()},
    }
    checks["batch ask P=2 within the float64 bound"] = bool(
        ((gotb.double() - refb64).abs() <= boundb).all())
    checks["batch ask P=2 bit-equal to the unsharded call"] = bool(torch.equal(gotb, refb))
    gram_k = _shared_x_gram(BATCH_PAD)
    checks[f"batch ask P=2: {gram_k} and K3 in every shard"] = (
        per[gram_k] == 2 and per["K1"] + per["K4"] == 2 and per["K3"] == 16)

    # one warm tell, sharded over [cuda:0] x 2 and not, from one seed
    def objective(x, rng):
        return float(np.sum((np.asarray(x) - 0.5) ** 2) + 0.05 * rng.randn())

    def tell(mesh):
        rng = np.random.RandomState(2)
        opt = Optimizer(
            dimensions=[(0.0, 1.0)] * N_DIM, n_points=N_CAND, n_initial_points=N_OBS,
            random_state=0, device=dev, dtype=torch.float32, mesh=mesh, acq_func="ei",
            gp_sample_kwargs={"until_rhat": None},
        )
        opt.tell(X.tolist(), [objective(x, rng) for x in X], n_samples=8)
        x = opt.ask()
        t0 = time.perf_counter()
        opt.tell(x, objective(x, rng), n_samples=8)
        torch.cuda.synchronize()
        return {"warm_tell_s": time.perf_counter() - t0, "next": opt.ask(),
                "chain": opt.gp.chain_}

    # the unsharded tell is the reference: its launches are not the path's
    tells = {"unsharded": _uncounted(lambda: tell(None)),
             "mesh [cuda:0] x 2": tell(Mesh([dev] * 2, ("walkers",)))}
    a, b = tells["unsharded"], tells["mesh [cuda:0] x 2"]
    out["optimizer warm tell"] = {
        "same_next_ask": bool(np.array_equal(a["next"], b["next"])),
        "next_ask_max_abs_diff": float(np.abs(np.asarray(a["next"]) - np.asarray(b["next"])).max()),
        "chain_max_abs_diff": float(np.abs(a["chain"] - b["chain"]).max()),
        "warm_tell_s": {k: v["warm_tell_s"] for k, v in tells.items()},
    }
    checks["sharded tell: finite chain, next ask inside the bounds"] = bool(
        np.isfinite(b["chain"]).all() and all(0.0 <= v <= 1.0 for v in b["next"]))
    return out, checks


def phase12_rows(dev):
    """(b) the row-sharded LML at n = 32,768, d = 15, nb 256 on 4 strips of
    the card against the dense float32 port path and a float64 dense
    factor; unroll both ways; a non-PD theta; times, peak memory, K3
    launches per sweep; the same LML through a world-size-1 NCCL mesh; K3
    at the row path's block against cholesky_ex + solve_triangular."""
    import torch

    from bask_tpu_torch.ops import chol_base, dist_chol, linalg
    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.parallel import distributed
    from bask_tpu_torch.parallel.mesh import Mesh

    out, checks = {}, {}
    kernel = bench_kernel(bk)
    X, y, alpha, mask = _row_data(ROW_OBS, 5, dev, torch.float32)
    theta = torch.as_tensor(kernel.theta0, dtype=torch.float32, device=dev)
    mesh = Mesh([dev] * ROW_STRIPS, ("rows",))

    def row(unroll, m=mesh, th=theta, Xr=X, al=alpha):
        return dist_chol.row_sharded_lml(kernel, th, Xr, y, al, mask, m, nb=ROW_NB,
                                         unroll=unroll)

    torch.cuda.reset_peak_memory_stats(dev)
    sweeps = {}
    for unroll in (False, True):
        before = _counts()
        v = float(row(unroll))
        torch.cuda.synchronize()
        sweeps[unroll] = {"lml": v, "k3_launches": _since(before)["K3"]}
    row_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # the references (none of them counted): the dense float32 port path
    # (K1's gram, blocked K3), the float64 dense factor and float32
    # cholesky_ex of the sweep's own strip gram, and the sweep with TF32
    # matmuls, a control that the limit must reject
    torch.cuda.reset_peak_memory_stats(dev)
    dense = _uncounted(lambda: float(linalg.batched_lml(
        kernel, theta[None], X, y, alpha, mask, n_real=ROW_OBS)[0]))
    dense_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    K32 = _strip_gram(kernel, theta, X, alpha, mask)
    chol32 = _chol_lml(K32, y)
    del K32
    X64, y64, a64 = X.double(), y.double(), alpha.double()
    K64 = _strip_gram(kernel, theta.double(), X64, a64, mask)
    lml64 = _chol_lml(K64, y64)
    del K64
    torch.cuda.empty_cache()

    def tf32_sweep():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return float(row(True))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    tf32 = _uncounted(tf32_sweep)
    # twice cholesky_ex's float32 error at this theta (phase 10's rule),
    # at least twice the float32 spacing at the LML: a float32 result
    # carries half a spacing of rounding however it was computed
    spacing = float(np.spacing(np.float32(abs(lml64))))
    limit = max(2.0 * spacing, 2.0 * abs(chol32 - lml64))
    for unroll, s in sweeps.items():
        s["err_vs_f64"] = abs(s["lml"] - lml64)
        checks[f"row LML unroll={unroll} within twice cholesky_ex's float32 error"] = (
            math.isfinite(s["lml"]) and s["err_vs_f64"] <= limit)
    checks["unroll=True and False give the same row LML"] = (
        sweeps[True]["lml"] == sweeps[False]["lml"])
    # the dense path's gram comes from K1, not the sweep's strip builder
    checks["row LML within the limit of the dense float32 path"] = (
        abs(sweeps[True]["lml"] - dense) <= limit)
    checks["the TF32 sweep misses the limit"] = not abs(tf32 - lml64) <= limit  # NaN misses
    # a non-PD theta: every point twice, no jitter, no noise
    Xd = torch.cat([X[: ROW_OBS // 2], X[: ROW_OBS // 2]])
    th_bad = theta.clone()
    th_bad[-1] = -math.inf
    bad = float(row(True, th=th_bad, Xr=Xd, al=torch.zeros_like(alpha)))
    checks["non-PD theta gives -inf with no raise"] = bad == -math.inf
    # times (CUDA events, not counted): the sweep and the dense path
    times = _uncounted(lambda: {
        "row sweep": cuda_ms(lambda: row(True), reps=2),
        "dense float32 (K1 + blocked K3)": cuda_ms(
            lambda: linalg.batched_lml(kernel, theta[None], X, y, alpha, mask,
                                       n_real=ROW_OBS), reps=2),
    })
    # world size 1: one strip through the NCCL process group, bit-equal to
    # the in-process one-entry mesh (the reference, not counted)
    one = _uncounted(lambda: float(row(True, m=Mesh([dev], ("rows",)))))
    rank, world = distributed.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                               local_device_ids=[dev.index or 0])
    try:
        gmesh = distributed.global_walker_mesh("rows")
        nccl = float(row(True, m=gmesh))
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
    checks["world-size-1 NCCL mesh bit-equal to the in-process one"] = nccl == one
    # K3 on the row path: the (256, 256) diagonal block by the recursion
    # on two 128 bases, against cholesky_ex + solve_triangular
    blk = torch.as_tensor(_spd_batch(np.random.RandomState(4), 1, ROW_NB)[0],
                          dtype=torch.float32, device=dev)
    eye = torch.eye(ROW_NB, device=dev)

    def library():
        L, _ = torch.linalg.cholesky_ex(blk)
        return L, torch.linalg.solve_triangular(L, eye, upper=False)

    base = blk[:128, :128].contiguous()
    k3 = _uncounted(lambda: {
        "block_ms": cuda_ms(lambda: dist_chol._factor_block(blk)),
        "base_ms": cuda_ms(lambda: chol_base.chol_inv_base(base)),
        "base_plain_ms": cuda_ms(lambda: chol_base.chol_inv_plain(base)),
        "library_block_ms": cuda_ms(library),
    })
    L, Linv = _uncounted(lambda: dist_chol._factor_block(blk))
    Lr, _ = chol_base.chol_inv_plain(blk.double())
    k3["block_err"] = float((L.double() - Lr).abs().max())
    m = 128
    k3["base_bound_ms"], k3["base_bound_by"] = bound_ms(
        4 * (m * (m + 1) // 2 + 2 * m * m), 2 * m**3 / 3)
    k3["launches_per_sweep"] = sweeps[True]["k3_launches"]
    checks["K3 launches on the row sweep (2 per panel)"] = all(
        s["k3_launches"] == 2 * ROW_OBS // ROW_NB for s in sweeps.values())
    checks["K3 block within 5e-6 x 2 of float64"] = k3["block_err"] <= 1e-5
    out.update(
        n=ROW_OBS, strips=ROW_STRIPS, nb=ROW_NB, sweeps={str(k): v for k, v in sweeps.items()},
        dense_f32=dense, dense_err_vs_f64=abs(dense - lml64), lml_f64=lml64,
        cholesky_ex_f32=chol32, f32_spacing=spacing, limit=limit,
        tf32_sweep={"lml": tf32, "err_vs_f64": abs(tf32 - lml64)}, non_pd=bad, ms=times,
        peak_gb={"row sweeps": row_peak_gb, "dense float32": dense_peak_gb},
        world_size_1={"rank": rank, "world": world, "nccl": nccl, "in_process": one},
        k3_row_block=k3,
    )
    return out, checks


def phase12_row_model(dev):
    """(c) row-mode BayesGPR on a (2 walkers x 2 rows) mesh of the card, n =
    8,192, d = 15: gradients at the start theta (adjoint, jvp, dense
    float32) against float64; an ML-II warm start (adjoint) and a short
    chain; predict at 1,000 queries and 4 consensus draws from given
    normals against the dense float32 model, each held to
    RM_ERR_MULTIPLE x the dense float32 model's own error against float64."""
    import torch

    from bask_tpu_torch.models import bayesgpr as tbg
    from bask_tpu_torch.models import gp as gpc
    from bask_tpu_torch.ops import dist_chol
    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.parallel.mesh import Mesh

    out, checks = {}, {}
    rng = np.random.RandomState(6)
    X = rng.uniform(size=(RM_OBS, N_DIM))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(RM_OBS)
    mesh = Mesh([[dev, dev], [dev, dev]], ("walkers", "rows"))
    user = bench_kernel(bk).k1  # C * Matern(2.5); fit appends the White

    def model(dtype, row_mesh=None, **kw):
        return tbg.BayesGPR(kernel=user, random_state=0, normalize_y=True, device=dev,
                            dtype=dtype, row_mesh=row_mesh, row_nb=256, **kw)

    def limit(err32, scale):
        return max(1e-5 * max(1.0, scale), RM_ERR_MULTIPLE * err32)

    # gradients at the start theta
    gp = model(torch.float32, mesh)
    gp._spec = user + bk.WhiteKernel(1.0, (1e-5, 1e5))
    gp._set_data(X, y, None)
    t0 = gp._spec.theta0
    ref64 = model(torch.float64)
    ref64._spec = gp._spec
    ref64._set_data(X, y, None)
    g64 = -_uncounted(lambda: tbg._log_post_value_grad(ref64._data, ref64._tensor(t0),
                                                       gp._spec, (), 0))[1]
    g32 = -_uncounted(lambda: tbg._log_post_value_grad(gp._data, gp._tensor(t0), gp._spec,
                                                       (), 0))[1]
    grads, gsec = {}, {}
    for method in ("adjoint", "jvp"):
        s0 = time.perf_counter()
        _, g = dist_chol.row_sharded_lml_value_grad(
            gp._spec, gp._tensor(t0), gp._data.X, gp._data.y, gp._data.alpha_diag,
            gp._data.mask, mesh, nb=256, method=method)
        torch.cuda.synchronize()
        gsec[method] = time.perf_counter() - s0
        grads[method] = g.double().cpu().numpy()
    err32 = float(np.abs(g32 - g64).max())
    gscale = float(np.abs(g64).max())
    out["gradients"] = {
        "max_abs_err_vs_f64": {"dense float32": err32,
                               **{k: float(np.abs(v - g64).max()) for k, v in grads.items()}},
        "scale": gscale, "limit": limit(err32, gscale), "seconds": gsec,
    }
    for k, v in grads.items():
        checks[f"(c) {k} gradient within the limit"] = (
            float(np.abs(v - g64).max()) <= limit(err32, gscale))
    # the fit: ML-II (adjoint) then 16 walkers x 6 steps
    gp = model(torch.float32, mesh)
    s0 = time.perf_counter()
    gp.fit(X, y, n_desired_samples=RM_WALKERS * RM_STEPS, n_burnin=0,
           n_walkers_per_thread=RM_WALKERS, progress=False, warn_rhat=None)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - s0
    out["chain_shape"] = list(gp.chain_steps_.shape)
    out["consensus_lml"] = gp.log_marginal_likelihood_value_
    checks["(c) row-mode fit: finite theta and consensus LML"] = bool(
        np.isfinite(gp.theta).all() and math.isfinite(gp.log_marginal_likelihood_value_))
    # predict and draws against dense models at the same theta (their
    # refresh factors n = 8,192 on K1 and K3: not counted)
    def dense_model(dtype):
        d = model(dtype)
        d._spec = gp._spec
        d._set_data(X, y, None)
        d.theta = gp.theta
        return d

    dense = {dtype: _uncounted(lambda dtype=dtype: dense_model(dtype))
             for dtype in (torch.float32, torch.float64)}
    Xq = np.random.RandomState(7).uniform(size=(RM_QUERIES, N_DIM))
    s0 = time.perf_counter()
    m_r, s_r = gp.predict(Xq, return_std=True)
    torch.cuda.synchronize()
    out["predict_s"] = time.perf_counter() - s0
    m_32, s_32 = _uncounted(lambda: dense[torch.float32].predict(Xq, return_std=True))
    m_64, s_64 = _uncounted(lambda: dense[torch.float64].predict(Xq, return_std=True))
    pred = {}
    for name, (a, b, a64) in {"mean": (m_r, m_32, m_64), "std": (s_r, s_32, s_64)}.items():
        e32 = float(np.abs(b - a64).max())
        pred[name] = {"row_err": float(np.abs(a - a64).max()), "dense32_err": e32,
                      "row_vs_dense32": float(np.abs(a - b).max()),
                      "limit": limit(e32, float(np.abs(a64).max()))}
        checks[f"(c) predict {name} within the limit"] = pred[name]["row_err"] <= pred[name]["limit"]
    out["predict"] = pred
    # the covariance at 8 of the queries, and 4 consensus draws from one
    # set of normals at one of them: draws at several points go through
    # eigh, whose eigenvectors in a (near) repeated eigenvalue are any
    # basis of its space, so the draws of two factorizations agree
    # elementwise only where the eigenvectors are unique
    Xc = Xq[:8]
    c_r = gp.predict(Xc, return_cov=True)[1]
    c_32 = _uncounted(lambda: dense[torch.float32].predict(Xc, return_cov=True)[1])
    c_64 = _uncounted(lambda: dense[torch.float64].predict(Xc, return_cov=True)[1])
    e32 = float(np.abs(c_32 - c_64).max())
    out["cov"] = {"row_err": float(np.abs(c_r - c_64).max()), "dense32_err": e32,
                  "row_vs_dense32": float(np.abs(c_r - c_32).max()),
                  "limit": limit(e32, float(np.abs(c_64).max()))}
    checks["(c) covariance within the limit"] = out["cov"]["row_err"] <= out["cov"]["limit"]
    Xd = Xq[:1]
    z = np.random.RandomState(8).randn(1, RM_DRAWS)
    theta = gp._tensor(gp.theta)
    td = gpc.noise_free_theta(gp._spec, theta, gp.white_index_)
    dd = gp._data
    row_draws = dist_chol.row_sharded_sample_y(
        gp._spec, theta, dd.X, dd.y, dd.alpha_diag, dd.mask, gp._tensor(Xd), gp._tensor(z), mesh,
        n_samples=RM_DRAWS, nb=256, y_mean=dd.y_mean, y_std=dd.y_std, theta_diag=td,
    ).double().cpu().numpy()

    def dense_draws(d):
        th = d._tensor(d.theta)
        tdd = gpc.noise_free_theta(d._spec, th, d.white_index_)
        return gpc.sample_y(d._spec, tdd, d._post, d._post_data, d._tensor(Xd),
                            d._tensor(z)).double().cpu().numpy()

    d32 = _uncounted(lambda: dense_draws(dense[torch.float32]))
    d64 = _uncounted(lambda: dense_draws(dense[torch.float64]))
    e32 = float(np.abs(d32 - d64).max())
    out["draws"] = {"row_err": float(np.abs(row_draws - d64).max()), "dense32_err": e32,
                    "row_vs_dense32": float(np.abs(row_draws - d32).max()),
                    "scale": float(np.abs(d64).max()),
                    "limit": limit(e32, float(np.abs(d64).max()))}
    checks["(c) 4 draws within the limit"] = out["draws"]["row_err"] <= out["draws"]["limit"]
    return out, checks


def phase_mesh(dev):
    """Phase 12: walker sharding (a), the row-sharded LML at full width
    (b), row-mode BayesGPR (c). The launch counts of the paths it drives
    (the sharded LMLs, the sweeps, the row-mode fit, predictions and draws,
    the sharded tell); the references' launches are not counted."""
    import torch

    for fn in _kernel_counters().values():
        fn.launches = 0
    parts, checks = {}, {}
    for name, fn in (("(a) walkers", phase12_walkers), ("(b) rows", phase12_rows),
                     ("(c) row-mode BayesGPR", phase12_row_model)):
        t0 = time.perf_counter()
        out, ch = fn(dev)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        parts[name] = out
        checks.update(ch)
    launches = _counts()
    report("phase 12 meshes and row-sharded Cholesky", launches=launches, **parts)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 12 failed: {failed}")
    return launches, parts["(b) rows"]["k3_row_block"]


# -- phase 13: graphed chains, warmup, the library cache, tabulated priors --

CHAIN_STEPS = 40  # steps of each timed chain of phase 13 (a)
CHAIN_RUNS = 2  # times the four turns (eager, graphed, graphed, eager) run


def _chain_parts(gp, priors=None):
    """(log-probability, ChainGraph, positions, moves) of ``gp``'s chain
    as ``BayesGPR.sample`` builds them (demix, the positions ``pos_``)."""
    from bask_tpu_torch.models import bayesgpr as tbg

    resolved = gp._resolve_priors(priors)
    warp = gp._resolve_warp_priors(None)
    n_warp = gp._n_warp()
    log_prob = tbg._make_log_prob_batch(gp._spec, resolved, gp._data, len(gp._y_orig), warp,
                                        n_warp)
    graph = gp._chain_graph(resolved, warp, n_warp, None, None)
    return log_prob, graph, gp._tensor(gp.pos_), tbg._MOVE_ALIASES["demix"]


def _run_chain(parts, graphed, steps, seed=5):
    from bask_tpu_torch.parallel import mcmc

    log_prob, graph, pos, moves = parts
    old, mcmc.CHAIN_GRAPHS = mcmc.CHAIN_GRAPHS, ("on" if graphed else "off")
    try:
        return mcmc.run_ensemble(log_prob, pos, seed, steps, moves=moves, graph=graph)
    finally:
        mcmc.CHAIN_GRAPHS = old


def _chain_ms(parts, graphed, steps=CHAIN_STEPS):
    """Milliseconds per step of one chain of ``steps`` steps, host clock to
    a synchronize (the chain's eager first log-probability included)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run_chain(parts, graphed, steps)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def _profiled_retry(fn, tries=3):
    """``profiled(fn, wall=True)``, repeated where the session recorded no
    device operation (PERF.md section 7); (ops, seconds) of the last try."""
    for _ in range(tries):
        _, ops, seconds = profiled(fn, wall=True)
        if ops:
            break
    return ops, seconds


def _busy(parts, graphed, steps=10):
    """(the card's busy share: device time over wall time, device
    operations per step) of a ``steps``-step chain under the profiler."""
    ops, seconds = _profiled_retry(lambda: _run_chain(parts, graphed, steps))
    return sum(e.device_time for e in ops) / (1e6 * seconds), len(ops) / steps


def _replay_kernels(parts, move="de"):
    """The device operations of one replay of the graph of ``move`` of
    this chain's configuration: (count, kernel names)."""
    from bask_tpu_torch.parallel import mcmc
    from bask_tpu_torch.utils import graphs

    _, graph, pos, _ = parts
    key = mcmc._entry_key(graph, *pos.shape, pos.dtype, pos.device)
    branch = graphs.CHAIN[key].branches[mcmc._branch_key(move, 2.0)]
    ops, _ = _profiled_retry(branch.step.graph.replay)
    return len(ops), sorted({e.name for e in ops})


def first_tell_child(mode: str, cache: str) -> int:
    """``python3 chip_smoke.py --first-tell cold|warm CACHE``: a fresh
    process that loads the kernel library from the cache ``CACHE``
    (counting nvcc runs), then, with ``warm``, runs ``warmup_optimizer``
    for the bucket of N_OBS, then the bench problem's cold tell and three
    warm tells (``_drive_optimizer``); prints one JSON line with the
    seconds and the graphs captured at each stage."""
    import torch

    from bask_tpu_torch import enable_aot_cache, warmup_optimizer
    from bask_tpu_torch.ops import _cuda
    from bask_tpu_torch.parallel import mcmc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    nvcc_runs = []
    real_popen, real_run = _cuda.subprocess.Popen, _cuda.subprocess.run

    class Counted:  # _cuda's view of subprocess: every nvcc it starts is counted
        def __getattr__(self, name):
            return getattr(subprocess, name)

        @staticmethod
        def Popen(args, *a, **k):
            nvcc_runs.append(args[0])
            return real_popen(args, *a, **k)

        @staticmethod
        def run(args, *a, **k):
            nvcc_runs.append(args[0])
            return real_run(args, *a, **k)

    _cuda.subprocess = Counted()
    enable_aot_cache(cache)
    torch.zeros(1, device=dev)  # the CUDA context, outside the load
    t0 = time.perf_counter()
    _cuda.library()
    load_s = time.perf_counter() - t0
    stages = {}

    def warm_up(opt):
        t0 = time.perf_counter()
        warmup_optimizer(opt, [N_OBS])
        torch.cuda.synchronize()
        stages["warmup_s"] = time.perf_counter() - t0
        stages["captures_in_warmup"] = mcmc.graph_stats["captures"]

    _, cold_s, _, warm_s, _ = _drive_optimizer(dev, before_tell=warm_up if mode == "warm" else None)
    print("first tell child: " + json.dumps(dict(
        mode=mode, library_built=_cuda.build_info["built"], library_load_s=load_s,
        nvcc_runs=len(nvcc_runs), first_tell_s=cold_s, warm_tell_s=warm_s,
        captures=mcmc.graph_stats["captures"], replays=mcmc.graph_stats["replays"], **stages,
    )), flush=True)
    return 0


def _first_tell(mode, cache):
    out = subprocess.run([sys.executable, __file__, "--first-tell", mode, cache],
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("first tell child: ")]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"first-tell child ({mode}) failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("first tell child: "):])


def phase_tooling(opt, warped_opt, dev):
    """(a) chain ms per step, graphed against eager in turns, on phase 6's
    unwarped model (K4 + K3) and phase 7's warped one with LOWER_GRAM on
    (K2 + K3), at the north-star shape, with the card's busy share; (b)
    the replayed chains bit-equal to the eager ones (same seed, demix),
    and one replay of each under the profiler naming its kernels; (c), (d)
    and (f) in two fresh processes: the first tell (the cold tell) with and
    without ``warmup_optimizer``, no graph captured after the warmup, the
    warm tells with graphs; (e) those processes load the kernel library
    from the cache this process filled by ``enable_aot_cache`` (after its
    phase 1 build), running no nvcc; (g) the chain with an opaque prior
    tabulated on the device (``host_prior_mode="interp"``), graphed, beside
    the same chain eager and the lifted prior's; (h) one warm tell of the
    warped model (its chain replayed, K6 in each replay, its candidate grid
    on K7). Returns the graphed chains' launch counts (replays times
    launches per capture) and the chains' numbers."""
    import shutil
    import tempfile
    import warnings

    import scipy.stats as sps
    import torch

    from bask_tpu_torch import disable_aot_cache, enable_aot_cache
    from bask_tpu_torch.ops import _cuda, gram
    from bask_tpu_torch.parallel import mcmc

    built = dict(_cuda.build_info)
    configs = {"unwarped": (opt.gp, "off"), "warped, LOWER_GRAM on": (warped_opt.gp, "on")}
    chains, equal, launches = {}, {}, {k: 0 for k in _kernel_counters()}
    for name, (gp, lower) in configs.items():
        gram.LOWER_GRAM = lower
        try:
            parts = _chain_parts(gp)
            _uncounted(lambda: _run_chain(parts, False, 2))  # allocator, handles
            before = _counts()
            _run_chain(parts, True, 2)  # captures here, unless an earlier phase did
            turns = {"eager": [], "graphed": []}
            for _ in range(CHAIN_RUNS):
                for kind in ("eager", "graphed", "graphed", "eager"):
                    graphed = kind == "graphed"
                    run = lambda: _chain_ms(parts, graphed)  # noqa: E731
                    turns[kind].append(run() if graphed else _uncounted(run))
            c_g, f_g = _run_chain(parts, True, 20, seed=9)
            c_e, f_e = _uncounted(lambda: _run_chain(parts, False, 20, seed=9))
            equal[name] = bool(torch.equal(c_g, c_e) and torch.equal(f_g.log_prob, f_e.log_prob)
                               and int(f_g.accepted) == int(f_e.accepted))
            busy_g, ops_g = _busy(parts, True)
            busy_e, ops_e = _uncounted(lambda: _busy(parts, False))
            n_ops, names = _replay_kernels(parts)
            for k, v in _since(before).items():
                launches[k] += v
        finally:
            gram.LOWER_GRAM = "off"
        chains[name] = {
            "path": "graphed" if parts[1] is not None else "eager (no graph for this model)",
            "ms_per_step": {k: [float(np.median(v)), v] for k, v in turns.items()},
            "speedup": float(np.median(turns["eager"]) / np.median(turns["graphed"])),
            "busy_share": {"graphed": busy_g, "eager": busy_e},
            "device_ops_per_step": {"graphed": ops_g, "eager": ops_e},
            "replay_device_ops": n_ops, "replay_kernels": names,
        }

    # (c)-(f): the library cache, filled from this process's loaded build
    cache = tempfile.mkdtemp(prefix="bask_aot_")
    try:
        enable_aot_cache(cache)
        children = {mode: _first_tell(mode, cache) for mode in ("cold", "warm")}
    finally:
        disable_aot_cache()
        shutil.rmtree(cache, ignore_errors=True)
    warm_child = children["warm"]

    # (g) an opaque NumPy prior tabulated on the device, on phase 6's model
    gp = opt.gp
    opaque = [lambda x: -0.125 * float(np.square(x))] * gp._spec.n_theta
    lifted = [sps.norm(0.0, 2.0).logpdf] * gp._spec.n_theta
    mode, gp.host_prior_mode = gp.host_prior_mode, "interp"
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tab_parts = _chain_parts(gp, opaque)
            max_err = sum(p.__tabulated__[3] for p in gp._resolve_priors(opaque))
            gp.host_prior_mode = "callback"
            host_parts = _chain_parts(gp, opaque)
    finally:
        gp.host_prior_mode = mode
    lift_parts = _chain_parts(gp, lifted)
    before = _counts()
    _run_chain(tab_parts, True, 2)
    _run_chain(lift_parts, True, 2)
    tabulated = {
        "path": "graphed" if tab_parts[1] is not None else "eager",
        "host_adapter_path": "graphed" if host_parts[1] is not None else "eager",
        "ms_per_step_graphed": _chain_ms(tab_parts, True),
        "ms_per_step_eager": _uncounted(lambda: _chain_ms(tab_parts, False)),
        "lifted_ms_per_step_graphed": _chain_ms(lift_parts, True),
    }
    for k, v in _since(before).items():
        launches[k] += v
    # (h) one warm tell of phase 7's warped model with LOWER_GRAM on: its
    # chain replayed from the graph (K2, K3 and K6 in each replay), its
    # candidate grid unwarped by K7
    gram.LOWER_GRAM = "on"
    try:
        objective = _bowl(np.random.RandomState(6))
        before = _counts()
        x = warped_opt.ask()
        t0 = time.perf_counter()
        warped_opt.tell(x, objective(x))
        torch.cuda.synchronize()
        warped_tell_s = time.perf_counter() - t0
        for k, v in _since(before).items():
            launches[k] += v
    finally:
        gram.LOWER_GRAM = "off"
    # the tabulated log posterior against the exact one (host adapter) at
    # the model's walkers: within the tables' summed midpoint errors (twice)
    # and the float32 rounding of the sums (8 spacings of the largest value)
    lp_tab, lp_host = tab_parts[0](tab_parts[2]), host_parts[0](tab_parts[2])
    tabulated["max_abs_logprob_diff_vs_host"] = float((lp_tab - lp_host).abs().max())
    tabulated["limit"] = 2.0 * max_err + 8.0 * 2.0**-23 * float(lp_host.abs().max())
    report(
        "phase 13 graphed chains, warmup, library cache, tabulated priors",
        chains=chains, replay_bit_equal=equal, first_tell=children,
        library={"phase 1": {"built": built.get("built"), "seconds": built.get("seconds")},
                 "cache load in a second process": {
                     "built": warm_child["library_built"], "seconds": warm_child["library_load_s"],
                     "nvcc_runs": warm_child["nvcc_runs"]}},
        tabulated_prior=tabulated, warped_warm_tell_s=warped_tell_s, launches=launches,
        graph_stats=dict(mcmc.graph_stats),
    )
    checks = {
        "both chains graphed": all(c["path"] == "graphed" for c in chains.values()),
        "replays bit-equal to the eager chains": all(equal.values()),
        "unwarped replay runs K4 and K3": any("gram_wb_kernel" in n for n in
                                              chains["unwarped"]["replay_kernels"])
        and any("chol_inv_kernel" in n for n in chains["unwarped"]["replay_kernels"]),
        "warped replay runs K2 and K3": any("gram_kernel" in n and "gram_wb" not in n
                                            for n in chains["warped, LOWER_GRAM on"]["replay_kernels"])
        and any("chol_inv_kernel" in n for n in chains["warped, LOWER_GRAM on"]["replay_kernels"]),
        "no capture after warmup_optimizer": warm_child["captures"]
        == warm_child["captures_in_warmup"],
        "the children load the cached library without nvcc": all(
            not c["library_built"] and c["nvcc_runs"] == 0 for c in children.values()),
        "tabulated chain graphed, host adapter eager": tabulated["path"] == "graphed"
        and tabulated["host_adapter_path"] == "eager",
        "tabulated log-prob near the exact one": tabulated["max_abs_logprob_diff_vs_host"]
        <= tabulated["limit"],
        "K4 and K3 replayed": launches["K4"] > 0 and launches["K3"] > 0 and launches["K2"] > 0,
        "warped replay runs K6": any("::warp_kernel" in n for n in
                                     chains["warped, LOWER_GRAM on"]["replay_kernels"]),
        "K6 launched": launches["K6"] > 0,
        "K7 launched": launches["K7"] > 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 13 failed: {failed}")
    return launches, chains


# -- phase 14: the factorization route in the chain's graph, the fused
# acquisition switch, the example scripts on the card --

ROUTES = ("auto", "off")  # linalg.FAST_CHOLESKY's values A/B'd in phase 14 (a)
ROUTE_TURNS = ("auto", "off", "off", "auto")
ROUTE_STEPS = 30  # steps of each graphed chain timed in phase 14 (a)
ROUTE_RUNS = 2  # times the graphed turns run (the eager turns run once)
ROUTE_EAGER_STEPS = 8  # steps of each eager chain timed in phase 14 (a)
# phase 5's float32 LML limit: 1e-5 of max(1, |LML|) at float64
LML_REL_TOL = 1e-5
# the example scripts run as children in phase 14 (c), at their default sizes
EXAMPLE_TIMEOUT_S = 600


def _with_route(value, fn):
    """``fn()`` with ``linalg.FAST_CHOLESKY`` at ``value``, put back after."""
    from bask_tpu_torch.ops import linalg

    old, linalg.FAST_CHOLESKY = linalg.FAST_CHOLESKY, value
    try:
        return fn()
    finally:
        linalg.FAST_CHOLESKY = old


def _per_replay(parts):
    """{kernel: launches per replay} of each move of this chain's graphs
    under the current route (the counts each capture recorded)."""
    from bask_tpu_torch.parallel import mcmc
    from bask_tpu_torch.utils import graphs

    _, graph, pos, _ = parts
    entry = graphs.CHAIN[mcmc._entry_key(graph, *pos.shape, pos.dtype, pos.device)]
    return {move[0]: {k: dict(br.step.launches).get(f, 0) for k, f in _kernel_counters().items()}
            for move, br in entry.branches.items()}


def _route_lmls(gp):
    """The batched LML of the chain's positions at each route in float32
    on the card (the routed gram), at float64 on the card (the plain gram,
    ``cholesky_ex``), and cond(K) in float64 at the walker where "off"
    errs most."""
    import torch

    from bask_tpu_torch.ops import linalg

    d, n_real = gp._data, len(gp._y_orig)
    thetas = gp._tensor(gp.pos_)
    out = {v: _with_route(v, lambda: linalg.batched_lml(
        gp._spec, thetas, d.X, d.y, d.alpha_diag, d.mask, n_real=n_real)).double().cpu().numpy()
        for v in ROUTES}
    ref = linalg.batched_lml(gp._spec, thetas.double(), d.X.double(), d.y.double(),
                             d.alpha_diag.double(), d.mask, n_real=n_real).cpu().numpy()
    worst = int(np.argmax(np.abs(out["off"] - ref)))
    K = linalg.masked_gram(gp._spec, thetas[worst].double(), d.X.double(),
                           d.alpha_diag.double(), d.mask)[:n_real, :n_real]
    ev = torch.linalg.eigvalsh(K)
    return out, ref, float(ev[-1] / ev[0])


def phase_route_ab(models):
    """(a) ``linalg.FAST_CHOLESKY`` "auto" (the blocked factorization, K3
    bases) against "off" (``cholesky_ex`` and a triangular solve: cuSOLVER
    and cuBLAS) inside the chain's CUDA graph, for each model of
    ``models`` (name -> fitted BayesGPR): ms per step graphed in turns
    and eager, the card's busy share, device operations and K3 launches
    per replay, the graphed "off" chain bit-equal to the eager one, and
    both routes' LMLs of the chain's positions against float64. Returns
    (report, launches of the graphed chains)."""
    import torch

    launches = {k: 0 for k in _kernel_counters()}
    out = {}
    for name, gp in models.items():
        parts = _chain_parts(gp)
        before = _counts()
        for v in ROUTES:  # the allocator and handles, then each route's captures
            _with_route(v, lambda: _uncounted(lambda: _run_chain(parts, False, 2)))
            _with_route(v, lambda: _run_chain(parts, True, 2))
        graphed = {v: [] for v in ROUTES}
        eager = {v: [] for v in ROUTES}
        for _ in range(ROUTE_RUNS):
            for v in ROUTE_TURNS:
                graphed[v].append(_with_route(v, lambda: _chain_ms(parts, True, ROUTE_STEPS)))
        for v in ROUTE_TURNS:
            eager[v].append(_with_route(v, lambda: _uncounted(
                lambda: _chain_ms(parts, False, ROUTE_EAGER_STEPS))))
        c_g, f_g = _with_route("off", lambda: _run_chain(parts, True, 12, seed=9))
        c_e, f_e = _with_route("off", lambda: _uncounted(
            lambda: _run_chain(parts, False, 12, seed=9)))
        off_equal = bool(torch.equal(c_g, c_e) and torch.equal(f_g.log_prob, f_e.log_prob)
                         and int(f_g.accepted) == int(f_e.accepted))
        busy, replay, per_replay = {}, {}, {}
        for v in ROUTES:
            busy[v] = _with_route(v, lambda: _busy(parts, True))
            replay[v] = _with_route(v, lambda: _replay_kernels(parts))
            per_replay[v] = _with_route(v, lambda: _per_replay(parts))
        for k, n in _since(before).items():
            launches[k] += n
        lmls, ref, cond = _uncounted(lambda: _route_lmls(gp))
        err = {v: np.abs(lmls[v] - ref) for v in ROUTES}
        # phase 5's limit at every walker; where cond(K) makes float32 miss
        # it, the route's largest error over the batch within twice the
        # other route's (phase 10's rule, the blocked route against the
        # float32 cholesky_ex route, over the batch: per walker, either
        # route's rounding can be the luckier one)
        base = LML_REL_TOL * np.maximum(1.0, np.abs(ref))
        within = {v: bool((e <= base).all() or e.max() <= 2.0 * err[w].max())
                  for (v, e), w in zip(err.items(), ROUTES[::-1])}
        med = {v: float(np.median(t)) for v, t in graphed.items()}
        out[name] = {
            "walkers_n_pad_d": [int(parts[2].shape[0]), int(gp._data.X.shape[0]),
                                int(gp._data.X.shape[1])],
            "path": "graphed" if parts[1] is not None else "eager (no graph for this model)",
            "graphed_ms_per_step": {v: [med[v], t] for v, t in graphed.items()},
            "eager_ms_per_step": {v: [float(np.median(t)), t] for v, t in eager.items()},
            "off_over_auto_graphed": med["off"] / med["auto"],
            "busy_share_graphed": {v: b[0] for v, b in busy.items()},
            "device_ops_per_step_graphed": {v: b[1] for v, b in busy.items()},
            "replay_device_ops": {v: r[0] for v, r in replay.items()},
            "replay_kernels": {v: r[1] for v, r in replay.items()},
            "launches_per_replay": per_replay,
            "graphed_off_bit_equal_to_eager": off_equal,
            "lml_max_abs_err": {v: float(e.max()) for v, e in err.items()},
            "lml_within_limit": {v: bool(np.isfinite(lmls[v]).all()) and within[v]
                                 for v in ROUTES},
            "lml_within_phase5_limit": {v: int((e <= base).sum()) for v, e in err.items()},
            "walkers": int(len(ref)), "lml_phase5_limit_min": float(base.min()),
            "cond_k_at_worst_off_walker": cond,
        }
    return out, launches


def phase_switch_tells(opt, dev):
    """(b) phase 6's warm tell at "auto" against "off", in turns, then one
    PVRS tell with ``acquisition.FUSED_ACQUISITION`` "off" on a copy of the
    Optimizer (``save_optimizer``/``load_optimizer``) beside the same tell
    fused on another copy: the legacy dispatcher runs and the next asks
    are equal. Returns (report, launches of the tells)."""
    import tempfile

    import torch

    from bask_tpu_torch import acquisition as acq_mod
    from bask_tpu_torch.utils import serialization

    objective = _bowl(np.random.RandomState(14))
    before = _counts()
    tells = {v: [] for v in ROUTES}
    for v in ROUTE_TURNS:
        x = opt.ask()
        y = objective(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _with_route(v, lambda: opt.tell(x, y))
        torch.cuda.synchronize()
        tells[v].append(time.perf_counter() - t0)
    launches = _since(before)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/opt.npz"
        serialization.save_optimizer(opt, path)
        fused, legacy = (serialization.load_optimizer(path, device=dev) for _ in range(2))
    x = fused.ask()
    same_start = list(x) == list(legacy.ask())
    y = objective(x)
    calls = []
    real = acq_mod.evaluate_acquisitions

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    seconds = {}
    for name, o in (("fused", fused), ("legacy", legacy)):
        old = acq_mod.FUSED_ACQUISITION
        acq_mod.FUSED_ACQUISITION = "on" if name == "fused" else "off"
        acq_mod.evaluate_acquisitions = counted
        try:
            t0 = time.perf_counter()
            _uncounted(lambda: o.tell(x, y))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            if name == "fused":
                fused_calls = len(calls)
        finally:
            acq_mod.FUSED_ACQUISITION = old
            acq_mod.evaluate_acquisitions = real
    report_ = {
        "n": len(opt.yi), "warm_tell_s": {v: [float(np.median(t)), t] for v, t in tells.items()},
        "fused_acquisition_off": {
            "tell_s": seconds, "legacy_dispatcher_calls": {"fused": fused_calls,
                                                           "off": len(calls) - fused_calls},
            "same_start": same_start, "next_ask_equal": list(fused.ask()) == list(legacy.ask()),
        },
    }
    return report_, launches


_EXAMPLE_NUMBERS = {
    "warmup_s": r"warmup \(buckets \[[0-9, ]*\]\): ([0-9.]+)s",
    "total_s": r"[0-9]+ iterations: ([0-9.]+)s total",
    "median_warm_iteration_s": r"median warm iteration ([0-9.]+)s",
    "first_fitted_iteration_s": r"first fitted iteration ([0-9.]+)s",
    "best_y": r"best y=(-?[0-9.]+)",
}


def _example(script, env):
    """A child process running ``examples/<script>`` with no arguments (the
    card, the default sizes)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, os.path.join(root, "examples", script)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=root)


def _finish(proc, t0):
    """(exit status, stdout, stderr, wall seconds) of a child; one past its
    time limit is killed."""
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0


def phase_examples():
    """(c) ``examples/torch_production_loop.py`` in a child process, alone,
    with a fresh library cache filled from this process's build (so it
    loads the library, as every process after the first does), then
    ``torch_optimize_1d.py`` and ``torch_fit_gp.py`` side by side; each
    must exit 0 with its summary. Returns the report."""
    import os
    import re
    import shutil
    import tempfile

    from bask_tpu_torch import disable_aot_cache, enable_aot_cache

    import torch

    torch.cuda.empty_cache()  # the card's memory for the children
    cache = tempfile.mkdtemp(prefix="bask_aot_")
    try:
        enable_aot_cache(cache)
        disable_aot_cache()
        env = dict(os.environ, BASK_TPU_AOT_CACHE=cache)
        runs = {}
        t0 = time.perf_counter()
        runs["torch_production_loop.py"] = _finish(_example("torch_production_loop.py", env), t0)
        t0 = time.perf_counter()
        procs = {s: _example(s, env) for s in ("torch_optimize_1d.py", "torch_fit_gp.py")}
        for s, proc in procs.items():
            runs[s] = _finish(proc, t0)
        cached = sorted(os.listdir(cache))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    out = {}
    for script, (rc, stdout, stderr, wall) in runs.items():
        lines = stdout.splitlines()
        out[script] = {"exit": rc, "wall_s": wall, "last_lines": lines[-3:]}
        if rc != 0:
            out[script]["stderr_tail"] = stderr[-1500:]
    loop = runs["torch_production_loop.py"][1]
    numbers = {}
    for key, pattern in _EXAMPLE_NUMBERS.items():
        m = re.search(pattern, loop)
        numbers[key] = float(m.group(1)) if m else None
    out["torch_production_loop.py"]["numbers"] = numbers
    out["cache_files"] = cached
    one_d = runs["torch_optimize_1d.py"][1]
    out["torch_optimize_1d.py"]["best_observed"] = (re.findall(r"best observed: .*", one_d)
                                                    or [None])[0]
    out["torch_fit_gp.py"]["predictions"] = runs["torch_fit_gp.py"][1].count("pred=")
    return out


def phase_switches(opt, batch_gp, dev):
    """Phase 14: (a) the factorization route's A/B inside the chain's
    graph at phase 6's and phase 8's models; (b) warm tells at each route
    and a tell with the fused acquisition off; (c) the example scripts on
    the card. Returns the launch counts of (a) and (b)."""
    import torch

    models = {f"north-star ({N_WALKERS}, {N_PAD}, {N_DIM})": opt.gp,
              f"batch ask ({BATCH_WALKERS}, {BATCH_PAD}, {N_DIM})": batch_gp}
    backend = str(torch.backends.cuda.preferred_linalg_library())
    ab, launches = phase_route_ab(models)
    tells, tell_launches = phase_switch_tells(opt, dev)
    for k, n in tell_launches.items():
        launches[k] += n
    examples = phase_examples()
    report("phase 14 factorization routes in the chain's graph, fused acquisition off, "
           "example scripts", linalg_backend=backend, route_ab=ab, tells=tells,
           examples=examples, launches=launches)
    checks = {}
    for name, r in ab.items():
        checks[f"{name}: both routes graphed"] = r["path"] == "graphed"
        checks[f"{name}: no K3 in an 'off' replay"] = all(
            c["K3"] == 0 for c in r["launches_per_replay"]["off"].values())
        checks[f"{name}: K3 in every 'auto' replay"] = all(
            c["K3"] > 0 for c in r["launches_per_replay"]["auto"].values())
        checks[f"{name}: 'off' replays cuSOLVER's factorization"] = any(
            "potrf" in k for k in r["replay_kernels"]["off"])
        checks[f"{name}: graphed 'off' chain bit-equal to the eager one"] = r[
            "graphed_off_bit_equal_to_eager"]
        for v in ROUTES:
            checks[f"{name}: '{v}' LMLs within the float64 limit"] = r["lml_within_limit"][v]
    fa = tells["fused_acquisition_off"]
    checks["FUSED_ACQUISITION off: the legacy dispatcher ran"] = (
        fa["legacy_dispatcher_calls"]["fused"] == 0 and fa["legacy_dispatcher_calls"]["off"] > 0)
    checks["FUSED_ACQUISITION off: the next ask equals the fused one"] = (
        fa["same_start"] and fa["next_ask_equal"])
    for script in ("torch_production_loop.py", "torch_optimize_1d.py", "torch_fit_gp.py"):
        checks[f"{script} exits 0"] = examples[script]["exit"] == 0
    checks["the production loop prints its numbers"] = all(
        v is not None and math.isfinite(v)
        for v in examples["torch_production_loop.py"]["numbers"].values())
    checks["torch_fit_gp.py prints 11 predictions"] = examples["torch_fit_gp.py"][
        "predictions"] == 11
    checks["route A/B and tells launched K3"] = launches["K3"] > 0
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 14 failed: {failed}")
    return launches


# -- phase 15: the input warp on K6 and K7 (csrc/warp.cu); the warped
# batch ask at full width --

# K6 and K7 against their plain versions in float64 on the same inputs,
# by type: the largest |difference| of the warp (values in [0, 1]) and
# the relative difference of the pdf K6 writes for the backward; the
# unwarp's x (in [0, 1]) within UNWARP_TOL of the float64 root, or its
# float64 CDF within WARP_TOL of z (where the pdf is near 0, as at z = 1
# with b > 1, a float32 CDF reaches 1 a visible distance before x does,
# and x is only as exact as the CDF; where the pdf is large, x is as exact
# as its type); set from readings on an H100 (PERF.md).
# tests/test_torch_cuda.py holds the same.
WARP_TOL = {"float32": 3e-6, "float64": 5e-15}
PDF_RTOL = {"float32": 5e-5, "float64": 1e-13}
UNWARP_TOL = {"float32": 1e-6, "float64": 2e-15}
# the controls that must miss WARP_TOL: the plain continued fraction cut to
# this many terms (12 terms are ~2e-7 off in the prior's 5-sigma range, far
# outside the float64 limit but inside float32's own rounding, so the
# float32 limit is held against 6 terms, ~8e-5 off); K7's limit is held
# against the plain unwarp with these CDFs in its probes, and against the
# float64 plain unwarp stopped at CONTROL_STEPS of its 62 bisection steps
# over the bit patterns, whose last bracket near 1 (2^-9, 2^-33) is wider
# than UNWARP_TOL
CONTROL_TERMS = {"float32": 6, "float64": 12}
CONTROL_STEPS = {"float32": 18, "float64": 42}
# the published peaks of one H100 SXM outside the tensor cores by type
# (NVIDIA's datasheet), for K6's and K7's bounds
FLOPS = {"float32": F32_FLOPS, "float64": 34e12}


def _warp_case(dev, dtype, shape, rows, seed):
    """X (or Z) of ``shape`` uniform in [0, 1] (on the bench or batch data
    where ``shape`` is theirs), its first entries at 0, 1e-12, 1 - 1e-12
    and 1 and two past the ends, and log-parameters of ``rows`` rows
    (``()``: one pair per column) uniform over the warp prior's 5-sigma
    range [-1.5, 1.5]."""
    import torch

    rng = np.random.RandomState(seed)
    X = rng.uniform(size=shape)
    if shape[-2:] == (N_PAD, N_DIM):
        X = padded(bench_dataset()[0])
    elif shape[-2:] == (BATCH_PAD, N_DIM):
        X = np.full(shape, 0.5)
        X[:BATCH_OBS] = batch_dataset()[0]
    X.reshape(-1)[:6] = [0.0, 1e-12, 1.0 - 1e-12, 1.0, -0.25, 1.25]
    la, lb = (rng.uniform(-1.5, 1.5, rows + (shape[-1],)) for _ in range(2))
    return [torch.tensor(a, dtype=getattr(torch, dtype), device=dev) for a in (X, la, lb)]


def _once_ms(fn):
    """Milliseconds of one ``fn()`` by CUDA events, no warm-up run (for
    the plain versions at the ask's sizes, seconds each)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _ops_and_alone(fn, key, reps=3, tries=3):
    """(device operations per ``fn()``, the names of any that are not the
    kernel ``key``, median device microseconds of the kernel) from one
    profiler session of ``reps`` calls, repeated where the session
    recorded fewer than ``reps`` kernels (a session on the card can come
    back empty or, rarely, short of an event); ``(0, [], None)`` if every
    try recorded nothing."""
    n, ops = 0, []
    for _ in range(tries):
        n, ops = profiled(fn, reps=reps)
        if sum(key in e.name for e in ops) >= reps:
            break
    foreign = sorted({e.name for e in ops if key not in e.name})
    return n, foreign, kernel_us(ops, key)


def k6_check_and_time(dev, dtype, shape, rows, seed, check_rows=None, plain_rows=None):
    """K6 on seeded inputs: against its plain version in float64 (on
    ``check_rows`` of the output, all by default) with the pdf beside it,
    the short continued fraction that must miss the limit, one device
    operation per call (no other operation, at most one a call), the time alone (profiler) and through the wrapper
    (CUDA events), the plain version's time in its own type (in chunks of
    ``plain_rows`` rows where given; None: not timed) and the bound;
    launches uncounted."""
    import torch

    from bask_tpu_torch.ops import warp_values as wv

    X, la, lb = _warp_case(dev, dtype, shape, rows, seed)

    def launch():
        return wv.warp_values(X, la, lb)

    def check():
        out, pdf = wv.warp_values(X, la, lb, with_pdf=True)
        xs, las, lbs = X, la, lb
        if check_rows is not None:  # rows of a (B, ...) output
            out, pdf, las, lbs = out[check_rows], pdf[check_rows], la[check_rows], lb[check_rows]
            xs = X if X.ndim == 2 else X[check_rows]
        x64, la64, lb64 = xs.double(), las.double(), lbs.double()
        ref = wv.warp_plain(x64, la64, lb64)
        err = float((out.double() - ref).abs().max())
        pdf_ref = wv.beta_pdf_plain(x64, la64, lb64)
        ok = torch.isfinite(pdf_ref) & (pdf_ref > 1e-30)
        pdf_err = float(((pdf.double() - pdf_ref) / pdf_ref)[ok].abs().max())
        a, b = wv.ab(la64, lb64)
        control = wv.betainc(a, b, x64.clamp(0.0, 1.0), CONTROL_TERMS[dtype])
        control_err = float((control - ref).abs().max())
        return err, pdf_err, control_err, bool(torch.isfinite(out).all())

    err, pdf_err, control_err, finite = _uncounted(check)
    ops_per_call, foreign, alone = _uncounted(lambda: _ops_and_alone(launch, "::warp_kernel"))
    ms = _uncounted(lambda: cuda_ms(launch, reps=5))
    out_shape = torch.broadcast_shapes(X.shape, la.shape[:-1] + (1, X.shape[-1]))
    entries = math.prod(out_shape)
    plain_ms = None
    if plain_rows is not None:

        def plain_in_chunks():
            for lo in range(0, la.shape[0], plain_rows):
                wv.warp_plain(X, la[lo:lo + plain_rows], lb[lo:lo + plain_rows])

        plain_ms = _once_ms(plain_in_chunks)
    elif entries <= 1 << 23:
        plain_ms = cuda_ms(lambda: wv.warp_plain(X, la, lb), reps=3)
    item = X.element_size()
    n_bytes = item * (X.numel() + la.numel() + lb.numel() + entries)
    operations = _load_script("kernel_costs").k6_operations(entries)
    bound, by = bound_ms(n_bytes, operations, FLOPS[dtype])
    tol = WARP_TOL[dtype]
    return {"dtype": dtype, "shape": list(out_shape), "x_shape": list(X.shape),
            "checked_rows": "all" if check_rows is None else list(check_rows),
            "max_abs_err": err, "tol": tol, "pdf_max_rel_err": pdf_err,
            "pdf_rtol": PDF_RTOL[dtype], "control_terms": CONTROL_TERMS[dtype],
            "control_max_abs_err": control_err, "device_ops_per_call": ops_per_call,
            "other_device_ops": foreign,
            "ms": ms, "alone_ms": None if alone is None else alone / 1e3, "plain_ms": plain_ms,
            "plain_in_chunks_of_rows": plain_rows, "bound_ms": bound, "bound_by": by,
            "bytes": n_bytes, "operations": operations, "library_ms": None,
            "ok": finite and err <= tol and pdf_err <= PDF_RTOL[dtype] and control_err > tol
            and 0 < ops_per_call <= 1 and not foreign}


def unwarp_share(x, ref, Z, la, lb, dtype):
    """The largest share of K7's limit over the entries of ``x``, an unwarp
    of ``Z`` held to the float64 root ``ref``: per entry the smaller of
    |x - ref| / UNWARP_TOL and |CDF64(x) - clamp(z)| / WARP_TOL (at most 1
    passes)."""
    import torch

    from bask_tpu_torch.ops import warp_values as wv

    x, la, lb = x.double(), la.double(), lb.double()
    dx = (x - ref).abs() / UNWARP_TOL[dtype]
    resid = (wv.warp_plain(x, la, lb) - Z.double().clamp(0.0, 1.0)).abs() / WARP_TOL[dtype]
    return float(torch.minimum(dx, resid).max())


def k7_check_and_time(dev, dtype, m, seed, check_limit=8192, chunk=4096, plain=True):
    """K7 on a seeded (m, 15) grid of z with one (a, b) per column, as the
    Optimizer's candidate grid: against its plain version in float64 on
    the first ``check_limit`` rows (in chunks of ``chunk``) through
    :func:`unwarp_share`, with the two controls that must miss the same
    limit (the plain unwarp with short CDFs in its probes, and stopped
    early); one device operation per call, the time alone and through the
    wrapper, the plain version's time in its own type over all rows in the
    same chunks, once (``plain``), and the bound; launches uncounted."""
    import torch

    from bask_tpu_torch.ops import warp_values as wv

    Z, la, lb = _warp_case(dev, dtype, (m, N_DIM), (), seed)

    def launch():
        return wv.unwarp_values(Z, la, lb)

    def check():
        out = wv.unwarp_values(Z, la, lb)
        la64, lb64 = la.double(), lb.double()
        err = share = short_cdf = early = 0.0
        for lo in range(0, min(m, check_limit), chunk):
            z64 = Z[lo:lo + chunk].double()
            ref = wv.unwarp_plain(z64, la64, lb64)
            err = max(err, float((out[lo:lo + chunk].double() - ref).abs().max()))
            share = max(share, unwarp_share(out[lo:lo + chunk], ref, z64, la, lb, dtype))
            control = wv.unwarp_plain(z64, la64, lb64, terms=CONTROL_TERMS[dtype])
            short_cdf = max(short_cdf, unwarp_share(control, ref, z64, la, lb, dtype))
            control = wv.unwarp_plain(z64, la64, lb64, CONTROL_STEPS[dtype])
            early = max(early, unwarp_share(control, ref, z64, la, lb, dtype))
        return err, share, short_cdf, early, bool(torch.isfinite(out).all())

    def plain_in_chunks():
        for lo in range(0, m, chunk):
            wv.unwarp_plain(Z[lo:lo + chunk], la, lb)

    err, share, short_cdf, early, finite = _uncounted(check)
    ops_per_call, foreign, alone = _uncounted(lambda: _ops_and_alone(launch, "unwarp_kernel"))
    ms = _uncounted(lambda: cuda_ms(launch, reps=3))
    plain_ms = _once_ms(plain_in_chunks) if plain else None
    entries = m * N_DIM
    n_bytes = Z.element_size() * (2 * entries + la.numel() + lb.numel())
    steps = wv.full_steps(Z.dtype)
    ops = _load_script("kernel_costs").k7_operations(entries, steps)
    bound, by = bound_ms(n_bytes, ops, FLOPS[dtype])
    tol = UNWARP_TOL[dtype]
    return {"dtype": dtype, "shape": [m, N_DIM], "steps": steps,
            "checked_rows": min(m, check_limit), "max_abs_err": err, "tol": tol,
            "tol_rule": "|dx| <= UNWARP_TOL or |CDF64(x) - z| <= WARP_TOL",
            "largest_share_of_limit": share,
            "control_short_cdf_share": short_cdf, "control_terms": CONTROL_TERMS[dtype],
            "control_early_share": early, "control_steps": CONTROL_STEPS[dtype],
            "device_ops_per_call": ops_per_call, "other_device_ops": foreign, "ms": ms,
            "alone_ms": None if alone is None else alone / 1e3, "plain_ms": plain_ms,
            "plain_in_chunks_of_rows": chunk, "bound_ms": bound, "bound_by": by,
            "bytes": n_bytes, "operations": ops, "library_ms": None,
            "ok": finite and share <= 1.0 and short_cdf > 1.0 and early > 1.0
            and 0 < ops_per_call <= 1 and not foreign}


def phase_warp_kernels(dev):
    """15 (a): K6 at the chain's half-batch (50, 512, 15) from shared X,
    the draws' training X (256, 1,024, 15), a ragged per-row (64, 999, 7)
    and the batch ask's queries (256, 65,536, 15) (checked on 4 rows); K7 at
    (500, 15) and (65,536, 15); each at float32 and float64, against
    float64, timed, with nvcc's registers and spills."""
    k6, k7 = [], []
    for dtype in ("float32", "float64"):
        k6.append(k6_check_and_time(dev, dtype, (N_PAD, N_DIM), (N_WALKERS // 2,), 20))
        k6.append(k6_check_and_time(dev, dtype, (BATCH_PAD, N_DIM), (BATCH_WALKERS,), 21))
        k6.append(k6_check_and_time(dev, dtype, (64, 999, 7), (64,), 22))
        k6.append(k6_check_and_time(dev, dtype, (BATCH_CAND, N_DIM), (BATCH_K,), 23,
                                    check_rows=list(CHECK_DRAWS),
                                    plain_rows=4 if dtype == "float32" else None))
        k7.append(k7_check_and_time(dev, dtype, N_CAND, 24))
        k7.append(k7_check_and_time(dev, dtype, BATCH_CAND, 25, plain=dtype == "float32"))

    def ptxas(key, skip=None):
        return [{"entry": e, "registers": r, "spill_bytes": sp}
                for e, r, sp, _ in _ptxas_entries(key) if skip is None or skip not in e]

    out = {"k6": k6, "k7": k7, "ptxas": {"k6": ptxas("warp_kernel", skip="unwarp"),
                                         "k7": ptxas("unwarp_kernel")}}
    report("phase 15 (a) K6 and K7 alone", **out)
    failed = [(c["dtype"], c["shape"]) for c in k6 + k7 if not c["ok"]]
    if failed:
        raise AssertionError(f"K6/K7 failed their checks at {failed}")
    return out


def _draws_f64_warped(gp, spec, rows, rand, Xq):
    """The pathwise draws of warped ``rows`` (one each) recomputed in
    float64: each row's warp of the training points and the queries by
    the plain version, the plain gram and cholesky_ex, the same randoms."""
    import torch

    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.models import warping as twp
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import warp_values as wv

    d = gp._data
    data = d._replace(y=d.y.double(), alpha_diag=d.alpha_diag.double())
    out = []
    for i in range(rows.shape[0]):
        row = rows[i].double()
        theta, la, lb = twp.split_warp_params(row[None], N_DIM)
        X64 = wv.warp_plain(d.X.double(), la[0], lb[0])
        Xq64 = wv.warp_plain(Xq.double(), la[0], lb[0])
        K = gram.fused_masked_gram_plain(spec, theta, X64, data.alpha_diag, BATCH_OBS)
        L, _ = torch.linalg.cholesky_ex(K)

        def solve(R, L=L):
            return torch.cholesky_solve(R, L)

        part = pathwise.PathwiseRandoms(*(None if r is None else r[i:i + 1].double() for r in rand))
        out.append(pathwise._draw_values(spec, theta, X64, data._replace(X=X64), solve, Xq64,
                                         part)[0, :, 0])
        del Xq64
    return torch.stack(out)


def phase_warped_batch_ask(dev):
    """15 (b), this slice's path: BASELINE configs[4] with input warping
    (n = 1,000 in 15-D padded to 1,024, 256 walkers, normalized y): a cold
    tell cut to 11 steps with an EI pass over 65,536 warp-density
    candidates, then ``ask(n_points=256)`` twice; K7 for each candidate
    grid, K6 for the chain's per-walker X and the draws' training X and
    queries, K1 for the per-walker grams, K3 for the factorizations, K5
    twice an ask in one chunk (K4 serves only the consensus's shared
    warped X); 4 draws against float64. Returns the launch counts and the
    numbers."""
    import torch

    from bask_tpu_torch import Optimizer
    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    X, y = batch_dataset()
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * N_DIM, (0.05, 2.0), nu=2.5)
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * N_DIM, n_points=BATCH_CAND, n_initial_points=BATCH_OBS,
        gp_kernel=kernel, gp_kwargs={"normalize_y": True, "warp_inputs": True},
        acq_func="ei",
        gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": BATCH_WALKERS},
        random_state=0, device=dev,
    )
    torch.cuda.synchronize()
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
    # a profiled ask and grid (neither counted), the grid and the top-k
    # timed apart
    ask_profile = _uncounted(lambda: _ask_profile(opt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cand = _uncounted(opt._candidate_grid)
    torch.cuda.synchronize()
    ask_profile["candidate_grid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _uncounted(lambda: opt.gp.thompson_argmin_pathwise(
        cand, n_samples=BATCH_K, top_k=2 * BATCH_K, random_state=1, sample_mean=False))
    torch.cuda.synchronize()
    ask_profile["thompson_argmin_pathwise_s"] = time.perf_counter() - t0
    distinct = [len({tuple(p) for p in pts}) for pts in points]
    inside = all(bool(((pts >= 0.0) & (pts <= 1.0)).all()) for pts in points)

    # 4 of 256 warped draws against float64, on a grid and rows as an ask
    # forms them
    gp = opt.gp
    spec = gram.match_fusable(gp._spec)
    grid = gp._tensor(np.random.RandomState(8).uniform(size=(BATCH_CAND, N_DIM)))
    rows = gp._tensor(gp.chain_[np.random.RandomState(9).choice(len(gp.chain_), BATCH_K)])
    rand = gp._pathwise_randoms(spec, 9, 1024, 1, batch=(BATCH_K,))
    keep = list(CHECK_DRAWS)
    _, draws32 = _uncounted(lambda: pathwise.pathwise_topk_hyper(
        spec, rows, gp._data, grid, rand, N_DIM, 8, n_real=BATCH_OBS, keep=keep))
    sub = pathwise.PathwiseRandoms(*(None if r is None else r[keep] for r in rand))
    draws64 = _draws_f64_warped(gp, spec, rows[keep], sub, grid)
    err = (draws32.double() - draws64).abs().max(dim=1).values
    scale = draws64.abs().max(dim=1).values
    tol = DRAW_REL_TOL * scale
    draws_ok = bool((err <= tol).all())
    chunk = pathwise.draws_per_chunk(BATCH_K, BATCH_CAND, N_DIM, N_DIM, 4, warp_on_kernels=True)
    report(
        "phase 15 (b) warped batch ask", n=BATCH_OBS, n_pad=BATCH_PAD, walkers=BATCH_WALKERS,
        candidates=BATCH_CAND, batch=BATCH_K, cold_tell_s=cold_s, ask_s=ask_s,
        last_timings=opt.last_timings_, distinct_points=distinct, inside_bounds=inside,
        launches=per_step, peak_mem_gb=peak_gb, draws_per_chunk=chunk, ask_profile=ask_profile,
        warp_alphas=gp.warp_alphas_.tolist(), warp_betas=gp.warp_betas_.tolist(),
        draws_f64={"draws": keep, "max_abs_err": err.tolist(), "scale": scale.tolist(),
                   "rel_err": (err / scale).tolist(), "tol": tol.tolist(), "ok": draws_ok},
    )
    asks = [per_step[f"ask {i}"] for i in (1, 2)]
    checks = {
        "256 distinct points per ask": distinct == [BATCH_K, BATCH_K],
        "points inside bounds": inside,
        "K1, K3, K5, K6 and K7 launched": all(launches[k] > 0 for k in ("K1", "K3", "K5", "K6",
                                                                       "K7")),
        "the tell's per-walker grams on K1": per_step["tell"]["K1"] > 0,
        "one chunk of 256 draws on K6's route": chunk == BATCH_K,
        "K5 exactly twice in each ask": all(a["K5"] == 2 for a in asks),
        "K6 twice in each ask (training X, queries)": all(a["K6"] == 2 for a in asks),
        "K7 once in each ask (the candidate grid)": all(a["K7"] == 1 for a in asks),
        "K1 and 8 K3 in each ask": all(a["K1"] == 1 and a["K3"] == 8 for a in asks),
        "4 draws agree with float64": draws_ok,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"warped batch-ask phase failed: {failed}")
    return launches, {"cold_tell_s": cold_s, "ask_s": ask_s, "peak_mem_gb": peak_gb,
                      "ask_profile": ask_profile}, opt


def phase_late_ask_profile(opt):
    """15 (c): phase 15 (b)'s warped ask and grid profiled again at the end
    of the run: a profiler session late in this long process can miss the
    device operations of the grid, K7 and its copies (PERF.md section 7),
    which a session early in it records. Nothing counted; reports only."""
    report("phase 15 (c) warped ask profiled late", **_uncounted(lambda: _ask_profile(opt)))


def _warp_events(ops, prefix):
    """The device microseconds of each K7 and K6 launch a profiler session
    recorded, and its first 6 device operations in time order (name, us),
    under keys that start with ``prefix``."""
    first = sorted(ops, key=lambda e: e.time_range.start)[:6]
    return {f"{prefix}k7_us": [e.device_time for e in ops if "unwarp_kernel" in e.name],
            f"{prefix}k6_us": [e.device_time for e in ops if "::warp_kernel" in e.name],
            f"{prefix}first_ops": [[e.name[:40], e.device_time] for e in first]}


def _ask_profile(opt):
    """A profiled ``ask(n_points=BATCH_K)`` of the warped Optimizer ``opt``
    (after a warm-up ask): its device operations and time, the busy share,
    the top kernels, and each K7 and K6 launch it recorded; then the
    candidate grid alone (K7 on NumPy uniforms with its copies to and from
    the card) profiled the same way."""
    ops, wall_s = _profiled_retry(lambda: opt.ask(n_points=BATCH_K))
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    _, grid_ops = profiled(opt._candidate_grid)
    return {"device_ops": len(ops), "device_us": sum(by_name.values()),
            "wall_us": 1e6 * wall_s, "busy_share": sum(by_name.values()) / (1e6 * wall_s),
            "top_kernels_us": [[k[:60], v] for k, v in top], **_warp_events(ops, ""),
            "grid_device_ops": len(grid_ops), **_warp_events(grid_ops, "grid: ")}


def _warp_row(cases, main_shape):
    """The kernels line's numbers of K6 or K7: those of the float32 launch
    at the slice's shape ``main_shape``, every launch timed beside them."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main = next(c for c in cases if c["dtype"] == "float32" and c["shape"] == main_shape)
    limit = {k: main[k] for k in ("tol_rule", "largest_share_of_limit") if k in main}
    return {**{k: main[k] for k in keys}, **limit, "at_shape": main_shape,
            "all_launches": [{k: c[k] for k in ("dtype", "shape", "alone_ms", "tol") + keys}
                             for c in cases]}


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--first-tell":
        return first_tell_child(sys.argv[2], sys.argv[3])
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
    # phase 15 (a), K6 and K7 alone, profiles many short launches: it runs
    # here too, before the fits
    warp_alone = timed("15 (a)", phase_warp_kernels, dev)
    # and 15 (b), the warped batch ask, whose profiled ask should record
    # its grid's K7 (15 (c) profiles it again at the end)
    by_path = {}
    by_path["phase 15 warped batch ask"], _, warped_batch = timed(
        "15 (b)", phase_warped_batch_ask, dev)
    timed("5", phase_lml, dev)
    opt = timed("6", phase_optimizer, dev)
    by_path["phase 7 warped tell"], warped_opt, _ = timed(
        "7", phase_warped_optimizer, dev)
    by_path["phase 8 batch ask"], k1_batch, k4_batch, k3_batch, k5, batch_gp = timed(
        "8", phase_batch_ask, dev)
    by_path["phase 9 polish"] = timed("9", phase_stopping_polish, opt, dev)
    by_path["phase 10 fit options"] = timed("10", phase_fit_options, opt, dev)
    by_path["phase 11 bench_gram_wb"] = k4_path
    by_path["phase 12 meshes"], k3_rows = timed("12", phase_mesh, dev)
    by_path["phase 13 graphed chains"], chains = timed("13", phase_tooling, opt, warped_opt, dev)
    by_path["phase 14 factorization routes"] = timed("14", phase_switches, opt, batch_gp, dev)
    timed("15 (c)", phase_late_ask_profile, warped_batch)
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
         **launches("K3"), **k3, "in_batch_ask_factorization": k3_batch,
         "on_row_path": k3_rows},
        {"name": "K4 walker-batched gram", "route": "cuda",
         "source": "bask_tpu_torch/csrc/gram_wb.cu",
         "replaces": "benchmarks/bench_gram_wb.py:59",
         **launches("K4"), **k4, "at_batch_ask_shapes": k4_batch},
        # no TPU kernel: XLA fused these draws inside the JAX package's
        # jitted pathwise program
        {"name": "K5 pathwise draw values", "route": "cuda",
         "source": "bask_tpu_torch/csrc/pathwise.cu",
         "replaces": "none (XLA's fusion in bask_tpu/models/pathwise.py:54-112 and :130-215)",
         **launches("K5"), **k5},
        # no TPU kernel: XLA fused betainc into the jitted log-probability
        # and compiled the unwarp's bisection into one program
        {"name": "K6 Beta-CDF input warp", "route": "cuda",
         "source": "bask_tpu_torch/csrc/warp.cu",
         "replaces": "none (XLA's fusion of betainc in bask_tpu/models/warping.py:33-37)",
         **launches("K6"), **_warp_row(warp_alone["k6"], [BATCH_K, BATCH_CAND, N_DIM]),
         "ptxas": warp_alone["ptxas"]["k6"]},
        {"name": "K7 Beta-PPF search (unwarp)", "route": "cuda",
         "source": "bask_tpu_torch/csrc/warp.cu",
         "replaces": "none (XLA's fori_loop in bask_tpu/models/warping.py:63-79)",
         **launches("K7"), **_warp_row(warp_alone["k7"], [BATCH_CAND, N_DIM]),
         "ptxas": warp_alone["ptxas"]["k7"]},
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
