#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bask_tpu_torch``) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one result line:

1. the card, torch and CUDA versions, the matmul precision, and the
   build of the two hand-written kernels from ``bask_tpu_torch/csrc``;
2. K1 (fused masked gram, ``csrc/gram.cu``) against its plain PyTorch
   version run in float64 on the same inputs, at the chain's shape
   (50, 512, 512), d = 15, for all four nu, ragged n_real = 500, and with
   per-walker X;
3. K3 (base Cholesky + inverse, ``csrc/chol_base.cu``) against the
   float64 factor, and the NaN contract on a non-PD block;
4. the batched log marginal likelihood at (100, 512, d = 15) on the
   bench dataset, float32 on the card against the port's float64 run on
   the CPU;
5. the Optimizer end to end on the card: a cold tell of 500 points
   (ML-II, then sampling to split R-hat 1.1), three warm ask/tell rounds
   with PVRS, one marginalized EI pass over a 500-point grid; both
   kernels' launch counts over this phase.

No failure is caught: a phase that fails ends the run with a non-zero
exit. Without a CUDA card it exits non-zero at once. The last two lines
are the kernel table and ``{"ok": true, "device": {...}}``.
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


def bench_kernel(bk, nu=2.5):
    base = bk.RBF if nu == math.inf else bk.Matern
    kw = {} if nu == math.inf else {"nu": nu}
    return bk.ConstantKernel(1.0, (0.1, 2.0)) * base(
        tuple([0.3] * N_DIM), (0.05, 2.0), **kw
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))


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
    for nu, Xin in [(nu, Xd) for nu in (0.5, 1.5, 2.5, math.inf)] + [(2.5, Xw)]:
        kernel = bench_kernel(bk, nu)
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
        mode = "per-walker X" if Xin.ndim == 3 else "shared X"
        cases.append({"nu": nu, "mode": mode, "n_real": N_OBS,
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
    ms = cuda_ms(lambda: gram.fused_masked_gram_batch(spec, th, Xd, alpha, N_OBS))
    plain_ms = cuda_ms(lambda: gram.fused_masked_gram_plain(spec, th, Xd, alpha, N_OBS))
    report("phase 2 K1 gram", cases=cases, ms=ms, plain_ms=plain_ms,
           shape=[B, N_PAD, N_PAD])
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    same inputs), at the tolerances of tests/test_pallas_chol_base.py."""
    import torch

    from bask_tpu_torch.ops import chol_base

    rng = np.random.RandomState(0)
    cases, worst = [], 0.0
    for B, m in ((50, 32), (1, 32), (7, 24)):
        A = torch.tensor(_spd_batch(rng, B, m), dtype=torch.float32, device=dev)
        L, Xi = chol_base.chol_inv_base(A)
        Lr, _ = chol_base.chol_inv_plain(A.double())
        torch.cuda.synchronize()
        err_l = float((L.double() - Lr).abs().max())
        eye = torch.eye(m, dtype=torch.float64, device=dev)
        err_x = float((Xi.double() @ Lr - eye).abs().max())
        tril = bool((L == torch.tril(L)).all() and (Xi == torch.tril(Xi)).all())
        ok = err_l < 5e-6 and err_x < 5e-5 and tril
        cases.append({"shape": [B, m, m], "L_err": err_l, "L_bound": 5e-6,
                      "XL_minus_I": err_x, "XL_bound": 5e-5, "ok": ok})
        worst = max(worst, err_l)
        if not ok:
            raise AssertionError(f"K3 disagrees with the float64 factor: {cases[-1]}")
    bad = -torch.eye(32, device=dev).expand(4, 32, 32).contiguous()
    Ln, Xn = chol_base.chol_inv_base(bad)
    nan_ok = bool(torch.isnan(Ln[:, -1, -1]).all() and torch.isnan(Xn[:, -1, -1]).all())
    if not nan_ok:
        raise AssertionError("K3 lost the NaN of a non-PD block")
    A = torch.tensor(_spd_batch(rng, 50, 32), dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: chol_base.chol_inv_base(A))
    plain_ms = cuda_ms(lambda: chol_base.chol_inv_plain(A))
    report("phase 3 K3 chol_base", cases=cases, nan_contract=nan_ok, ms=ms,
           plain_ms=plain_ms, shape=[50, 32, 32])
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    report("phase 4 batched LML", shape=[N_WALKERS, N_PAD, N_DIM],
           lml_range=[float(lml.min()), float(lml.max())],
           max_abs_err=float(err.max()), bound=float(bound.min()), ok=ok, ms=ms)
    if not ok:
        raise AssertionError("batched LML on the card disagrees with float64")


def phase_optimizer(dev):
    """The Optimizer's main path on the card; returns the launch counts."""
    import torch

    from bask_tpu_torch import ExpectedImprovement, Optimizer
    from bask_tpu_torch.acquisition import evaluate_acquisitions_fused
    from bask_tpu_torch.models import gp as gpc
    from bask_tpu_torch.ops import chol_base, gram

    X, _ = bench_dataset()

    def objective(x, rng=np.random.RandomState(2)):
        return float(np.sum((np.asarray(x) - 0.5) ** 2) + 0.05 * rng.randn())

    y = [objective(x) for x in X]
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * N_DIM, n_initial_points=N_OBS,
        random_state=0, device=dev, dtype=torch.float32,
        gp_sample_kwargs={"max_extensions": 4, "extension_steps": 300},
    )
    torch.cuda.reset_peak_memory_stats(dev)
    gram.fused_masked_gram_batch.launches = 0
    chol_base.chol_inv_base.launches = 0
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
    grid = np.random.RandomState(3).uniform(size=(N_CAND, N_DIM))
    t0 = time.perf_counter()
    ei = evaluate_acquisitions_fused(
        grid, gpr=opt.gp, acq=ExpectedImprovement(), n_samples=N_WALKERS
    )
    torch.cuda.synchronize()
    ei_s = time.perf_counter() - t0
    launches = {
        "K1": gram.fused_masked_gram_batch.launches,
        "K3": chol_base.chol_inv_base.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    gp = opt.gp
    acceptance = gp.n_accepted_ / gp.n_proposals_
    lml = gp.log_marginal_likelihood_value_
    # the consensus LML recomputed by the port's float64 CPU path
    data64 = gpc.make_data(
        *(t.detach().cpu().double() for t in (gp._data.X, gp._data.y, gp._data.alpha_diag)),
        gp._data.mask.cpu(), gp._data.y_mean, gp._data.y_std,
    )
    lml64 = float(gpc.log_marginal_likelihood(
        gp._spec, torch.as_tensor(gp.theta, dtype=torch.float64), data64
    ))
    inside = all(0.0 <= v <= 1.0 for x in asks for v in x)
    report(
        "phase 5 optimizer",
        cold_tell_s=cold_s, rhat=rhat, warm_tell_s=warm_s, ei_pass_s=ei_s,
        last_timings=opt.last_timings_, acceptance=acceptance,
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
    phase_device()
    k1 = phase_gram(dev)
    k3 = phase_chol(dev)
    phase_lml(dev)
    launches = phase_optimizer(dev)
    table = [
        {"name": "K1 fused masked gram", "route": "cuda",
         "source": "bask_tpu_torch/csrc/gram.cu",
         "replaces": "bask_tpu/ops/pallas_gram.py:193",
         "launches": launches["K1"], **k1},
        {"name": "K3 base Cholesky + inverse", "route": "cuda",
         "source": "bask_tpu_torch/csrc/chol_base.cu",
         "replaces": "bask_tpu/ops/pallas_chol_base.py:104",
         "launches": launches["K3"], **k3},
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
