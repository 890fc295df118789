#!/usr/bin/env python3
"""K4 of this tree against K4 built from another tree's sources, with K1
beside them, in turns on one card.

Run from the repository root:  python3 scripts/k4_ab.py OTHER_CSRC [rounds]

``OTHER_CSRC`` is another checkout's ``bask_tpu_torch/csrc``, for example
an earlier commit's unpacked with ``git archive`` into a directory that
``.gitignore`` lists (``build/``). Its ``gram*.cu`` are built by one nvcc
into a library of their own; both trees export ``bask_gram_wb_f32`` with
one signature. At the shapes of chip_smoke.py phase 11 ((50, 512, 512),
(128, 1024, 1024) and (256, 1024, 1024), d 15, the bench kernel at
nu 5/2, the bench and batch-ask data), each K4 is first held to the
float64 plain version on four rows (4e-6 max|K|, K1's bound); then K1,
this tree's K4 and the other K4 at each wb are timed alone (torch.profiler
device time, median of 10 launches) in turns: in order, then reversed,
``rounds`` times (2 by default). Prints the card's name and power limit,
the other library's ptxas report for K4, and one JSON line per shape.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# (B, n_pad): the walkers per unit timed for both K4s
SHAPES = {(cs.N_WALKERS // 2, cs.N_PAD): (2, 5),
          (cs.BATCH_WALKERS // 2, cs.BATCH_PAD): (4, 8),
          (cs.BATCH_WALKERS, cs.BATCH_PAD): (4, 8)}


def build_other(csrc: str):
    """(the library built from ``csrc``'s gram*.cu, nvcc's report)."""
    from bask_tpu_torch.ops import _cuda

    _cuda._BUILD.mkdir(parents=True, exist_ok=True)
    so = _cuda._BUILD / "k4_other.so"
    sources = sorted(glob.glob(os.path.join(csrc, "gram*.cu")))
    if not sources:
        raise RuntimeError(f"no gram*.cu under {csrc}")
    proc = subprocess.run(
        [_cuda._nvcc(), _cuda._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas=-v", "-I", csrc, "-o", str(so), *sources],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bask_gram_wb_f32.argtypes = _cuda._SIGNATURES["bask_gram_wb_f32"]
    lib.bask_gram_wb_f32.restype = ctypes.c_int
    return lib, proc.stderr


def main() -> int:
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    if not torch.cuda.is_available():
        print("k4_ab.py: no CUDA device available", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other, report = build_other(sys.argv[1])
    print(json.dumps({"other_k4_ptxas": [
        {"entry": e, "registers": r, "spill_bytes": s, "static_smem_bytes": m}
        for e, r, s, m in cs._ptxas_entries("gram_wb_kernel", report)]}), flush=True)

    dev = torch.device("cuda", 0)
    kernel = cs.bench_kernel(bk, 2.5)
    spec = gram.match_fusable(kernel)
    Xb, _ = cs.batch_dataset()
    Xp = np.full((cs.BATCH_PAD, cs.N_DIM), 0.5)
    Xp[: cs.BATCH_OBS] = Xb
    data = {cs.N_PAD: (cs.padded(cs.bench_dataset()[0]), cs.N_OBS),
            cs.BATCH_PAD: (Xp, cs.BATCH_OBS)}
    rng = np.random.RandomState(21)
    for (B, n_pad), wbs in SHAPES.items():
        Xn, n_real = data[n_pad]
        X = torch.tensor(Xn, dtype=torch.float32, device=dev)
        alpha = torch.full((n_pad,), 1e-6, dtype=torch.float32, device=dev)
        th = torch.tensor(kernel.theta0[None] + 0.2 * rng.randn(B, kernel.n_theta),
                          dtype=torch.float32, device=dev)
        out = torch.empty((B, n_pad, n_pad), dtype=torch.float32, device=dev)

        def other_k4(wb, th=th, X=X, alpha=alpha, out=out, n_pad=n_pad, n_real=n_real, B=B):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = other.bask_gram_wb_f32(
                th.data_ptr(), th.stride(0), 1, 1, cs.N_DIM, X.data_ptr(), 0, alpha.data_ptr(),
                n_real, B, n_pad, cs.N_DIM, 2, wb, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"the other K4 failed: CUDA error {err}")
            return out

        def this_k4(wb, th=th, X=X, alpha=alpha, n_real=n_real):
            return gram.fused_masked_gram_wb_batch(spec, th, X, alpha, n_real, wb)

        rows = [0, B // 3, 2 * B // 3, B - 1]
        ref = gram.fused_masked_gram_plain(spec, th[rows].double(), X.double(), alpha.double(),
                                           n_real)
        tol = 4e-6 * float(ref.abs().max())
        errors = {}
        for name, fn in (("this K4", this_k4), ("other K4", other_k4)):
            for wb in wbs:
                errors[f"{name} wb={wb}"] = float((fn(wb)[rows].double() - ref).abs().max())
        if not all(e <= tol for e in errors.values()):
            raise AssertionError(f"a K4 misses float64 at {(B, n_pad)}: {errors} (tol {tol})")
        del ref
        keys = ["K1"] + [f"{name} wb={wb}" for name in ("this K4", "other K4") for wb in wbs]
        turns = {k: [] for k in keys}
        for _ in range(rounds):
            for key in keys + keys[::-1]:
                if key == "K1":
                    fn, name = (lambda: gram._k1_gram_batch(spec, th, X, alpha, n_real)), "gram_kernel"
                else:
                    wb = int(key.split("=")[1])
                    k4 = this_k4 if key.startswith("this") else other_k4
                    fn, name = (lambda k4=k4, wb=wb: k4(wb)), "gram_wb_kernel"
                _, ops = cs.profiled(fn, reps=10)
                turns[key].append(cs.kernel_us(ops, name))
        bound, by = cs.gram_bound(B, n_pad, cs.N_DIM)
        med = {k: float(np.median(t)) for k, t in turns.items()}
        print(json.dumps({
            "shape": [B, n_pad, n_pad], "d": cs.N_DIM, "card": smi, "alone_us_turns": turns,
            "median_us": med, "spread_us": {k: float(max(t) - min(t)) for k, t in turns.items()},
            "bound_us": 1e3 * bound, "bound_by": by,
            "share_of_bound": {k: 1e3 * bound / v for k, v in med.items()},
            "max_abs_err_f64": errors, "tol": tol,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
