#!/usr/bin/env python3
"""K5 of this tree against K5 built from another tree's sources, in turns
on one card.

Run from the repository root:  python3 scripts/k5_ab.py OTHER_CSRC [rounds]

``OTHER_CSRC`` is another checkout's ``bask_tpu_torch/csrc``, for example
an earlier commit's unpacked with ``git archive`` into a directory that
``.gitignore`` lists (``build/``). Its ``pathwise.cu`` is built by one
nvcc (with that directory's headers) into a library of its own; both
trees export ``bask_pathwise_values_f32`` with one signature. Three
launches, on seeded synthetic inputs at the batch ask's query shape
(``chip_smoke.k5_synthetic``: 1,024 features, the batch dataset's 1,000
of 1,024 points, d 15): 256 rows x 65,536 queries at nu 5/2 and at nu 1/2
with R 1, and 256 rows x 8,192 queries at nu 5/2 with R 8. Each K5 is
first held to the float64 plain version on four rows (K5_REL_TOL of the
largest |value|); then both are timed alone (torch.profiler device time,
median of 3 launches) in turns: in order, then reversed, ``rounds`` times
(2 by default). Prints the card's name and power limit, the other
library's ptxas report for K5, and one JSON line per launch. Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# (nu, rows, queries, R)
LAUNCHES = [(2.5, cs.BATCH_K, cs.BATCH_CAND, 1), (0.5, cs.BATCH_K, cs.BATCH_CAND, 1),
            (2.5, cs.BATCH_K, 8192, 8)]
CHECK_ROWS = [0, 85, 170, 255]


def build_other(csrc: str):
    """(the library built from ``csrc``'s pathwise.cu, nvcc's report)."""
    from bask_tpu_torch.ops import _cuda

    _cuda._build_dir.mkdir(parents=True, exist_ok=True)
    so = _cuda._build_dir / "k5_other.so"
    source = os.path.join(csrc, "pathwise.cu")
    if not os.path.exists(source):
        raise RuntimeError(f"no pathwise.cu under {csrc}")
    proc = subprocess.run(
        [_cuda._nvcc(), _cuda._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas=-v", "-I", csrc, "-o", str(so), source],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bask_pathwise_values_f32.argtypes = _cuda._SIGNATURES["bask_pathwise_values_f32"]
    lib.bask_pathwise_values_f32.restype = ctypes.c_int
    return lib, proc.stderr


def main() -> int:
    import torch

    from bask_tpu_torch.ops import pathwise_values as pv

    if not torch.cuda.is_available():
        print("k5_ab.py: no CUDA device available", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other, report = build_other(sys.argv[1])
    print(json.dumps({"other_k5_ptxas": [
        {"entry": e, "registers": r, "spill_bytes": s, "static_smem_bytes": m}
        for e, r, s, m in cs._ptxas_entries("pathwise_", report)]}), flush=True)

    dev = torch.device("cuda", 0)
    for nu, B, m, R in LAUNCHES:
        args = cs.k5_synthetic(dev, nu, B=B, m=m, R=R)
        _, Xq, omega, phase, W, coef, X, inv_ls, V, amp = args
        d, M, n_pad = omega.shape[-1], omega.shape[1], X.shape[0]

        def other_k5(a=args):
            nu_, Xq_, om_, ph_, W_, c_, X_, il_, V_, amp_ = a
            Bq = om_.shape[0]
            out = torch.empty((Bq, Xq_.shape[0], W_.shape[-1]), dtype=torch.float32, device=dev)
            err = other.bask_pathwise_values_f32(
                Xq_.data_ptr(), 0, om_.data_ptr(), ph_.data_ptr(), W_.data_ptr(), c_.data_ptr(),
                X_.data_ptr(), 0, il_.data_ptr(), V_.data_ptr(), amp_.data_ptr(), out.data_ptr(),
                Bq, Xq_.shape[0], om_.shape[1], X_.shape[0], om_.shape[2], W_.shape[-1],
                pv._NU_CODE[nu_], torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"the other K5 failed: CUDA error {err}")
            return out

        def this_k5(a=args):
            return pv.pathwise_values(*a)

        rows = CHECK_ROWS if B > max(CHECK_ROWS) else list(range(min(B, 4)))
        sub = (nu, Xq, omega[rows], phase[rows], W[rows], coef[rows], X, inv_ls[rows], V[rows],
               amp[rows])
        ref = pv.pathwise_values_plain(*(t.double() if torch.is_tensor(t) else t for t in sub))
        tol = cs.K5_REL_TOL * float(ref.abs().max())
        errors = {"this K5": float((this_k5(sub).double() - ref).abs().max()),
                  "other K5": float((other_k5(sub).double() - ref).abs().max())}
        del ref
        if not all(e <= tol for e in errors.values()):
            raise AssertionError(f"a K5 misses float64 at nu {nu}, {(B, m, R)}: {errors} "
                                 f"(tol {tol})")
        keys = ["this K5", "other K5"]
        turns = {k: [] for k in keys}
        for _ in range(rounds):
            for key in keys + keys[::-1]:
                # each launches one kernel, whatever its name in the other tree
                _, ops = cs.profiled(this_k5 if key == "this K5" else other_k5, reps=3)
                turns[key].append(cs.kernel_us(ops, "pathwise_") / 1e3)
        n_real = int((V.abs().sum((0, 2)) != 0).sum())
        n_bytes = sum(t.numel() * t.element_size() for t in args[1:]) + 4 * B * m * R
        costs = cs.k5_costs(B, m, M, n_real, d, R, n_bytes)
        med = {k: float(np.median(t)) for k, t in turns.items()}
        print(json.dumps({
            "nu": nu, "shape": {"rows": B, "queries": m, "features": M, "n_pad": n_pad,
                                "n_real": n_real, "d": d, "R": R},
            "card": smi, "alone_ms_turns": turns, "median_ms": med,
            "spread_ms": {k: float(max(t) - min(t)) for k, t in turns.items()},
            "speedup": med["other K5"] / med["this K5"],
            "bound_ms": costs["bound_ms"],
            "share_of_bound": {k: costs["bound_ms"] / v for k, v in med.items()},
            "computed_from_inputs": {
                "bound_ms_f32": costs["bound_ms_f32"], "mufu_floor_ms": costs["mufu_floor_ms"],
                "wide_share_host_estimate":
                    cs.k5_wide_share(Xq, omega, pv._plan(d, R, nu)["queries_per_block"])},
            "max_abs_err_f64": errors, "tol": tol, "plan": pv._plan(d, R, nu),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
