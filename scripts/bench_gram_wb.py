#!/usr/bin/env python3
"""K4, the walker-batched gram, against K1 on the problem of
``benchmarks/bench_gram_wb.py`` (the port's counterpart of that script).

Run from the repository root:  python3 scripts/bench_gram_wb.py [wb] [reps]

W, N, D = 50, 512, 15, the kernel
``ConstantKernel(1.0) * Matern([0.3] * 15, nu=2.5) + WhiteKernel(0.05)``,
X and thetas from ``np.random.RandomState(0)`` in that script's order.
First it asserts that K4 (``gram.fused_masked_gram_wb_batch``) with ``wb``
walkers per unit is within 4e-6 max|K| of its float64 plain version (the
bound K1 is held to) and within twice that of K1 (``gram._k1_gram_batch``,
K1 itself). Then it times ``reps`` back-to-back calls of each, with the thetas
moved by ``1e-5 i`` at call ``i`` and every gram summed into one sink (a
full-output read, as the JAX script's scan does), by CUDA events around
the whole loop. Prints the card's name and power limit and one JSON
line. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, N, D = 50, 512, 15


def problem(dev):
    """(spec, thetas, X, alpha) of the JAX script, on ``dev``."""
    import torch

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk

    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    spec = gram.match_fusable(kernel)
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.uniform(size=(N, D)), dtype=torch.float32, device=dev)
    alpha = torch.full((N,), 1e-6, dtype=torch.float32, device=dev)
    thetas = torch.tensor(
        np.log(0.3) + 0.05 * rng.randn(W, kernel.n_theta), dtype=torch.float32, device=dev
    )
    return spec, thetas, X, alpha


def _loop_ms(fn, ths):
    """(milliseconds per call, the sink) of ``fn`` over ``len(ths)``
    back-to-back calls, each gram summed into one sink, after one warm-up
    loop."""
    import torch

    def loop():
        sink = torch.zeros((), dtype=torch.float32, device=ths[0].device)
        for th in ths:
            sink += fn(th).sum()
        return sink

    float(loop())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sink = loop()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(ths), float(sink)


def run(wb: int = 5, reps: int = 100) -> dict:
    """Hold K4 at ``wb`` to float64 and to K1, then time ``reps`` calls of
    each (K4 first, then K1); returns the numbers."""
    import torch

    from bask_tpu_torch.ops import gram

    if not torch.cuda.is_available():
        raise RuntimeError("scripts/bench_gram_wb.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    spec, thetas, X, alpha = problem(dev)
    k4 = gram.fused_masked_gram_wb_batch(spec, thetas, X, alpha, N, wb)
    k1 = gram._k1_gram_batch(spec, thetas, X, alpha, N)
    ref = gram.fused_masked_gram_plain(spec, thetas.double(), X.double(), alpha.double(), N)
    tol = 4e-6 * float(ref.abs().max())
    err = float((k4.double() - ref).abs().max())
    diff = float((k4 - k1).abs().max())
    if not (err <= tol and diff <= 2 * tol):
        raise AssertionError(f"K4 (wb={wb}): {err} from float64, {diff} from K1 (tolerance {tol})")
    del k4, k1, ref
    steps = 1e-5 * torch.arange(reps, dtype=torch.float32, device=dev)
    ths = list(thetas[None] + steps[:, None, None])
    k4_ms, _ = _loop_ms(lambda th: gram.fused_masked_gram_wb_batch(spec, th, X, alpha, N, wb), ths)
    k1_ms, _ = _loop_ms(lambda th: gram._k1_gram_batch(spec, th, X, alpha, N), ths)
    return {"wb": wb, "reps": reps, "shape": [W, N, N], "d": D, "max_abs_err_f64": err,
            "max_abs_diff_k1": diff, "tolerance": tol, "k4_ms_per_call": k4_ms,
            "k1_ms_per_call": k1_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scripts/bench_gram_wb.py: no CUDA device available", file=sys.stderr)
        return 1
    wb = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"card": smi, **run(wb, reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
