#!/usr/bin/env python3
"""Does a torch.profiler session still see the card after the smoke's
phases 9 and 10, with and without ``BayesGPR.fit``'s progress bar?

Run from the repository root:  python3 scripts/profiler_after_fits.py [arm]

A probe profiles one K1 call with the smoke's ``profiled`` and prints the
device operations the profiler recorded (1 while it sees the card) and
the process's threads. The default arm, ``phases``, drives in this order
``chip_smoke.py``'s phase 6 (the Optimizer at the north-star shape, no
progress bar), phase 9 (the polished tells, diagnostics and stopping
rules, no bar), phase 10 with ``progress=False``, one bare bar from
``utils.progress.get_progress_bar``, and phase 10 with its default
``progress=True`` (a bar per fit, as the smoke runs it), with a probe
before the first step and after each. The other arms each probe, do one
thing, and probe again: ``sleep`` (20 s without device work), ``launches``
(20,000 elementwise launches), ``cublas`` (the first float32 matmul),
``cusolver`` (the first ``cholesky_ex``), ``eigh`` (the first float64
``eigvalsh``); ``late`` runs phase 6 with no probe before it, and
``blas_first`` runs a matmul before the first probe, then phase 6.
Run each arm in its own process: a blind profiler stays blind.

Prints the card's name and power limit first, then the phases' own lines
and one ``probe:`` JSON line per probe. Exits non-zero without a CUDA
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_after_fits.py: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.utils.progress import get_progress_bar

    dev = torch.device("cuda", 0)
    X, _ = smoke.bench_dataset()
    kernel = smoke.bench_kernel(bk)
    theta = kernel.theta0[None].repeat(smoke.N_WALKERS // 2, 0)
    args = (gram.match_fusable(kernel), torch.tensor(theta, dtype=torch.float32, device=dev),
            torch.tensor(smoke.padded(X), dtype=torch.float32, device=dev),
            torch.full((smoke.N_PAD,), 1e-6, dtype=torch.float32, device=dev), smoke.N_OBS)
    probes = []

    def probe(after, seconds=None):
        ops, _ = smoke.profiled(lambda: gram._k1_gram_batch(*args))
        probes.append({"after": after, "device_ops": ops, "step_s": seconds,
                       "threads": sorted(t.name for t in threading.enumerate())})
        print("probe: " + json.dumps(probes[-1]), flush=True)

    def step(label, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        probe(label, time.perf_counter() - t0)
        return out

    def bare_bar():
        bar = get_progress_bar(True, 16)
        for _ in range(2):
            bar.update(8)
        bar.close()

    def matmul():
        a = torch.randn(512, 512, device=dev)
        return a @ a

    def launches():
        x = torch.zeros(1024, device=dev)
        for _ in range(20000):
            x.add_(1.0)

    def cholesky():
        a = torch.eye(512, device=dev)
        return torch.linalg.cholesky_ex(a)

    def eigh():
        return torch.linalg.eigvalsh(torch.eye(512, dtype=torch.float64, device=dev))

    arm = sys.argv[1] if len(sys.argv) > 1 else "phases"
    one_step = {"sleep": lambda: time.sleep(20.0), "launches": launches, "cublas": matmul,
                "cusolver": cholesky, "eigh": eigh}
    if arm == "phases":
        probe("start")
        opt = step("phase 6", smoke.phase_optimizer, dev)
        step("phase 9", smoke.phase_stopping_polish, opt, dev)
        step("phase 10, progress=False", smoke.phase_fit_options, opt, dev, progress=False)
        step("one bare progress bar", bare_bar)
        step("phase 10, progress=True", smoke.phase_fit_options, opt, dev, progress=True)
    elif arm in one_step:
        probe("start")
        step(arm, one_step[arm])
    elif arm == "late":
        step("phase 6, no probe before it", smoke.phase_optimizer, dev)
    elif arm == "blas_first":
        matmul()
        probe("a matmul, then start")
        step("phase 6", smoke.phase_optimizer, dev)
    else:
        print(f"profiler_after_fits.py: unknown arm {arm!r}", file=sys.stderr)
        return 2
    first_blind = next((p["after"] for p in probes if p["device_ops"] != 1), None)
    print(json.dumps({"arm": arm, "probes": len(probes),
                      "first_probe_without_one_device_op": first_blind}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
