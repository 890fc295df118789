#!/usr/bin/env python3
"""Profile the warped chain of the PyTorch port on one CUDA card.

Run from the repository root:  python3 scripts/profile_chain.py

At the north-star shape (n = 500 padded to 512, d = 15, 100 walkers, the
bench dataset of chip_smoke.py) it measures, each by CUDA events (median
of repeated calls) and by a torch.profiler pass that counts the device
operations (kernels, copies, fills) one call issues:

* one half-ensemble log-probability (50 walkers): unwarped with K1,
  warped with K1 (LOWER_GRAM off) and warped with K2 (LOWER_GRAM on),
  with the device time of the gram kernel alone (K1 or K2) and of each
  K3 launch in that call;
* the warp of the training inputs alone, (50, 512, 15), and the unwarp
  of a 500-point candidate grid, (500, 15);
* chain steps (demix moves): unwarped, warped with LOWER_GRAM off and
  warped with LOWER_GRAM on, in turns (A B C C B A, TURN_ROUNDS times;
  each turn 30 steps) with their median, and the device's busy share and
  device operations per step from the profiler over a short window.

Prints one JSON line per measurement and, before them, the card's name
and power limit. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

N_STEPS = 30
TURN_ROUNDS = 3


def device_ops(fn):
    """(device operations issued, device microseconds, microseconds of the
    gram kernels K1/K2 among them, microseconds of the K3 launches among
    them, wall microseconds) of one ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    gram_us = [e.device_time for e in ops if "gram_kernel" in e.name]
    chol_us = [e.device_time for e in ops if "chol_inv_kernel" in e.name]
    return len(ops), float(sum(e.device_time for e in ops)), gram_us, chol_us, wall_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_chain.py: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    run(torch.device("cuda", 0))
    return 0


def run(dev) -> None:
    import torch

    from bask_tpu_torch.models import bayesgpr as bg
    from bask_tpu_torch.models import gp as gpc
    from bask_tpu_torch.models import warping as wp
    from bask_tpu_torch.ops import gram
    from bask_tpu_torch.ops import kernels as bk
    from bask_tpu_torch.parallel.mcmc import run_ensemble
    from bask_tpu_torch.utils.priors import guess_priors

    X, y = cs.bench_dataset()
    kernel = cs.bench_kernel(bk)
    n_pad, n, d, W = cs.N_PAD, cs.N_OBS, cs.N_DIM, cs.N_WALKERS

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    yp = np.zeros(n_pad)
    yp[:n] = y
    data = gpc.make_data(t(cs.padded(X)), t(yp), t(np.full(n_pad, 1e-6)), np.arange(n_pad) < n)
    priors = tuple(guess_priors(kernel))
    rng = np.random.RandomState(0)
    theta = kernel.theta0[None] + 0.05 * rng.randn(W, kernel.n_theta)
    theta[:, -1] += np.log(0.05)
    pos = t(np.concatenate([theta, 0.1 * rng.randn(W, 2 * d)], axis=1))
    half = pos[: W // 2]

    plain_lp = bg._make_log_prob_batch(kernel, priors, data, n)
    warped_lp = bg._make_log_prob_batch(kernel, priors, data, n, wp.default_warp_log_prior, d)

    def measure(name, fn, **extra):
        ms = cs.cuda_ms(fn, reps=20)
        ops, dev_us, gram_us, chol_us, _ = device_ops(fn)
        print(json.dumps({"measure": name, "ms": ms, "device_ops": ops,
                          "device_us": dev_us, "gram_kernel_us": gram_us,
                          "k3_kernel_us": chol_us, **extra}),
              flush=True)

    measure("log-prob, unwarped, K1", lambda: plain_lp(half[:, : kernel.n_theta]),
            walkers=W // 2)
    measure("log-prob, warped, K1", lambda: warped_lp(half), walkers=W // 2)
    gram.LOWER_GRAM = "on"
    measure("log-prob, warped, K2", lambda: warped_lp(half), walkers=W // 2)
    gram.LOWER_GRAM = "off"
    la, lb = half[:, kernel.n_theta : kernel.n_theta + d], half[:, kernel.n_theta + d :]
    measure("warp", lambda: wp.warp(data.X, la, lb), shape=[W // 2, n_pad, d])
    grid = t(np.random.RandomState(1).uniform(size=(cs.N_CAND, d)))
    measure("unwarp", lambda: wp.unwarp(grid, la[0], lb[0]), shape=[cs.N_CAND, d])

    configs = {
        "unwarped": (plain_lp, pos[:, : kernel.n_theta], "off"),
        "warped, LOWER_GRAM off": (warped_lp, pos, "off"),
        "warped, LOWER_GRAM on": (warped_lp, pos, "on"),
    }

    def chain(name, n_steps, seed=0):
        lp, p0, lower = configs[name]
        gram.LOWER_GRAM = lower
        try:
            run_ensemble(lp, p0, seed, n_steps, moves=bg._MOVE_ALIASES["demix"])
        finally:
            gram.LOWER_GRAM = "off"

    def step_ms(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain(name, N_STEPS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / N_STEPS * 1e3

    for name in configs:  # warm-up
        chain(name, 2)
    turns = {name: [] for name in configs}
    for _ in range(TURN_ROUNDS):
        for name in list(configs) + list(configs)[::-1]:
            turns[name].append(step_ms(name))
    for name in configs:
        ops, dev_us, _, _, wall_us = device_ops(lambda: chain(name, 5, seed=1))
        print(json.dumps({
            "measure": f"chain step, {name}", "ms_per_step_turns": turns[name],
            "median_ms": float(np.median(turns[name])), "steps": N_STEPS, "device_ops_per_step": ops / 5,
            "busy_share_profiled": dev_us / wall_us,
        }), flush=True)
    assert all(math.isfinite(v) for v in sum(turns.values(), []))


if __name__ == "__main__":
    sys.exit(main())
