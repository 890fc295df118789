"""Production BO loop of the PyTorch port: kernel warmup + a persistent library cache.

The loop of ``examples/production_loop.py`` on ``bask_tpu_torch``: Hartmann-3,
PVRS over 200 candidates, 5 initial points, 30 iterations. Two tools keep
the loop from stalling:

1. ``enable_aot_cache(dir)`` keeps the built CUDA kernel library in ``dir``
   (``BASK_TPU_AOT_CACHE``, else ``~/.cache/bask_tpu_torch_aot``), so every
   process after the first loads it instead of running nvcc.
2. ``warmup_optimizer(opt, buckets)`` builds the library and captures the
   chain's CUDA graphs for every padding bucket the run will reach, on a
   throwaway clone, so the loop itself captures nothing.

Run:  python examples/torch_production_loop.py        (the CUDA card)
      python examples/torch_production_loop.py --cpu  (the CPU)

``--iters N`` runs N iterations (default 30) and warms the bucket of N
observations. ``--converged`` samples every refit to split R-hat 1.1.
Without ``--cpu`` the run needs a CUDA card and raises where there is none.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bask_tpu_torch import Optimizer, enable_aot_cache, warmup_optimizer


def hartmann3(x):
    A = np.array([[3, 10, 30], [0.1, 10, 35], [3, 10, 30], [0.1, 10, 35]])
    P = 1e-4 * np.array(
        [[3689, 1170, 2673], [4699, 4387, 7470],
         [1091, 8732, 5547], [381, 5743, 8828]]
    )
    alpha = np.array([1.0, 1.2, 3.0, 3.2])
    inner = np.sum(A * (np.asarray(x)[None, :] - P) ** 2, axis=1)
    return float(-np.sum(alpha * np.exp(-inner)))


def device_arg(cpu: bool):
    """"cpu" with ``--cpu``; else ``None``, the entry points' CUDA card,
    which must exist: there is no fallback to the CPU."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run on a machine with one, or pass --cpu")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--iters", type=int, default=30, help="ask/tell iterations")
    ap.add_argument("--converged", action="store_true",
                    help="sample every refit to split R-hat 1.1")
    args = ap.parse_args(argv)
    if args.iters < 6:  # the 5 initial points, the first fit, one warm tell
        ap.error("--iters must be at least 6")
    device = device_arg(args.cpu)

    cache_dir = enable_aot_cache(
        os.environ.get("BASK_TPU_AOT_CACHE", "~/.cache/bask_tpu_torch_aot")
    )
    print(f"kernel library cache: {cache_dir}")

    gp_sample_kwargs = {}
    if args.converged:
        # warm chunk extensions until the accumulated second-half split
        # R-hat passes 1.1
        gp_sample_kwargs = {"until_rhat": 1.1, "max_extensions": 4, "extension_steps": 300}
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * 3,
        n_points=200,
        n_initial_points=5,
        acq_func="pvrs",
        random_state=0,
        gp_sample_kwargs=gp_sample_kwargs,
        device=device,
    )

    gp_samples, gp_burnin = 100, 5
    t0 = time.time()
    warmed = warmup_optimizer(
        opt, n_observations=[args.iters], gp_samples=gp_samples, gp_burnin=gp_burnin
    )
    print(f"warmup (buckets {warmed}): {time.time() - t0:.1f}s "
          "(the first process builds the kernel library; later ones load it)")

    t0 = time.time()
    iter_times = []
    for _ in range(args.iters):
        ti = time.time()
        x = opt.ask()
        result = opt.tell(x, hartmann3(x), n_samples=0, gp_samples=gp_samples,
                          gp_burnin=gp_burnin)
        iter_times.append(time.time() - ti)
    dt = time.time() - t0
    # the 5th tell (index 4) ends the initial design and runs the first
    # fit with the one-off ML-II warm start; the warm iterations are those
    # from index 8 (from index 5 in a run too short for that)
    warm = iter_times[8:] or iter_times[5:]
    print(
        f"{args.iters} iterations: {dt:.1f}s total  "
        f"(median warm iteration {np.median(warm):.3f}s; "
        f"first fitted iteration {iter_times[4]:.2f}s incl. the one-off "
        f"ML-II warm start and the convergence-honest cold fit)  "
        f"best y={result.fun:.4f} at x={np.round(result.x, 3)}"
    )
    print(f"last tell timings: {opt.last_timings_}")
    if args.converged:
        ur = opt.gp.until_rhat_result_
        print(
            f"per-refit convergence (--converged): last refit R-hat "
            f"{ur['rhat']:.3f} <= {ur['threshold']} after {ur['steps']} "
            f"kept steps ({'converged' if ur['converged'] else 'BUDGET EXHAUSTED'})"
        )
    else:
        from bask_tpu_torch.utils.diagnostics import split_rhat

        steps = opt.gp.chain_steps_
        note = (
            f"max split R-hat {float(np.max(split_rhat(steps))):.3f} "
            f"over {steps.shape[0]} kept steps"
            if steps.shape[0] >= 4
            else f"{steps.shape[0]} kept step(s) per warm refit: too "
            "short to judge; rerun with --converged for per-refit R-hat"
        )
        print(f"warm-refit chain: {note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
