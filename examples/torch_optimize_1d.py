"""Optimize a noisy 1-D function with the ask/tell loop of the PyTorch port.

The run of ``examples/optimize_1d.py`` on ``bask_tpu_torch`` (the reference's
``examples/Optimize-1D-function.ipynb``): PVRS over 50 candidates, 32
iterations, then the stopping-rule diagnostics. The true optimum of the
objective is near x=0.9554 (y=-1.4734).

Run:  python examples/torch_optimize_1d.py        (the CUDA card)
      python examples/torch_optimize_1d.py --cpu  (the CPU)

``--iters N`` runs N ask/tell iterations (default 32). Without ``--cpu``
the run needs a CUDA card and raises where there is none.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bask_tpu_torch import Optimizer, expected_minimum


def objective(x, rng=np.random.RandomState(42)):
    return float(-(1.4 - 3.0 * x[0]) * np.sin(18.0 * x[0]) + rng.randn() * 0.05)


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
    ap.add_argument("--iters", type=int, default=32, help="ask/tell iterations")
    args = ap.parse_args(argv)
    if args.iters < 6:  # the 5 initial points and one fitted tell
        ap.error("--iters must be at least 6")
    opt = Optimizer(
        dimensions=[(0.0, 1.2)],
        n_points=50,
        n_initial_points=5,
        acq_func="pvrs",
        random_state=0,
        device=device_arg(args.cpu),
    )
    t0 = time.time()
    result = opt.run(objective, n_iter=args.iters, n_samples=0, gp_samples=200, gp_burnin=5)
    print(f"{args.iters} ask/tell iterations: {time.time() - t0:.1f}s")
    print(f"best observed: x={result.x[0]:.4f}  y={result.fun:.4f}")

    x_exp, y_exp = expected_minimum(result, n_random_starts=50, random_state=0)
    print(f"expected minimum of GP mean: x={x_exp[0]:.4f}  y={y_exp:.4f}")

    prob = opt.probability_of_optimality(
        threshold=0.1, n_space_samples=200, n_gp_samples=100,
        n_random_starts=20, random_state=0,
    )
    print(f"P(current optimum within 0.1 of true): {prob:.2f}")
    intervals = opt.optimum_intervals(random_state=0, space_samples=200)
    print(f"95% HDI for the optimum location: {np.round(intervals[0], 3)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
