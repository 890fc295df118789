"""Fit a fully-Bayesian GP to noisy 1-D data with the PyTorch port.

The run of ``examples/fit_gp.py`` on ``bask_tpu_torch`` (the reference's
``examples/Fit-GP.ipynb``): n=100 noisy observations of a 1-D function,
100 stretch-move walkers, burn-in, the hyperposterior, then the mean and
its uncertainty at 11 points.

Run:  python examples/torch_fit_gp.py        (the CUDA card)
      python examples/torch_fit_gp.py --cpu  (the CPU)

``--burnin N`` runs N burn-in steps (default 100). Without ``--cpu`` the
run needs a CUDA card and raises where there is none.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bask_tpu_torch import BayesGPR
from bask_tpu_torch.ops.kernels import ConstantKernel, Matern


def f(x):
    return np.sin(2 * np.pi * x) + 0.5 * np.cos(6 * np.pi * x)


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
    ap.add_argument("--burnin", type=int, default=100, help="burn-in steps")
    args = ap.parse_args(argv)
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(100, 1))
    y = f(X[:, 0]) + 0.2 * rng.randn(100)

    kernel = ConstantKernel(1.0, (0.1, 2.0)) * Matern(0.3, (0.05, 0.8), nu=2.5)
    gp = BayesGPR(kernel=kernel, random_state=1, device=device_arg(args.cpu))

    t0 = time.time()
    gp.fit(X, y, n_burnin=args.burnin, n_desired_samples=100)
    print(f"fit wall-clock: {time.time() - t0:.1f}s")
    print(f"chain: {gp.chain_.shape}, acceptance {gp.n_accepted_ / gp.n_proposals_:.2f}")
    print(f"consensus theta (log): {np.round(gp.theta, 3)}")
    print(f"noise estimate: {gp.noise_:.4f} (true 0.04)")

    Xq = np.linspace(0, 1, 11)[:, None]
    mean, std = gp.predict(Xq, return_std=True)
    for xq, m, s, t in zip(Xq[:, 0], mean, std, f(Xq[:, 0])):
        print(f"  x={xq:.1f}  pred={m:+.3f} ± {s:.3f}  true={t:+.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
