"""Row-sharded GP inference over a device mesh with the PyTorch port.

The run of ``examples/large_n_mesh.py`` on ``bask_tpu_torch.ops.dist_chol``:
one gram factorized by block rows across the mesh's entries, each entry
building only its own (n_loc, n) strip, so a gram larger than one card's
memory still fits; the LML, the predictive mean and std and joint draws
all come out of one distributed sweep, in float64 as in the JAX example.

The mesh repeats one device four times, ``Mesh(["cuda:0"] * 4, ("rows",))``
(``["cpu"] * 4`` with ``--cpu``): the same code runs on four cards with
four distinct entries.

Run:  python examples/torch_large_n_mesh.py        (the CUDA card, x4)
      python examples/torch_large_n_mesh.py --cpu  (the CPU, x4)

``--n N`` sets the number of points (default 1011). Without ``--cpu`` the
run needs a CUDA card and raises where there is none.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bask_tpu_torch.ops import kernels as tk
from bask_tpu_torch.ops.dist_chol import (
    row_sharded_lml,
    row_sharded_predict,
    row_sharded_sample_y,
)
from bask_tpu_torch.ops.linalg import masked_lml
from bask_tpu_torch.parallel.mesh import Mesh


def device_arg(cpu: bool) -> str:
    """"cpu" with ``--cpu``; else the CUDA card, which must exist: there
    is no fallback to the CPU."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run on a machine with one, or pass --cpu")
    return "cuda:0"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--n", type=int, default=1011, help="number of points")
    args = ap.parse_args(argv)
    device = device_arg(args.cpu)
    P = 4
    mesh = Mesh([device] * P, ("rows",))
    print(f"mesh: {P} x {device}, axis 'rows'")

    # a synthetic 4-D problem, padded to a multiple of 64 per mesh entry
    d, n_real = 4, args.n
    n_pad = -(-n_real // (64 * P)) * 64 * P
    rng = np.random.RandomState(0)
    X = np.zeros((n_pad, d))
    X[:n_real] = rng.uniform(size=(n_real, d))
    f = lambda Z: np.sin(3 * Z[:, 0]) * np.cos(2 * Z[:, 1]) + Z[:, 2]  # noqa: E731
    y = np.zeros(n_pad)
    y_real = f(X[:n_real]) + 0.05 * rng.randn(n_real)
    y_mean, y_std = y_real.mean(), y_real.std()
    y[:n_real] = (y_real - y_mean) / y_std
    mask = np.arange(n_pad) < n_real
    alpha = np.where(mask, 1e-6, 0.0)

    kernel = tk.ConstantKernel(1.0, (0.1, 10.0)) * tk.Matern(
        tuple([0.4] * d), (0.05, 5.0), nu=2.5
    ) + tk.WhiteKernel(0.01, (1e-6, 1e2))

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else torch.float64,
                               device=device)

    theta = on_device(np.asarray(kernel.theta0))
    Xt, yt, at, mt = (on_device(a) for a in (X, y, alpha, mask))

    # 1. the row-sharded LML against the single-device masked LML
    lml_d = float(row_sharded_lml(kernel, theta, Xt, yt, at, mt, mesh=mesh))
    lml_s = float(masked_lml(kernel, theta, Xt, yt, at, mt))
    print(f"LML  row-sharded {lml_d:.6f}  vs single-device {lml_s:.6f}  "
          f"(|diff| {abs(lml_d - lml_s):.2e})")

    # 2. row-sharded predictions at held-out points
    Xq = rng.uniform(size=(256, d))
    mu, std = row_sharded_predict(kernel, theta, Xt, yt, at, mt, on_device(Xq), mesh=mesh,
                                  y_mean=y_mean, y_std=y_std)
    mu, std = mu.cpu().numpy(), std.cpu().numpy()
    resid = np.abs(mu - f(Xq))
    cover = float(np.mean(resid <= 3 * std + 3 * 0.05))
    print(f"predict: mean |resid| {resid.mean():.4f}, 3-sigma coverage {cover:.3f}")

    # 3. joint draws from the row-sharded posterior (the normals from a seed)
    z = torch.randn((16, 5), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    draws = row_sharded_sample_y(kernel, theta, Xt, yt, at, mt, on_device(Xq[:16]),
                                 z.to(device), mesh=mesh, n_samples=5, y_mean=y_mean,
                                 y_std=y_std)
    print(f"sample_y: draws shape {tuple(draws.shape)}, "
          f"spread {float(draws.std()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
