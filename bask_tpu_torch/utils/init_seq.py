"""Low-discrepancy initial designs: R2 and Steinerberger sequences.

PyTorch counterpart of :mod:`bask_tpu.utils.init_seq`. ``r2_sequence``
is plain NumPy. ``sb_sequence`` greedily adds the minimizer of the
Steinerberger interaction energy; all restarts of one greedy step
descend together as one batched projected-Adam loop, with gradients from
autograd. The design is a small host computation, so it runs on the CPU
in float64 whatever device the model uses.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["r2_sequence", "sb_sequence", "phi"]


def phi(d: int, n_iter: int = 10) -> float:
    """Generalized golden ratio: unique positive root of x^(d+1) = x + 1."""
    if d == 1:
        return 1.61803398874989484820458683436563
    if d == 2:
        return 1.32471795724474602596090885447809
    x = 2.0
    for _ in range(n_iter):
        x = (1 + x) ** (1.0 / (d + 1))
    return x


def r2_sequence(n: int, d: int, seed: float = 0.5) -> np.ndarray:
    """First ``n`` points of the R_d quasi-random sequence in [0,1]^d."""
    g = phi(d)
    alpha = np.array([(1.0 / g) ** (j + 1) % 1.0 for j in range(d)])
    i = np.arange(1, n + 1)[:, None]
    return (seed + alpha[None, :] * i) % 1.0


def _sb_energy(x, X, mask):
    """Energies of candidates x (r, d) against the masked points X (n, d):
    E(x) = sum_i prod_d (1 - log(2 sin(pi |x_d - X_id|))) -> (r,)."""
    diff = torch.abs(x[:, None, :] - X[None, :, :])
    s = torch.clamp(2.0 * torch.sin(math.pi * diff), min=1e-12)
    terms = torch.prod(1.0 - torch.log(s), dim=-1)
    return torch.where(mask[None, :], terms, 0.0).sum(-1)


def _sb_next_point(X, mask, starts, n_steps: int = 150, lr: float = 0.02):
    """Multi-start projected Adam descent of the SB energy; the best
    restart's end point."""
    x = starts.clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    for t in range(1, n_steps + 1):
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_sb_energy(xg, X, mask).sum(), xg)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9**t)
        vhat = v / (1.0 - 0.999**t)
        x = torch.clamp(x - lr * mhat / (torch.sqrt(vhat) + 1e-8), 1e-4, 1.0 - 1e-4)
    with torch.no_grad():
        return x[torch.argmin(_sb_energy(x, X, mask))]


def sb_sequence(
    n: int,
    d: int,
    existing_points=None,
    random_state=None,
    restarts: int = 20,
) -> np.ndarray:
    """Greedy Steinerberger low-discrepancy sequence in [0,1]^d.

    With ``existing_points`` given, fills up the space until ``n`` total
    points. Raises ValueError when there is nothing left to generate.
    """
    if not isinstance(random_state, np.random.RandomState):
        random_state = np.random.RandomState(random_state)
    if existing_points is None:
        pts = [np.asarray(random_state.uniform(size=d))]
    else:
        pts = [np.asarray(p, dtype=float) for p in existing_points]
        if len(pts) >= n:
            raise ValueError("No more points left to generate.")
    X = np.zeros((n, d))
    X[: len(pts)] = np.asarray(pts)
    mask = np.zeros(n, dtype=bool)
    mask[: len(pts)] = True
    for k in range(len(pts), n):
        starts = random_state.uniform(size=(restarts, d))
        X[k] = _sb_next_point(
            torch.from_numpy(X), torch.from_numpy(mask), torch.from_numpy(starts)
        ).numpy()
        mask[k] = True
    return X
