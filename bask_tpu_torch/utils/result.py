"""Optimization result container and the expected-minimum search.

PyTorch counterpart of :mod:`bask_tpu.utils.result`: ``create_result`` is
a copy; ``expected_minimum`` descends the consensus GP's posterior mean
from many starts at once (projected Adam, gradients by autograd through
``gp.predict`` and, when warping, through the warp), then finishes
the best start with scipy's L-BFGS-B.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import OptimizeResult

__all__ = ["create_result", "expected_minimum"]

_DESCENT_STEPS, _DESCENT_LR = 120, 0.03


def create_result(Xi, yi, space=None, rng=None, models=None) -> OptimizeResult:
    """Bundle observations + model into a scipy OptimizeResult."""
    yi = np.asarray(yi, dtype=float)
    res = OptimizeResult()
    if len(yi):
        best = int(np.argmin(yi))
        res.x = Xi[best]
        res.fun = yi[best]
    else:
        res.x, res.fun = None, None
    res.func_vals = yi
    res.x_iters = list(Xi)
    res.models = list(models) if models else []
    res.space = space
    res.random_state = rng
    res.specs = {}
    return res


def _mean(gp, U):
    """Posterior mean (k,) of the consensus GP at U (k, d) in the
    transformed space, differentiable in U."""
    from ..models import gp as gpc

    post = gp._post
    return gpc.predict(gp._spec, post.theta, post, gp._post_data, gp._warp_tensor(U))


def _mean_value_grad(gp, U):
    """(values, gradients) of the posterior mean at the rows of U. The
    starts are independent, so one backward pass of the summed values
    gives every start's gradient."""
    U = U.detach().requires_grad_(True)
    vals = _mean(gp, U)
    (grad,) = torch.autograd.grad(vals.sum(), U)
    return vals.detach(), grad


def _batched_descent(gp, starts):
    """Projected-Adam descent of the posterior mean over [0, 1]^d from
    every start at once; the best end point and its value."""
    U = gp._tensor(starts)
    m = torch.zeros_like(U)
    v = torch.zeros_like(U)
    for t in range(1, _DESCENT_STEPS + 1):
        _, g = _mean_value_grad(gp, U)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        step = (m / (1 - 0.9**t)) / (torch.sqrt(v / (1 - 0.999**t)) + 1e-8)
        U = torch.clamp(U - _DESCENT_LR * step, 0.0, 1.0)
    with torch.no_grad():
        V = _mean(gp, U).cpu().double().numpy()
    i = int(np.argmin(V))
    return U[i].cpu().double().numpy(), float(V[i])


def expected_minimum(res: OptimizeResult, n_random_starts: int = 20, random_state=None):
    """Minimize the GP posterior mean over the space.

    Starts: the best observed point and ``n_random_starts`` uniform
    points of the transformed [0, 1]^d cube, all descended at once, then
    L-BFGS-B from the best; a (partly) categorical space takes the best
    of a dense random sample instead. Returns ``(x, fun)`` with ``x`` in
    the original space.
    """
    from scipy.optimize import minimize

    space = res.space
    gp = res.models[-1]
    if not isinstance(random_state, np.random.RandomState):
        random_state = np.random.RandomState(random_state)

    if space.is_partly_categorical:
        cand = space.rvs(n_samples=max(10 * n_random_starts, 1000), random_state=random_state)
        mu = gp.predict(space.transform(cand))
        i = int(np.argmin(mu))
        return cand[i], float(mu[i])

    d = space.transformed_n_dims
    starts = [space.transform([res.x])[0]] if res.x is not None else []
    starts.extend(random_state.uniform(size=(n_random_starts, d)))
    u_best, v_best = _batched_descent(gp, np.asarray(starts))

    def f(u):
        val, grad = _mean_value_grad(gp, gp._tensor(u[None, :]))
        return float(val[0]), grad[0].cpu().double().numpy()

    r = minimize(
        f, u_best, jac=True, method="L-BFGS-B", bounds=[(0.0, 1.0)] * d,
        options={"maxiter": 50},
    )
    if r.fun < v_best:
        u_best, v_best = r.x, float(r.fun)
    x = space.inverse_transform(np.asarray(u_best)[None, :])[0]
    return x, float(v_best)
