"""Beta-CDF input warping (Snoek et al. 2014) in PyTorch.

PyTorch counterpart of :mod:`bask_tpu.models.warping`: each input
dimension is warped by the CDF of a Beta(a_d, b_d) distribution whose
log-parameters are extra MCMC dimensions. Every function broadcasts over
leading dimensions, so one call warps the training inputs of a whole
walker batch: log-parameters (W, d) and X (n, d) give (W, n, d), the
per-walker layout the gram kernels take.

The route is :mod:`bask_tpu_torch.ops.warp_values`'s: :func:`warp` and
:func:`unwarp` call its wrappers, which send a CUDA tensor, float32 or
float64, to the hand-written kernels K6 and K7 (``csrc/warp.cu``: one
launch per call, no coefficient tensor) and a CPU tensor to their plain
versions beside them. A build or launch failure raises; nothing falls
back. On the card the warp's gradient in x is the incoming gradient
times the Beta pdf that K6 writes beside the warp, and a gradient in the
log-parameters raises (JAX's ``betainc`` has none either).

torch has no incomplete beta function, so the plain :func:`betainc`
evaluates the classic continued fraction (Numerical Recipes 6.4) with the
``x > (a + 1) / (a + b + 2)`` symmetry switch, ``torch.lgamma`` for the
prefactor, and a **fixed** depth of 48 terms (``CF_TERMS``) summed
backward from the tail: one launch per term over a ``(48, *x.shape)``
coefficient tensor and no data-dependent loop, so the host never waits on
the device. K6 evaluates the same 48 terms from the tail, with the
coefficients made once per column and the fraction carried as a ratio, so
that no term divides. At
48 terms it agrees with ``scipy.special.betainc`` within 2e-15 for a, b
in [0.2, 5], 5e-14 in [0.05, 20] and 2e-11 in [0.01, 100] (float64, the
bounds ``tests/test_torch_warping.py`` holds; the default warp prior puts
a and b in [0.2, 5] at 5 sigma).

The inverse CDF (``unwarp``) has no closed form. JAX halves [0, 1] 60
times, which leaves x no nearer 0 than 2^-61 however steep the CDF: at
a = 0.03 every z below 0.3 lands there. Here the bisection runs over the
type's ordered bit patterns of [0, 1] instead (30 steps at float32, 62 at
float64) and ends on the representable x whose CDF lies nearest z, as
exact as the type allows at either end. K7 bisects so, one thread per
entry, held to the float64 root within a limit rather than to the plain
version bit for bit (``csrc/warp.cu`` says why).
"""

from __future__ import annotations

import torch

from ..ops import warp_values as _k
from ..ops.warp_values import _betaln, ab as _ab, betainc
from ..utils.stats import norm_logpdf

__all__ = [
    "betainc",
    "warp",
    "unwarp",
    "warp_grad",
    "default_warp_log_prior",
    "split_warp_params",
]


def warp(X, log_alphas, log_betas):
    """Columnwise Beta CDF warp of X in [0, 1]^d: X (..., n, d) and
    log-parameters (..., d) broadcast to (..., n, d). K6 on a CUDA tensor,
    the plain version on a CPU tensor (:func:`~bask_tpu_torch.ops.
    warp_values.warp_values`)."""
    return _k.warp_values(X, log_alphas, log_betas)


def warp_grad(X, log_alphas, log_betas):
    """Elementwise d warp / dx: the Beta(a_d, b_d) pdf at each entry (the
    diagonal of the warp's Jacobian), with x clipped to [1e-12, 1 - 1e-12]
    as in the JAX package."""
    a, b = _ab(log_alphas, log_betas)
    x = torch.clamp(X, 1e-12, 1.0 - 1e-12)
    return torch.exp((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - _betaln(a, b))


def unwarp(Z, log_alphas, log_betas, n_iter: int = 60):
    """Columnwise Beta PPF: the representable x (in Z's type) whose
    betainc(a, b, x) lies nearest z, by bisection over the type's bit
    patterns. ``n_iter``, the JAX package's count of bisection steps of
    [0, 1], is taken for its signature: whatever it is, the root lies in
    its bracket, and this x is the type's nearest to the root. K7 on a
    CUDA tensor, the plain version on a CPU tensor
    (:func:`~bask_tpu_torch.ops.warp_values.unwarp_values`)."""
    return _k.unwarp_values(Z, log_alphas, log_betas)


def default_warp_log_prior(log_alphas, log_betas, scale: float = 0.3):
    """Normal(0, ``scale``) on each log-parameter, summed over the last
    axis: concentrated on the identity warp a = b = 1 (the reference's
    default, ``bask/bayesgpr.py:462-466``)."""
    return (
        norm_logpdf(log_alphas, 0.0, scale).sum(-1)
        + norm_logpdf(log_betas, 0.0, scale).sum(-1)
    )


def split_warp_params(x, n_dims: int):
    """Split MCMC rows (..., D) into (theta_gp, log_alphas, log_betas):
    the last ``2 * n_dims`` entries are the warp parameters, alphas
    before betas (``bask/bayesgpr.py:353-357``)."""
    n_gp = x.shape[-1] - 2 * n_dims
    return x[..., :n_gp], x[..., n_gp : n_gp + n_dims], x[..., n_gp + n_dims :]
