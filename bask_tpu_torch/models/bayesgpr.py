"""Fully-Bayesian GP regressor with hyperparameter MCMC on the device.

PyTorch counterpart of :class:`bask_tpu.models.bayesgpr.BayesGPR` (the
default path): an ML-II warm start on the first fit, then an ensemble
sampler over the kernel hyperparameters whose batched log-probability is
:func:`bask_tpu_torch.ops.linalg.batched_lml`, the consensus model at
the geometric median of the kept chain, and predictions from it.

``sample`` runs chain -> kept steps -> geometric median -> consensus
factorization (3-rung jitter ladder) -> consensus LML, the sequence of
the JAX package's fused sample program. The model lives on ``device`` in
``dtype`` (the CUDA card unless the caller names another device); on a
CUDA device in float32 the chain's grams and factorization bases run in
the package's hand-written kernels.

``warp_inputs=True`` adds Beta-CDF input warping
(:mod:`bask_tpu_torch.models.warping`): each chain row carries 2d warp
log-parameters after the kernel theta, the log-probability warps the
training inputs per walker (a (W, n_pad, d) X for the gram kernel's
per-walker mode), and the consensus splits the geometric median into
``theta``, ``warp_alphas_`` and ``warp_betas_``. ML-II fits theta alone
at the identity warp, as in the JAX package.

Pathwise draws (:mod:`bask_tpu_torch.models.pathwise`) give
:meth:`BayesGPR.sample_y_pathwise` and :meth:`BayesGPR.thompson_argmin_pathwise`,
the batch-ask path over large candidate grids; :meth:`BayesGPR.mcmc_diagnostics`
reports split R-hat, ESS and autocorrelation times of the kept chain.

The fit options are the JAX package's: ``optimizer`` (``"lbfgs"``, SciPy's
L-BFGS-B on autograd value and gradient; ``"lbfgs-device"``, a batched
L-BFGS over all starts on the model's device; ``None``, no warm start),
``n_restarts_optimizer``, ``ml2_objective`` (``"map"`` adds the guessed
priors), ``ml2_subsample`` (the warm start on a random subset) and
``chain_init="laplace"`` (a cold ensemble drawn from the Laplace
approximation at the posterior mode). Priors may be torch functions, a
frozen SciPy distribution's ``logpdf`` (lifted to torch by
:mod:`bask_tpu_torch.utils.scipy_lift`) or any NumPy callable, which runs
on the host through an adapter, or with ``host_prior_mode="interp"`` as a
table interpolated on the device (``scipy_lift.tabulate_prior``). Models
pickle with their tensors as NumPy and come back on their device.

Meshes (:mod:`bask_tpu_torch.parallel.mesh`): ``sample(mesh=)`` and
``fit(mesh=)`` shard the walker ensemble over a 1-axis mesh (the ensemble
rounded up to a multiple of twice the mesh size), with results equal to
the unsharded chain's. ``BayesGPR(row_mesh=)`` is the huge-n mode: every
factorization (chain, ML-II, consensus LML, predictions, draws) is
row-sharded over the mesh by :mod:`bask_tpu_torch.ops.dist_chol`, and no
(n_pad, n_pad) gram or factor is ever stored; a 2-axis
(walkers, rows) row mesh also splits the walkers over its first axis.

On one CUDA card the chain's steps replay CUDA graphs
(:mod:`bask_tpu_torch.parallel.mcmc`) wherever the configuration allows:
a kernel of the fused family on float32 data, no mesh, no row mesh and no
host-adapter prior (:meth:`BayesGPR._chain_graph`).
"""

from __future__ import annotations

import math
import warnings
from collections import OrderedDict
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from ..ops import kernels as bk
from ..ops.gram import _n_real_arg, fused_spec_for
from ..ops.linalg import batched_lml, cho_solve_masked, masked_cholesky, masked_gram
from ..parallel.mcmc import (
    _MOVE_PARAMS, ChainGraph, _normalize_moves, flatten_chain, run_ensemble,
)
from ..utils import trace
from ..utils.median import geometric_median
from ..utils.priors import guess_priors
from ..utils.validation import validate_zeroone
from . import gp as gpc
from . import warping as wp

__all__ = ["BayesGPR"]

DEFAULT_WARN_RHAT = 1.1

_MOVE_ALIASES = {
    "demix": (("de", 0.8), ("snooker", 0.2)),
    "tri": (("stretch", 0.5), ("de", 0.4), ("snooker", 0.1)),
}


# Resolved non-torch priors by (prior, joint, host_prior_mode): lifts,
# vmapped joint priors and host adapters, shared by every model as the JAX
# package's _HOST_PRIOR_CACHE is, so that two models given the same prior
# evaluate the same object (a CUDA graph of the chain is keyed by it).
_PRIOR_CACHE = OrderedDict()
_HOST_PRIOR_CACHE_MAX = 64

# Warp priors built from an (alphas, betas) pair of elementwise priors, by
# the pair, so that a chain's warp prior is the same object at every tell.
_WARP_PRIOR_CACHE = OrderedDict()

# Tabulated interpolants of opaque priors under host_prior_mode="interp",
# keyed by (callable, range), so that the chain's priors stay
# identity-stable across tells.
_INTERP_PRIOR_CACHE = OrderedDict()
# Margin (in log-theta units) beyond the kernel bounds covered by the
# table; the chain's priors confine walkers near the bounds, and beyond
# the table the interpolant extrapolates the edge slopes linearly.
_INTERP_PRIOR_MARGIN = 5.0


def _cache_put(cache, key, value):
    cache[key] = value
    while len(cache) > _HOST_PRIOR_CACHE_MAX:
        cache.popitem(last=False)


def _bucket(n: int) -> int:
    """Padding bucket: 64 minimum, then multiples of 64."""
    return max(64, ((n + 63) // 64) * 64)


def _maybe_warn_rhat(kept_steps, warn_rhat):
    """Warn when the kept chain's max split R-hat exceeds ``warn_rhat``
    (skipped below 4 kept steps: no honest estimate there)."""
    if warn_rhat is None or kept_steps.shape[0] < 4:
        return
    from ..utils.diagnostics import split_rhat

    max_rhat = float(np.max(split_rhat(kept_steps)))
    if max_rhat > warn_rhat:
        warnings.warn(
            f"MCMC chain may not be converged: max split R-hat {max_rhat:.3f} "
            f"exceeds the threshold {warn_rhat}. Sample with until_rhat= or "
            "a longer chain; pass warn_rhat=None to silence this guard.",
            UserWarning,
            stacklevel=3,
        )


def _eval_priors(priors, theta):
    """Summed log-prior of (..., n_theta) thetas: a joint callable, or one
    elementwise callable per theta entry."""
    if callable(priors):
        return priors(theta)
    lp = 0.0
    for i, p in enumerate(priors):
        lp = lp + p(theta[..., i])
    return lp


def _make_log_prob_batch(kernel, priors, data, n_real, warp_prior=None, n_warp=0,
                         mesh=None, row_cfg=None):
    """Batched (W, D) -> (W,) log-posterior for the ensemble sampler.

    With ``n_warp`` > 0 the last ``2 * n_warp`` entries of each row are
    warp log-parameters: ``warp_prior(log_alphas, log_betas)`` scores them
    ((W, d) each -> (W,)) and the training inputs are warped per walker.
    ``mesh`` shards the walkers' LMLs (``batched_lml(mesh=)``).
    ``row_cfg`` = ``(row_mesh, nb, unroll)`` is the huge-n mode: each
    walker's LML comes from the row-sharded sweep
    (:mod:`bask_tpu_torch.ops.dist_chol`), the walkers split over the first
    axis of a 2-axis row mesh, and a warped walker warps the shared X
    inside its own sweep (no (W, n, d) batch). Exclusive with ``mesh``."""

    def log_prob_batch(xs):
        if n_warp:
            theta_gp, la, lb = wp.split_warp_params(xs, n_warp)
            lp = warp_prior(la, lb)
        else:
            theta_gp, lp = xs, 0.0
        lp = lp + _eval_priors(priors, theta_gp)
        if row_cfg is not None:
            from ..ops.dist_chol import row_sharded_lml_batch, walker_row_sharded_lml

            row_mesh, row_nb, row_unroll = row_cfg
            lml_fn = (walker_row_sharded_lml if len(row_mesh.axis_names) == 2
                      else row_sharded_lml_batch)
            lml = lml_fn(
                kernel, xs if n_warp else theta_gp, data.X, data.y, data.alpha_diag,
                data.mask, row_mesh, nb=row_nb, unroll=row_unroll, n_warp=n_warp,
            )
        else:
            X = wp.warp(data.X, la, lb) if n_warp else data.X
            lml = batched_lml(
                kernel, theta_gp, X, data.y, data.alpha_diag, data.mask, n_real=n_real,
                mesh=mesh,
            )
        total = lp + lml
        return torch.where(torch.isfinite(total), total, -math.inf)

    return log_prob_batch


def _neg_lml_plain(kernel, theta, data):
    """Negative LML through the plain factorization (``cholesky_ex``
    plus a triangular solve), never the blocked kernels: autograd
    differentiates it for the ML-II warm start, the MAP objective and the
    Laplace Hessian. ``theta`` may be batched (..., n_theta) -> (...,).
    NaN where the gram is not PD."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    L = masked_cholesky(Kp)
    yb = data.y.expand(Kp.shape[:-1])
    w = torch.linalg.solve_triangular(L, yb[..., None], upper=False)[..., 0]
    n = data.mask.sum().to(data.y.dtype)
    logdiag = torch.where(data.mask, torch.log(L.diagonal(dim1=-2, dim2=-1)), 0.0)
    lml = -0.5 * (w * w).sum(-1) - logdiag.sum(-1) - 0.5 * n * math.log(2.0 * math.pi)
    return -lml


def _theta_block_logpost(data, x0, kernel, priors, n_warp):
    """(log posterior as a function of the kernel-theta block, that
    block of ``x0``): the warp parameters are held at ``x0``'s warp slice
    (the JAX package has no betainc derivatives in a and b, so the Laplace
    init gives those dimensions the ball width instead)."""
    n_theta = x0.shape[0] - 2 * n_warp
    if n_warp:
        _, la, lb = wp.split_warp_params(x0, n_warp)
        data = data._replace(X=wp.warp(data.X, la, lb))

    def scalar(tg):
        return _eval_priors(priors, tg) - _neg_lml_plain(kernel, tg, data)

    return scalar, x0[:n_theta]


def _log_post_value_grad(data, x0, kernel, priors, n_warp):
    """(-log posterior, its gradient) over the kernel-theta block at
    ``x0``, as float64 NumPy: the host L-BFGS-B's objective (with
    ``priors=()`` the negative LML)."""
    scalar, x0g = _theta_block_logpost(data, x0, kernel, priors, n_warp)
    x0g = x0g.detach().requires_grad_(True)
    with torch.enable_grad():
        v = -scalar(x0g)
        (g,) = torch.autograd.grad(v, x0g)
    with trace.wait():
        v, g = float(v.detach()), g.detach().cpu()
    return v, g.double().numpy()


def _log_post_hessian(data, x0, kernel, priors, n_warp):
    """Kernel-theta Hessian of the log posterior at ``x0`` for the Laplace
    chain init, by double backward through the plain factorization."""
    scalar, x0g = _theta_block_logpost(data, x0, kernel, priors, n_warp)
    with torch.enable_grad():
        H = torch.autograd.functional.hessian(scalar, x0g.detach())
    return H.detach().cpu().double().numpy()


# Laplace-init spread guards (log-space hyperparameters), the JAX
# package's: directions with vanishing or negative curvature at the MAP
# point are capped at prior-scale width, and razor-sharp modes keep at
# least the 1e-2 ball width.
_LAPLACE_STD_MAX = 1.0
_LAPLACE_STD_MIN = 1e-2

# The device L-BFGS: curvature pairs kept, and the step lengths 2^-k,
# k < _LBFGS_STEPS, tried at once along each search direction.
_LBFGS_HISTORY = 10
_LBFGS_STEPS = 10


def _row_neg_lml_value_grad(kernel, row_cfg, grad_method, data):
    """Row mode's ML-II objective: ``f(thetas (N, D)) -> (-LML (N,),
    -grad (N, D))``, each row by :func:`~bask_tpu_torch.ops.dist_chol.
    row_sharded_lml_value_grad` in turn (never an (n_pad, n_pad) factor);
    the counterpart of JAX's custom-VJP ``_row_lml_rev``."""
    from ..ops.dist_chol import row_sharded_lml_value_grad

    mesh, nb, unroll = row_cfg

    def f(thetas):
        vs, gs = [], []
        for t in thetas:
            v, g = row_sharded_lml_value_grad(
                kernel, t, data.X, data.y, data.alpha_diag, data.mask, mesh,
                nb=nb, unroll=unroll, method=grad_method,
            )
            vs.append(-v)
            gs.append(-g)
        return torch.stack(vs), torch.stack(gs)

    return f


def _ml2_device(theta0s, data, lb, ub, kernel, maxiter=60, row_cfg=None,
                grad_method="adjoint"):
    """The ML-II warm start as a batched L-BFGS over all starts at once,
    on the data's device, with no host round trip inside.

    Bounds as in the JAX package's ``_ml2_lbfgs_core``: theta = lb +
    (ub - lb) sigmoid(u), the objective the negative LML with a finite
    1e25 where the factorization fails, and non-finite gradients taken as
    0. Each iteration evaluates value and gradient at ``_LBFGS_STEPS``
    step lengths along every start's direction in one batch and keeps the
    longest that meets Armijo's condition; a start where none does stays
    put and drops its curvature pairs. Runs ``maxiter`` iterations and
    returns the best start's theta (a (n_theta,) tensor). With ``row_cfg``
    the values and gradients come from the row-sharded sweep
    (``grad_method``), one theta at a time, as JAX's ``_ml2_device_row``
    maps its restarts."""
    B, D = theta0s.shape
    dt, dev = theta0s.dtype, theta0s.device
    width = ub - lb

    def to_t(u):
        return lb + width * torch.sigmoid(u)

    def value_grad(u):
        if row_cfg is not None:
            v, g_t = _row_neg_lml_value_grad(kernel, row_cfg, grad_method, data)(to_t(u))
            sig = torch.sigmoid(u)
            g = g_t * width * sig * (1.0 - sig)
            ok = torch.isfinite(v)
            return torch.where(ok, v, 1e25), torch.where(ok[:, None] & torch.isfinite(g), g, 0.0)
        u = u.detach().requires_grad_(True)
        with torch.enable_grad():
            v = _neg_lml_plain(kernel, to_t(u), data)
            v = torch.where(torch.isfinite(v), v, 1e25)
            (g,) = torch.autograd.grad(v.sum(), u)
        return v.detach(), torch.where(torch.isfinite(g), g, 0.0)

    p0 = ((theta0s - lb) / width).clamp(1e-6, 1.0 - 1e-6)
    u = torch.log(p0) - torch.log1p(-p0)
    f, g = value_grad(u)
    S = torch.zeros(B, _LBFGS_HISTORY, D, dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros(B, _LBFGS_HISTORY, dtype=dt, device=dev)  # 0: no pair
    gamma = torch.ones(B, dtype=dt, device=dev)
    steps = 2.0 ** -torch.arange(_LBFGS_STEPS, dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    for k in range(maxiter):
        # two-loop recursion, newest pair first; empty pairs contribute 0
        order = [(k - 1 - j) % _LBFGS_HISTORY for j in range(_LBFGS_HISTORY)]
        q, alphas = g.clone(), {}
        for j in order:
            alphas[j] = rho[:, j] * (S[:, j] * q).sum(-1)
            q = q - alphas[j][:, None] * Y[:, j]
        r = gamma[:, None] * q
        for j in reversed(order):
            beta = rho[:, j] * (Y[:, j] * r).sum(-1)
            r = r + S[:, j] * (alphas[j] - beta)[:, None]
        steepest = -g / g.norm(dim=-1, keepdim=True).clamp(min=1.0)
        p = torch.where(((rho > 0).any(-1) & ((g * -r).sum(-1) < 0))[:, None], -r, steepest)
        slope = (g * p).sum(-1)
        cand = u[:, None, :] + steps[None, :, None] * p[:, None, :]
        fc, gc = value_grad(cand.reshape(B * _LBFGS_STEPS, D))
        fc, gc = fc.reshape(B, _LBFGS_STEPS), gc.reshape(B, _LBFGS_STEPS, D)
        armijo = fc <= f[:, None] + 1e-4 * steps[None, :] * slope[:, None]
        moved = armijo.any(-1)
        pick = torch.argmax(armijo.to(dt), dim=-1)  # the longest step that passes
        u_new = torch.where(moved[:, None], cand[rows, pick], u)
        f_new = torch.where(moved, fc[rows, pick], f)
        g_new = torch.where(moved[:, None], gc[rows, pick], g)
        s, y = u_new - u, g_new - g
        sy = (s * y).sum(-1)
        valid = moved & (sy > 1e-10 * s.norm(dim=-1) * y.norm(dim=-1))
        slot = k % _LBFGS_HISTORY
        S[:, slot], Y[:, slot] = s, y
        rho[:, slot] = torch.where(valid, 1.0 / torch.where(valid, sy, 1.0), 0.0)
        rho = torch.where(moved[:, None], rho, 0.0)
        gamma = torch.where(valid, sy / (y * y).sum(-1).clamp(min=1e-30), gamma)
        u, f, g = u_new, f_new, g_new
    return to_t(u[torch.argmin(f)])


class _HostPrior:
    """A log-prior that only NumPy can evaluate, run on the host: theta is
    copied to the host as float64 (one device-to-host sync per call), the
    prior evaluated there, and the result copied back. ``joint=False``:
    an elementwise prior of one log-parameter (vectorized with
    ``np.vectorize``); ``joint=True``: one value per theta vector. It has
    no gradient: on a tensor that requires one it raises, and the Laplace
    init then falls back to the ball, as the JAX package's host callback
    does."""

    def __init__(self, p, joint: bool):
        self.p = p
        self.joint = joint

    def __call__(self, x):
        if x.requires_grad:
            raise TypeError("a host (NumPy) prior has no gradient")
        v = x.detach().cpu().double().numpy()
        if self.joint:
            flat = v.reshape(-1, v.shape[-1])
            out = np.array([float(self.p(row)) for row in flat]).reshape(v.shape[:-1])
        else:
            out = np.vectorize(self.p, otypes=[np.float64])(v)
        return torch.as_tensor(out, dtype=x.dtype).to(x.device)


class _VmappedPrior:
    """A joint torch prior written for one theta vector, batched over the
    leading dimensions of theta by ``torch.vmap``."""

    def __init__(self, p):
        self.p = p

    def __call__(self, x):
        if x.ndim == 1:
            return self.p(x)
        flat = x.reshape(-1, x.shape[-1])
        return torch.vmap(self.p)(flat).reshape(x.shape[:-1])


def _returns_batch(fn, probe, n):
    """True if ``fn(probe)`` gives an (n,) tensor on ``probe``'s device."""
    try:
        out = fn(probe)
    except Exception:  # a user prior that cannot take this tensor
        return False
    return isinstance(out, torch.Tensor) and out.shape == (n,) and out.device == probe.device


def _posterior_robust_body(theta, data, kernel):
    """Posterior factorization with a branchless 3-rung jitter ladder:
    the first of K, K + 1e-8 s I, K + 1e-4 s I (s = mean |diag K|) whose
    factor has no NaN."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    scale = Kp.diagonal().abs().mean()
    eye = torch.eye(Kp.shape[0], dtype=Kp.dtype, device=Kp.device)
    L0 = masked_cholesky(Kp)
    L1 = masked_cholesky(Kp + 1e-8 * scale * eye)
    L2 = masked_cholesky(Kp + 1e-4 * scale * eye)
    L = torch.where(
        torch.isnan(L0).any(), torch.where(torch.isnan(L1).any(), L2, L1), L0
    )
    return gpc.GPPosterior(theta=theta, L=L, alpha_dual=cho_solve_masked(L, data.y))


def _consensus_body(kernel, theta, data):
    """Robust factorization and LML: the consensus refresh."""
    post = _posterior_robust_body(theta, data, kernel)
    return post, gpc.log_marginal_likelihood(kernel, theta, data)


def _to_numpy(nt):
    """A GPData/GPPosterior with its tensors as NumPy arrays."""
    return nt._replace(**{
        k: v.detach().cpu().numpy() for k, v in nt._asdict().items()
        if isinstance(v, torch.Tensor)
    })


def _to_device(nt, device):
    """The inverse of :func:`_to_numpy` on ``device`` (tensors of a model
    pickled before ``__getstate__`` existed move there as well)."""
    return nt._replace(**{
        k: torch.as_tensor(v).to(device) for k, v in nt._asdict().items()
        if isinstance(v, (np.ndarray, torch.Tensor))
    })


def _canonical_moves(moves):
    """Normalize a ``moves`` spec to a tuple of ``(name, weight)``.

    ``None`` is pure stretch, ``"auto"`` stays a sentinel resolved per
    sample() call (demix at W >= 6, DE at W >= 4, stretch below), a bare
    move name is that move at weight 1, and ``"demix"``/``"tri"`` are
    mixtures; ``"demix:jump=0.2"`` hands each key to the member move
    that accepts it.
    """
    if moves is None or moves == "auto":
        return moves
    if isinstance(moves, str):
        base, sep, rest = moves.partition(":")
        alias = _MOVE_ALIASES.get(base)
        if alias is not None and sep:
            items = [it.strip() for it in rest.split(",")]
            keys = [it.partition("=")[0].strip() for it in items]
            out, claimed = [], set()
            for name, w in alias:
                accepts = _MOVE_PARAMS[name.partition(":")[0]]
                mine = [it for it, k in zip(items, keys) if k in accepts]
                claimed.update(k for k in keys if k in accepts)
                out.append((name + (":" + ",".join(mine) if mine else ""), w))
            unknown = [k for k in keys if k not in claimed]
            if unknown:
                raise ValueError(
                    f"alias {base!r} members accept no parameter named {unknown[0]!r}"
                )
            moves = tuple(out)
        elif alias is not None:
            moves = alias
        else:
            moves = ((moves, 1.0),)
    canon = tuple((str(n), float(w)) for n, w in moves)
    _normalize_moves(canon)
    return canon


class BayesGPR:
    """Fully-Bayesian Gaussian process regressor (see module docstring).

    ``kernel`` is a spec from :mod:`bask_tpu_torch.ops.kernels`;
    ``alpha`` is the jitter on the gram's diagonal (floored at 1e-6 in
    float32); ``noise="gaussian"`` appends a WhiteKernel at fit time;
    ``warp_inputs`` learns a Beta-CDF warp of each input dimension (inputs
    in [0, 1]); ``normalize_y`` standardizes the targets by their mean and
    standard deviation at every new data set. ``moves`` picks the ensemble
    moves (default ``"auto"``: demix at W >= 6).

    The warm start: ``optimizer`` (``"lbfgs"``, ``"lbfgs-device"`` or
    ``None`` for theta0), ``n_restarts_optimizer`` extra starts drawn
    uniformly in the bounds, ``ml2_objective`` (``"lml"`` or ``"map"``),
    ``ml2_subsample`` (optimize on that many random points);
    ``chain_init`` (``"ball"`` or ``"laplace"``) places a cold ensemble.
    ``copy_X_train`` copies the training arrays. ``host_prior_mode``
    (``"callback"`` or ``"interp"``) says how an elementwise prior that is
    neither torch nor a liftable SciPy density runs: on the host through an
    adapter (exact, one sync per log-probability), or as a table on the
    device (approximate; see :meth:`_interp_prior`). ``row_mesh`` (a 1-axis rows or 2-axis
    (walkers, rows) :class:`~bask_tpu_torch.parallel.mesh.Mesh`) turns on
    the row-sharded huge-n mode with panel width ``row_nb``, the
    trapezoid-only sweep ``row_unroll`` and the ML-II gradient
    ``row_grad_method`` (``"adjoint"`` or ``"jvp"``); a pickle drops the
    mesh (assign ``row_mesh`` again after loading).

    ``device`` and ``dtype`` place the training data, the chain and the
    posterior; ``device=None`` is the CUDA card. Host-side state
    (``theta``, ``chain_``, ``pos_``, ``warp_alphas_``, ``warp_betas_``)
    is NumPy, as in the JAX package.
    """

    def __init__(
        self,
        kernel: Optional[bk.Kernel] = None,
        alpha: float = 1e-10,
        random_state=None,
        noise: Optional[str] = "gaussian",
        normalize_y: bool = False,
        warp_inputs: bool = False,
        moves="auto",
        optimizer: Optional[str] = "lbfgs",
        n_restarts_optimizer: int = 0,
        copy_X_train: bool = True,
        chain_init: str = "ball",
        ml2_subsample: Optional[int] = None,
        ml2_objective: str = "lml",
        host_prior_mode: str = "callback",
        row_mesh=None,
        row_nb: int = 256,
        row_unroll: bool = False,
        row_grad_method: str = "adjoint",
        device=None,
        dtype=torch.float32,
    ):
        if kernel is None:
            kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(1.0, (1e-5, 1e5))
        if host_prior_mode not in ("callback", "interp"):
            raise ValueError(
                "host_prior_mode must be 'callback' (exact, needs backend "
                "callback support) or 'interp' (approximate on-device "
                f"tabulation), got {host_prior_mode!r}"
            )
        if row_mesh is not None and len(row_mesh.axis_names) not in (1, 2):
            raise ValueError(
                "row_mesh must have one (rows) or two (walkers, rows) "
                f"axes, got {row_mesh.axis_names}"
            )
        if row_grad_method not in ("adjoint", "jvp"):
            raise ValueError(
                "row_grad_method must be 'adjoint' (D-independent cost, "
                "~4-5 gram strips of peak memory) or 'jvp' (D sweeps, "
                f"leanest ~2-strip memory), got {row_grad_method!r}"
            )
        if chain_init not in ("ball", "laplace"):
            raise ValueError(f"chain_init must be 'ball' or 'laplace', got {chain_init!r}")
        if ml2_subsample is not None and int(ml2_subsample) < 2:
            raise ValueError(f"ml2_subsample must be >= 2 points, got {ml2_subsample}")
        if ml2_objective not in ("lml", "map"):
            raise ValueError(f"ml2_objective must be 'lml' or 'map', got {ml2_objective!r}")
        self._user_kernel = kernel
        self.alpha = alpha
        self.noise = noise
        self.normalize_y = normalize_y
        self.warp_inputs = warp_inputs
        self.moves = _canonical_moves(moves)
        self.optimizer = optimizer
        self.n_restarts_optimizer = n_restarts_optimizer
        self.copy_X_train = copy_X_train
        self.chain_init = chain_init
        self.ml2_subsample = None if ml2_subsample is None else int(ml2_subsample)
        self.ml2_objective = ml2_objective
        self.host_prior_mode = host_prior_mode
        self.row_mesh = row_mesh
        self.row_nb = int(row_nb)
        self.row_unroll = bool(row_unroll)
        self.row_grad_method = row_grad_method
        self.device = torch.device("cuda" if device is None else device)
        self.dtype = dtype
        if isinstance(random_state, np.random.RandomState):
            self.random_state = random_state
        else:
            self.random_state = np.random.RandomState(random_state)

        self._spec: Optional[bk.Kernel] = None
        self.chain_: Optional[np.ndarray] = None
        self.chain_steps_: Optional[np.ndarray] = None  # (steps, W, D)
        self.pos_: Optional[np.ndarray] = None
        self.noise_: Optional[float] = None
        self.log_marginal_likelihood_value_: Optional[float] = None
        self.warp_alphas_: Optional[np.ndarray] = None
        self.warp_betas_: Optional[np.ndarray] = None
        self.until_rhat_result_ = None
        self._theta: Optional[np.ndarray] = None
        self._data: Optional[gpc.GPData] = None
        # the posterior's data: _data with the consensus warp applied
        self._post_data: Optional[gpc.GPData] = None
        self._post: Optional[gpc.GPPosterior] = None
        self._X_orig: Optional[np.ndarray] = None
        self._y_orig: Optional[np.ndarray] = None
        self._noise_vector: Optional[np.ndarray] = None
        self._priors_cache = None
        self._noise_zero = False
        self.n_accepted_ = 0
        self.n_proposals_ = 0
        self.y_train_mean_ = 0.0
        self.y_train_std_ = 1.0

    def __getstate__(self):
        """Tensors go to the pickle as NumPy (a pickle made on the card
        loads without one), and resolved priors are dropped (they are
        derived again). A row mesh holds devices (and maybe a process
        group) and is dropped too: reattach it by assigning ``row_mesh``."""
        state = self.__dict__.copy()
        state["row_mesh"] = None
        for name in ("_data", "_post_data", "_post"):
            if state.get(name) is not None:
                state[name] = _to_numpy(state[name])
        lml = state.get("_consensus_lml_")
        if isinstance(lml, torch.Tensor):
            state["_consensus_lml_"] = float(lml)
        state["_priors_cache"] = None
        return state

    def __setstate__(self, state):
        # defaults for models pickled before these attributes existed
        for name, default in (
            ("optimizer", "lbfgs"), ("n_restarts_optimizer", 0), ("copy_X_train", True),
            ("chain_init", "ball"), ("ml2_subsample", None), ("ml2_objective", "lml"),
            ("row_mesh", None), ("row_nb", 256), ("row_unroll", False),
            ("row_grad_method", "adjoint"), ("host_prior_mode", "callback"),
        ):
            state.setdefault(name, default)
        state.pop("_prior_cache", None)  # the per-model cache of earlier pickles
        self.__dict__.update(state)
        for name in ("_data", "_post_data", "_post"):
            if getattr(self, name, None) is not None:
                setattr(self, name, _to_device(getattr(self, name), self.device))

    # -- basic properties --------------------------------------------------

    @property
    def kernel_(self):
        """Fitted kernel spec with the consensus hyperparameters baked in."""
        if self._spec is None:
            return None
        t = self._theta
        if t is None or np.isnan(np.asarray(t, dtype=float)).any():
            return self._spec
        return self._spec.with_theta(np.asarray(t, dtype=float))

    @kernel_.setter
    def kernel_(self, value):
        self._spec = value

    @property
    def X_train_(self):
        """Training inputs (warped if ``warp_inputs``), unpadded."""
        if self._X_orig is None:
            return None
        return self.warp(self._X_orig)

    @X_train_.setter
    def X_train_(self, X_train):
        """Replace the training inputs (original, unwarped space); the
        warped view and the posterior are rederived."""
        X_train = np.atleast_2d(np.asarray(X_train, dtype=float))
        self._X_orig = np.copy(X_train) if self.copy_X_train else X_train
        if self._y_orig is not None:
            self._upload()
            self._refresh_posterior(with_lml=False)

    @property
    def y_train_(self):
        if self._y_orig is None:
            return None
        return (self._y_orig - self.y_train_mean_) / self.y_train_std_

    @property
    def theta(self):
        return None if self._theta is None else np.copy(self._theta)

    @theta.setter
    def theta(self, value):
        self._theta = np.asarray(value, dtype=float)
        self._refresh_posterior()

    @property
    def L_(self):
        if self._post is None:
            return None
        n = len(self._y_orig)
        return self._post.L[:n, :n].cpu().numpy()

    @property
    def alpha_(self):
        if self._post is None:
            return None
        return self._post.alpha_dual[: len(self._y_orig)].cpu().numpy()

    @property
    def K_inv_(self):
        """Inverse of the (noisy) training gram, unpadded, from the factor."""
        if self._post is None:
            return None
        n = len(self._y_orig)
        L_inv = np.linalg.solve(self.L_.astype(float), np.eye(n))
        return L_inv.T @ L_inv

    @property
    def white_index_(self):
        return None if self._spec is None else bk.white_theta_index(self._spec)

    def _tensor(self, x):
        a = np.asarray(x)
        with trace.wait():  # an upload from host memory waits for the stream
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- data management ---------------------------------------------------

    def _set_data(self, X, y, noise_vector):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float).ravel()
        self._X_orig = np.copy(X) if self.copy_X_train else X
        self._y_orig = np.copy(y) if self.copy_X_train else y
        if self.normalize_y:
            self.y_train_mean_ = float(np.mean(self._y_orig))
            self.y_train_std_ = float(np.std(self._y_orig)) or 1.0
        else:
            self.y_train_mean_, self.y_train_std_ = 0.0, 1.0
        if noise_vector is not None:
            noise_vector = np.asarray(noise_vector, dtype=float) / self.y_train_std_**2
        self._noise_vector = noise_vector
        self._upload()

    def _noise_rows(self):
        """The per-point noise of the training rows (normalized units), or
        None."""
        if self._noise_vector is None:
            return None
        nv = np.zeros(len(self._y_orig))
        v = np.asarray(self._noise_vector, dtype=float)
        nv[: len(v)] += v
        return nv

    def _build_padded_data(self, X, y, noise_rows=None):
        """Padded device-side GPData of raw rows with the model's
        normalization, jitter floor and 64-bucket."""
        n, d = X.shape
        n_pad = _bucket(n)
        Xp = np.full((n_pad, d), 0.5)
        Xp[:n] = X
        yp = np.zeros(n_pad)
        yp[:n] = (y - self.y_train_mean_) / self.y_train_std_
        # float32 cannot represent a 1e-10 jitter against a unit-scale
        # gram; floor it so near-noise-free problems still factor
        base_alpha = self.alpha
        if self.dtype == torch.float32:
            base_alpha = max(base_alpha, 1e-6)
        alpha = np.full(n_pad, base_alpha)
        if noise_rows is not None:
            alpha[:n] += noise_rows
        return gpc.make_data(
            self._tensor(Xp),
            self._tensor(yp),
            self._tensor(alpha),
            np.arange(n_pad) < n,
            y_mean=self.y_train_mean_,
            y_std=self.y_train_std_,
        )

    def _upload(self):
        """(Re)build the padded device-side GPData."""
        self._data = self._build_padded_data(self._X_orig, self._y_orig, self._noise_rows())

    def _n_warp(self) -> int:
        return self._X_orig.shape[1] if self.warp_inputs else 0

    def _warp_params(self):
        """(log_alphas, log_betas) tensors of the consensus warp, or None."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        return self._tensor(self.warp_alphas_), self._tensor(self.warp_betas_)

    def _warp_tensor(self, X):
        """X (..., d) tensor in the consensus-warped space (``span.gp.warp``;
        without warping X itself, and no span)."""
        params = self._warp_params()
        if params is None:
            return X
        with trace.span("span.gp.warp"):
            return wp.warp(X, *params)

    def _row_cfg(self):
        """``(row_mesh, row_nb, row_unroll)``, or None outside row mode (or
        with the mesh detached by a pickle)."""
        if self.row_mesh is None:
            return None
        return (self.row_mesh, self.row_nb, self.row_unroll)

    def _row_lml(self, theta, warp=None):
        """Row-sharded LML at a kernel ``theta`` tensor on the unwarped
        data, warped inside by ``warp`` = (log_alphas, log_betas)."""
        from ..ops.dist_chol import row_sharded_lml

        X = self._data.X if warp is None else wp.warp(self._data.X, *warp)
        d = self._data
        return row_sharded_lml(self._spec, theta, X, d.y, d.alpha_diag, d.mask,
                               self.row_mesh, nb=self.row_nb, unroll=self.row_unroll)

    def _refresh_posterior(self, with_lml: bool = True):
        """Consensus refresh: warp -> robust factorization -> LML. In row
        mode no factor is kept (predictions re-run the sweep) and the
        consensus LML is one sweep."""
        if self._theta is None or self._data is None:
            return
        if self.row_mesh is not None:
            self._post = None
            self._post_data = self._data
            self._consensus_lml_ = (
                self._row_lml(self._tensor(self._theta), self._warp_params())
                if with_lml else None
            )
            return
        data = self._data._replace(X=self._warp_tensor(self._data.X))
        theta = self._tensor(self._theta)
        self._post_data = data
        if with_lml:
            self._post, self._consensus_lml_ = _consensus_body(self._spec, theta, data)
        else:
            self._post = _posterior_robust_body(theta, data, self._spec)
            self._consensus_lml_ = None

    # -- ML-II warm start --------------------------------------------------

    def _ml2_optimize(self):
        """The warm start's theta, as the JAX package computes it: on a
        random ``ml2_subsample``-point subset where set (the full data's
        normalization), from ``theta0`` and ``n_restarts_optimizer`` starts
        drawn uniformly in the bounds; SciPy's L-BFGS-B on the negative LML
        (or, with ``ml2_objective="map"``, the negative log posterior under
        the guessed priors) with value and gradient from autograd through
        the plain factorization, or ``optimizer="lbfgs-device"``. The
        result only seeds the chain, so iterations are capped at 60. In
        row mode the value and gradient come from the row-sharded sweep
        (``row_grad_method``), except on a subsample, which takes the
        dense path, and ``"map"`` falls back to the bare LML with a
        warning, as in the JAX package."""
        with trace.span("span.gp.ml2"):
            kernel, data = self._spec, self._data
            bounds = kernel.bounds
            row_cfg = self._row_cfg()
            n = self._X_orig.shape[0]
            if self.ml2_subsample is not None and n > self.ml2_subsample:
                row_cfg = None
                idx = np.sort(self.random_state.choice(n, size=self.ml2_subsample, replace=False))
                noise_rows = self._noise_rows()
                data = self._build_padded_data(
                    self._X_orig[idx], self._y_orig[idx],
                    None if noise_rows is None else noise_rows[idx],
                )
            objective = self.ml2_objective
            if objective == "map" and row_cfg is not None:
                warnings.warn(
                    "ml2_objective='map' runs on the dense warm-start path "
                    "(its value+grad program materializes the padded gram); "
                    "set ml2_subsample to use it in row mode — falling back "
                    "to the bare-LML objective for this fit.",
                    UserWarning,
                )
                objective = "lml"
            # the bare LML is the log posterior under no priors
            priors = self._resolve_priors(None) if objective == "map" else ()
            starts = [kernel.theta0]
            for _ in range(self.n_restarts_optimizer):
                starts.append(self.random_state.uniform(bounds[:, 0], bounds[:, 1]))

            if self.optimizer == "lbfgs-device" and objective == "map":
                warnings.warn(
                    "ml2_objective='map' is implemented on the host L-BFGS-B "
                    "optimizer only; ignoring optimizer='lbfgs-device' for this fit.",
                    UserWarning,
                )
            elif self.optimizer == "lbfgs-device":
                if np.isfinite(bounds).all() and (bounds[:, 1] > bounds[:, 0]).all():
                    best = _ml2_device(
                        self._tensor(np.stack(starts)), data, self._tensor(bounds[:, 0]),
                        self._tensor(bounds[:, 1]), kernel, row_cfg=row_cfg,
                        grad_method=self.row_grad_method,
                    )
                    return best.cpu().double().numpy()
                # the sigmoid reparameterization needs finite, non-degenerate
                # bounds; L-BFGS-B handles both
                warnings.warn(
                    "optimizer='lbfgs-device' requires finite, non-degenerate "
                    "hyperparameter bounds; falling back to the host L-BFGS-B "
                    "optimizer for this fit.",
                    UserWarning,
                )

            from scipy.optimize import minimize

            row_vg = (None if row_cfg is None
                      else _row_neg_lml_value_grad(kernel, row_cfg, self.row_grad_method, data))

            def obj(t):
                with trace.span("span.gp.objective"):
                    if row_vg is not None:
                        v, g = row_vg(self._tensor(t)[None, :])
                        v, g = float(v[0]), g[0].cpu().double().numpy()
                    else:
                        v, g = _log_post_value_grad(data, self._tensor(t), kernel, priors, 0)
                if not np.isfinite(v):
                    return 1e25, np.zeros_like(t)
                return v, g

            best_t, best_v = None, np.inf
            for t0 in starts:
                res = minimize(
                    obj, t0, jac=True, method="L-BFGS-B", bounds=bounds,
                    options={"maxiter": 60},
                )
                if res.fun < best_v:
                    best_t, best_v = res.x, res.fun
            return np.asarray(best_t, dtype=float)

    # -- sampling ----------------------------------------------------------

    def _resolve_priors(self, priors):
        """The priors as the chain evaluates them: guessed from the kernel
        (``None``), or each user prior as :meth:`_resolve_prior` gives it."""
        if priors is None:
            if self._priors_cache is None:
                self._priors_cache = tuple(guess_priors(self._spec))
            return self._priors_cache
        if callable(priors):
            return self._resolve_prior(priors, joint=True)
        return tuple(self._resolve_prior(p, joint=False, dim=i) for i, p in enumerate(priors))

    def _resolve_prior(self, p, joint: bool, dim=None):
        """``p`` itself where it maps a tensor of the model's dtype and
        device to a tensor there (elementwise on (W,), or joint on
        (W, n_theta) -> (W,)); a joint torch prior of one theta vector,
        batched by ``torch.vmap``; an exact torch lift of a frozen SciPy
        ``logpdf``; with ``host_prior_mode="interp"``, an elementwise prior
        of theta entry ``dim`` tabulated on the device; else a
        :class:`_HostPrior`, with a warning once per prior (the JAX
        package's ``_traceable_or_host``)."""
        probe = torch.zeros((2, self._spec.n_theta) if joint else (2,),
                            dtype=self.dtype, device=self.device)
        if _returns_batch(p, probe, 2):
            return p
        key = (p, joint, self.host_prior_mode)
        try:
            cached = _PRIOR_CACHE.get(key)
        except TypeError:  # unhashable callable: no cache
            key = cached = None
        if cached is not None:
            _PRIOR_CACHE.move_to_end(key)
            return cached
        resolved = None
        if joint:
            batched = _VmappedPrior(p)
            if _returns_batch(batched, probe, 2):
                resolved = batched
        else:
            from ..utils.scipy_lift import lift_scipy_prior

            resolved = lift_scipy_prior(p)
            if resolved is None and self.host_prior_mode == "interp":
                return self._interp_prior(p, dim)
        if resolved is None:
            warnings.warn(
                "A gp prior is not a torch function and runs on the host "
                "through an adapter: one device-to-host copy of theta (a "
                "sync) per log-probability, which stalls the chain on a GPU. "
                "Write priors with torch (see bask_tpu_torch.utils.priors), "
                "or pass a frozen scipy distribution's logpdf directly "
                "(common families are lifted to exact torch code).",
                UserWarning,
                stacklevel=4,
            )
            resolved = _HostPrior(p, joint)
        if key is not None:
            _cache_put(_PRIOR_CACHE, key, resolved)
        return resolved

    def _interp_prior(self, p, dim):
        """Tabulated on-device approximation of an opaque prior
        (``host_prior_mode="interp"``): no host adapter, so the chain stays
        on the card (and is captured in a CUDA graph). Range = this theta
        dimension's log-bounds +- ``_INTERP_PRIOR_MARGIN``; linear
        extrapolation beyond. The table is placed on the model's device."""
        from ..utils.scipy_lift import tabulate_prior

        bounds = np.asarray(self._spec.bounds, dtype=float)
        if dim is not None and 0 <= dim < bounds.shape[0]:
            lo, hi = bounds[dim]
        else:  # pragma: no cover - elementwise priors always carry dim
            lo, hi = -12.0, 12.0
        # infinite log-bounds (fixed-less parameters) cannot be
        # tabulated: clamp to a wide default range instead
        if not np.isfinite(lo):
            lo = -12.0
        if not np.isfinite(hi):
            hi = 12.0
        lo, hi = lo - _INTERP_PRIOR_MARGIN, hi + _INTERP_PRIOR_MARGIN
        try:
            key = (p, lo, hi)
            interp = _INTERP_PRIOR_CACHE.get(key)
        except TypeError:  # unhashable callable
            key, interp = None, None
        if interp is not None:
            _INTERP_PRIOR_CACHE.move_to_end(key)
        else:
            interp, max_err = tabulate_prior(p, lo, hi)
            warnings.warn(
                "host_prior_mode='interp': a non-traceable gp prior is "
                f"approximated by on-device interpolation over [{lo:.2f}, "
                f"{hi:.2f}] (measured max |Δlog-density| ≈ {max_err:.2e}). "
                "Chain numerics differ slightly from the exact host prior; "
                "use host_prior_mode='callback' for exactness.",
                UserWarning,
                stacklevel=4,
            )
            if key is not None:
                _cache_put(_INTERP_PRIOR_CACHE, key, interp)
        interp.table(self.device, torch.promote_types(self.dtype, torch.float32))
        return interp

    def _laplace_positions(self, theta, n_walkers, priors, n_warp):
        """(W, D) cold-start positions from the Laplace approximation
        N(theta_MAP, H^-1), or ``None`` where the curvature is unusable
        (the caller falls back to the ball), as the JAX package computes
        them: the theta block is refined to the posterior mode by an
        unbounded L-BFGS-B (50 iterations) on the exact log posterior, the
        Hessian taken there (central differences of the gradient where the
        double backward is not finite), its eigendirections' spreads
        clamped to [``_LAPLACE_STD_MIN``, ``_LAPLACE_STD_MAX``]; warp
        dimensions keep the ball width."""
        theta = np.asarray(theta, dtype=float)
        n_theta = theta.shape[0] - 2 * n_warp

        def grad_at(tg):
            x = self._tensor(np.concatenate([tg, theta[n_theta:]]))
            return _log_post_value_grad(self._data, x, self._spec, priors, n_warp)

        try:
            from scipy.optimize import minimize

            def obj(tg):
                v, g = grad_at(tg)
                if not np.isfinite(v):
                    return 1e25, np.zeros_like(g)
                return v, g

            res = minimize(obj, theta[:n_theta], jac=True, method="L-BFGS-B",
                           options={"maxiter": 50})
            center = theta.copy()
            if np.isfinite(res.fun) and np.all(np.isfinite(res.x)):
                center[:n_theta] = res.x
            H = _log_post_hessian(self._data, self._tensor(center), self._spec, priors, n_warp)
            if not np.all(np.isfinite(H)):
                eps = 1e-2
                Hfd = np.empty((n_theta, n_theta))
                for i in range(n_theta):
                    tp = center[:n_theta].copy()
                    tm = center[:n_theta].copy()
                    tp[i] += eps
                    tm[i] -= eps
                    # grad_at is the NEGATIVE log posterior's gradient
                    Hfd[:, i] = -(grad_at(tp)[1] - grad_at(tm)[1]) / (2.0 * eps)
                H = Hfd
        except Exception as e:  # host priors have no gradient, etc.
            warnings.warn(
                f"chain_init='laplace' could not evaluate the "
                f"log-posterior Hessian ({type(e).__name__}: {e}); "
                "falling back to the ball init.",
                UserWarning,
                stacklevel=3,
            )
            return None
        if not np.all(np.isfinite(H)):
            return None
        prec = -0.5 * (H + H.T)  # symmetrized negative Hessian
        w, V = np.linalg.eigh(prec)
        with np.errstate(divide="ignore"):
            std = np.where(w > 0, 1.0 / np.sqrt(np.abs(w) + 1e-300), np.inf)
        std = np.clip(std, _LAPLACE_STD_MIN, _LAPLACE_STD_MAX)
        z = self.random_state.randn(n_walkers, theta.shape[0])
        pos = np.empty((n_walkers, theta.shape[0]))
        pos[:, :n_theta] = center[None, :n_theta] + (z[:, :n_theta] * std[None, :]) @ V.T
        if n_warp:
            pos[:, n_theta:] = center[None, n_theta:] + _LAPLACE_STD_MIN * z[:, n_theta:]
        return pos

    @staticmethod
    def _resolve_warp_priors(warp_priors):
        """None: :func:`warping.default_warp_log_prior`; a pair of
        elementwise log-priors (alphas, betas): summed over dimensions (one
        object per pair); a callable of batched (W, d) log-alphas and
        log-betas -> (W,)."""
        if warp_priors is None:
            return wp.default_warp_log_prior
        if isinstance(warp_priors, (tuple, list)):
            a_prior, b_prior = key = tuple(warp_priors)
            try:
                cached = _WARP_PRIOR_CACHE.get(key)
            except TypeError:  # unhashable priors: no cache
                key = cached = None
            if cached is not None:
                return cached

            def warp_prior(log_alphas, log_betas):
                return a_prior(log_alphas).sum(-1) + b_prior(log_betas).sum(-1)

            if key is not None:
                _cache_put(_WARP_PRIOR_CACHE, key, warp_prior)
            return warp_prior
        return warp_priors

    def _chain_graph(self, priors, warp_prior, n_warp, mesh, row_cfg):
        """The chain's :class:`~bask_tpu_torch.parallel.mcmc.ChainGraph`, or
        ``None`` where the configuration keeps the chain eager: ``mesh=``
        or ``row_mesh`` (shards issued from the host), a host-adapter prior
        (a device-to-host copy per log-probability), or grams outside the
        fused kernels (a CPU device, float64, a bucket off the kernels'
        tile, a kernel outside ``Const * (Matern|RBF) [+ White]``; a
        general-nu Matern syncs the host). Both factorization routes
        capture (``linalg.FAST_CHOLESKY``: the blocked one with K3 bases, or
        "off"'s ``cholesky_ex`` and triangular solve: cuSOLVER's
        ``potrfBatched`` and cuBLAS's batched ``trsm`` on the card, which
        capture with the default linalg backend); the graph cache keys on
        the switch. The key holds the fused spec and
        the priors' identities; the entry's log-probability keeps them
        alive, so no identity is reused while it is cached."""
        data = self._data
        spec = fused_spec_for(self._spec, data.X)
        priors_seq = (priors,) if callable(priors) else tuple(priors)
        if (mesh is not None or row_cfg is not None or spec is None
                or any(isinstance(p, _HostPrior) for p in priors_seq)):
            return None
        kernel = self._spec
        n_real = _n_real_arg(len(self._y_orig), data.X.shape[0], data.X.device)

        def build(bufs):
            X, y, alpha_diag, mask, n_real_buf = bufs
            return _make_log_prob_batch(
                kernel, priors, gpc.GPData(X, y, alpha_diag, mask, 0.0, 1.0), n_real_buf,
                warp_prior, n_warp,
            )

        key = (spec, tuple(id(p) for p in priors_seq), callable(priors), id(warp_prior), n_warp)
        return ChainGraph(key=key, inputs=(data.X, data.y, data.alpha_diag, data.mask, n_real),
                          build=build)

    @torch.no_grad()
    def sample(
        self,
        X=None,
        y=None,
        noise_vector=None,
        n_threads: int = 1,
        n_desired_samples: int = 100,
        n_burnin: int = 0,
        n_thin: int = 1,
        n_walkers_per_thread: int = 100,
        progress: bool = False,
        priors=None,
        warp_priors=None,
        position=None,
        add: bool = False,
        mesh=None,
        warn_rhat="default",
        moves=None,
        until_rhat: Optional[float] = None,
        max_extensions: int = 10,
        extension_steps: Optional[int] = None,
        chain_init: Optional[str] = None,
        _consensus: bool = True,
        **kwargs,
    ):
        """Sample the kernel-hyperparameter posterior on the device.

        Warm-starts from ``pos_`` when its shape fits, otherwise cold:
        from a 1e-2 ball around the current theta, or with ``chain_init``
        (``None``: the constructor's) ``"laplace"`` from the Laplace
        approximation at the posterior mode (the ball where its curvature
        is unusable); runs
        ``ceil(n_desired_samples / n_walkers) + n_burnin`` steps of
        ``n_walkers = max(2, n_threads * n_walkers_per_thread)`` walkers
        (rounded up to even, as in the JAX package) and sets
        the consensus model at the geometric median of the kept chain.
        ``until_rhat`` then warm-extends the chain in legs of
        ``extension_steps`` steps until the max split R-hat of its second
        half is at most ``until_rhat``, or ``max_extensions`` legs were
        added. ``progress`` shows a progress bar over each run's steps
        (a no-op where ``tqdm`` is missing); the chain is the same.

        ``mesh``: a 1-axis :class:`~bask_tpu_torch.parallel.mesh.Mesh`; each
        half-ensemble's LMLs are sharded over it (``batched_lml(mesh=)``),
        with the walker count rounded up to a multiple of twice its size
        (100 -> 112 on 8 entries). The chain equals the unsharded one. A
        model built with ``row_mesh=`` row-shards every walker's
        factorization instead (a 2-axis row mesh rounds the walkers to
        twice its first axis), and ``mesh=`` is then refused.
        """
        self.until_rhat_result_ = None
        if isinstance(warn_rhat, str):  # "default"
            warn_rhat = None if until_rhat is not None else DEFAULT_WARN_RHAT
        common = dict(
            n_thin=n_thin, n_threads=n_threads,
            n_walkers_per_thread=n_walkers_per_thread, progress=progress, priors=priors,
            warp_priors=warp_priors, moves=moves, warn_rhat=None, mesh=mesh, **kwargs,
        )
        if until_rhat is not None:
            self.sample(
                X, y, noise_vector, n_desired_samples=n_desired_samples,
                n_burnin=n_burnin, position=position, add=add,
                chain_init=chain_init, **common,
            )

            def _second_half_rhat():
                steps = self.chain_steps_
                if steps is None or steps.shape[0] < 4:
                    return float("inf")
                from ..utils.diagnostics import split_rhat

                half = steps[steps.shape[0] // 2 :]
                if half.shape[0] < 4:
                    half = steps
                return float(np.max(split_rhat(half)))

            if extension_steps is not None:
                leg_samples = int(extension_steps) * int(self.pos_.shape[0])
            else:
                leg_samples = n_desired_samples
            extended = False
            for _ in range(max_extensions):
                if _second_half_rhat() <= until_rhat:
                    break
                extended = True
                self.sample(
                    n_desired_samples=leg_samples, n_burnin=0,
                    position=self.pos_, add=True, _consensus=False, **common,
                )
            if extended:
                self._set_consensus_from_flat(self._tensor(self.chain_))
            final_rhat = _second_half_rhat()
            self.until_rhat_result_ = {
                "rhat": final_rhat,
                "threshold": until_rhat,
                "converged": bool(final_rhat <= until_rhat),
                "steps": int(self.chain_steps_.shape[0]),
            }
            if final_rhat > until_rhat:
                warnings.warn(
                    f"sample(until_rhat={until_rhat}) did not converge within "
                    f"max_extensions={max_extensions} legs: max split R-hat "
                    f"{final_rhat:.3f}.",
                    UserWarning,
                    stacklevel=2,
                )
            elif warn_rhat is not None and final_rhat > warn_rhat:
                warnings.warn(
                    f"MCMC chain may not be converged: max split R-hat "
                    f"{final_rhat:.3f} exceeds the threshold {warn_rhat}.",
                    UserWarning,
                    stacklevel=2,
                )
            return self

        if (X is None and self._X_orig is None) or self._spec is None:
            raise ValueError("No data to sample from: pass X and y or call fit first.")
        with trace.span("span.gp.stage"):
            if X is not None:
                self._set_data(X, y, noise_vector)
            elif noise_vector is not None:
                self._noise_vector = np.asarray(noise_vector, dtype=float) / self.y_train_std_**2
                self._upload()

            priors = self._resolve_priors(priors)
            warp_prior = self._resolve_warp_priors(warp_priors)
            n_warp = self._n_warp()
            n_dim = self._spec.n_theta + 2 * n_warp
            n_walkers = max(2, n_threads * n_walkers_per_thread)
            n_walkers += n_walkers % 2
            row_cfg = self._row_cfg()
            if row_cfg is not None and mesh is not None:
                raise ValueError(
                    "mesh= and row_mesh are mutually exclusive: use a "
                    "two-axis row_mesh=(walkers, rows) to combine walker "
                    "data-parallelism with row-sharded factorizations."
                )
            if mesh is not None:
                # each half-ensemble shards evenly: a multiple of 2 x the mesh size
                m = 2 * int(np.prod(list(mesh.shape.values())))
                n_walkers = -(-n_walkers // m) * m
            if row_cfg is not None and len(self.row_mesh.axis_names) == 2:
                m = 2 * int(self.row_mesh.shape[self.row_mesh.axis_names[0]])
                n_walkers = -(-n_walkers // m) * m
            if position is not None:
                n_walkers = int(np.asarray(position).shape[0])
            n_steps = int(math.ceil(n_desired_samples / n_walkers)) + n_burnin
            if len(range(n_burnin + n_thin - 1, n_steps, n_thin)) < 1:
                raise ValueError(
                    f"Retained chain would be empty: n_desired_samples="
                    f"{n_desired_samples} with {n_walkers} walkers gives "
                    f"{n_steps - n_burnin} post-burnin step(s) and thin={n_thin} "
                    "keeps none of them."
                )

            if position is not None:
                pos = np.asarray(position, dtype=float)
            elif self.pos_ is not None and self.pos_.shape == (n_walkers, n_dim):
                pos = self.pos_
            else:
                theta = np.copy(self._theta)
                bad = ~np.isfinite(theta)
                if bad.any():
                    usable = self.noise_ and np.isfinite(self.noise_) and self.noise_ > 0
                    theta[bad] = math.log(self.noise_) if usable else -10.0
                # warp dimensions start at the identity warp, log a = log b = 0
                theta = np.concatenate([theta, np.zeros(2 * n_warp)])
                ci = self.chain_init if chain_init is None else chain_init
                if ci not in ("ball", "laplace"):
                    raise ValueError(f"chain_init must be 'ball' or 'laplace', got {ci!r}")
                pos = None
                # row mode keeps the ball: the Laplace Hessian is a dense
                # (n, n) factorization, what row mode exists to avoid
                if ci == "laplace" and row_cfg is None:
                    pos = self._laplace_positions(theta, n_walkers, priors, n_warp)
                if pos is None:
                    pos = theta[None, :] + 1e-2 * self.random_state.randn(n_walkers, n_dim)
            seed = int(self.random_state.randint(0, 2**31 - 1))

            moves = _canonical_moves(moves) if moves is not None else self.moves
            if moves == "auto":
                w = pos.shape[0]
                moves = _MOVE_ALIASES["demix"] if w >= 6 else (("de", 1.0),) if w >= 4 else None

            log_prob = _make_log_prob_batch(
                self._spec, priors, self._data, len(self._y_orig), warp_prior, n_warp,
                mesh=mesh, row_cfg=row_cfg,
            )
            pos0 = self._tensor(pos)
            graph = self._chain_graph(priors, warp_prior, n_warp, mesh, row_cfg)
        chain_dev, final = run_ensemble(
            log_prob, pos0, seed, n_steps, a=float(kwargs.get("a", 2.0)), moves=moves,
            progress=progress, graph=graph,
        )
        flat = flatten_chain(chain_dev, discard=n_burnin, thin=n_thin)
        kept_dev = chain_dev[n_burnin + n_thin - 1 :: n_thin]
        with trace.wait():
            kept_steps = kept_dev.cpu().numpy()
        homogeneous_add = False
        if add and self.chain_ is not None:
            if (
                self.chain_steps_ is not None
                and self.chain_steps_.shape[1:] == kept_steps.shape[1:]
                and self.chain_steps_.size == self.chain_.size
            ):
                homogeneous_add = True
                self.chain_steps_ = np.concatenate([self.chain_steps_, kept_steps])
                self.chain_ = self.chain_steps_.reshape(-1, kept_steps.shape[-1])
            else:
                with trace.wait():
                    flat_host = flat.cpu().numpy()
                self.chain_ = np.concatenate([self.chain_, flat_host])
                self.chain_steps_ = kept_steps
            flat = self._tensor(self.chain_)
        else:
            self.chain_steps_ = kept_steps
            self.chain_ = kept_steps.reshape(-1, kept_steps.shape[-1])
        with trace.wait():
            self.pos_ = final.pos.cpu().numpy()
        with trace.wait():
            accepted = int(final.accepted)
        _maybe_warn_rhat(self.chain_steps_, warn_rhat)
        w_act = self.chain_steps_.shape[1]
        if homogeneous_add and self.n_proposals_:
            self.n_accepted_ += accepted
            self.n_proposals_ += n_steps * w_act
        else:
            self.n_accepted_ = accepted
            self.n_proposals_ = n_steps * w_act
        if _consensus:
            self._set_consensus_from_flat(flat)
        return self

    def _set_consensus_from_flat(self, flat):
        """Geometric-median consensus over a flat (device) chain: the
        median splits into theta and the warp parameters, then the
        posterior and the consensus LML are refreshed on the warped data."""
        with trace.span("span.gp.consensus"):
            median = geometric_median(flat)
            with trace.wait():
                median = median.cpu()
            median = median.double().numpy()
            n_gp, n_warp = self._spec.n_theta, self._n_warp()
            if n_warp:
                self.warp_alphas_ = median[n_gp : n_gp + n_warp]
                self.warp_betas_ = median[n_gp + n_warp :]
            self._theta = median[:n_gp]
            widx = self.white_index_
            if widx is not None:
                self.noise_ = float(np.exp(self._theta[widx]))
            self._refresh_posterior()
            with trace.wait():
                self.log_marginal_likelihood_value_ = float(self._consensus_lml_)
            return self

    def fit(
        self,
        X,
        y,
        noise_vector=None,
        n_threads: int = 1,
        n_desired_samples: int = 100,
        n_burnin: int = 10,
        n_walkers_per_thread: int = 100,
        progress: bool = True,
        priors=None,
        warp_priors=None,
        position=None,
        **kwargs,
    ):
        """ML-II warm start (kernel theta at the identity warp; theta0
        with ``optimizer=None``), then hyperposterior sampling (with a
        progress bar by default, as in the JAX package)."""
        with trace.span("span.gp.fit"):
            if self.noise == "gaussian" and bk.white_theta_index(self._user_kernel) is None:
                self._spec = self._user_kernel + bk.WhiteKernel(1.0, (1e-5, 1e5))
            else:
                self._spec = self._user_kernel
            self._priors_cache = None
            self._set_data(X, y, noise_vector)
            theta_ml = self._ml2_optimize() if self.optimizer is not None else self._spec.theta0
            self._theta = theta_ml
            widx = self.white_index_
            if widx is not None:
                self.noise_ = float(np.exp(theta_ml[widx]))
            return self.sample(
                n_threads=n_threads,
                n_desired_samples=n_desired_samples,
                n_burnin=n_burnin,
                n_walkers_per_thread=n_walkers_per_thread,
                progress=progress,
                priors=priors,
                warp_priors=warp_priors,
                position=position,
                add=False,
                **kwargs,
            )

    def mcmc_diagnostics(self, c: float = 5.0) -> dict:
        """Convergence diagnostics of the kept chain: per-dimension split
        R-hat, effective sample size and integrated autocorrelation time
        (Sokal window constant ``c``), the acceptance rate, and the
        chain's steps and walkers."""
        if self.chain_steps_ is None:
            raise ValueError("No chain available: call fit()/sample() first.")
        if self.chain_steps_.shape[0] < 4:
            raise ValueError(
                "Need at least 4 post-burnin steps for diagnostics "
                f"(have {self.chain_steps_.shape[0]}); increase "
                "n_desired_samples or reduce thinning."
            )
        from ..utils.diagnostics import (
            effective_sample_size,
            integrated_autocorr_time,
            split_rhat,
        )

        x = self.chain_steps_
        return {
            "rhat": split_rhat(x),
            "ess": effective_sample_size(x),
            "autocorr_time": integrated_autocorr_time(x, c=c),
            "acceptance": self.n_accepted_ / self.n_proposals_ if self.n_proposals_ else None,
            "n_steps": int(x.shape[0]),
            "n_walkers": int(x.shape[1]),
        }

    # -- prediction --------------------------------------------------------

    @contextmanager
    def noise_set_to_zero(self):
        """Context manager: predictions exclude the Gaussian noise term
        (the factorized posterior is left as it is)."""
        prev = self._noise_zero
        self._noise_zero = True
        try:
            yield self
        finally:
            self._noise_zero = prev

    def _theta_diag(self):
        """Consensus theta of the prior-variance diagonal: noise-free
        inside :meth:`noise_set_to_zero`."""
        theta = self._tensor(self._theta)
        if self._noise_zero:
            return gpc.noise_free_theta(self._spec, theta, self.white_index_)
        return theta

    def _is_fitted(self) -> bool:
        if self.row_mesh is not None:
            # row mode keeps no factor: fitted means a consensus theta over data
            return self._theta is not None and self._data is not None
        return self._post is not None and self._theta is not None

    def _row_predict(self, theta, theta_diag, Xq, warp=None, return_cov=False,
                     with_grad=False):
        """Row-sharded predictions at ``Xq`` (one sweep): ``(mean, std or
        cov[, mean_grad, std_grad])``. ``warp`` = (log_alphas, log_betas)
        warps the training inputs and the queries; the gradients are then
        taken back through the warp's diagonal Jacobian."""
        from ..ops.dist_chol import row_sharded_predict

        d = self._data
        X, Xw = d.X, Xq
        if warp is not None:
            X, Xw = wp.warp(X, *warp), wp.warp(Xq, *warp)
        out = row_sharded_predict(
            self._spec, theta, X, d.y, d.alpha_diag, d.mask, Xw, self.row_mesh,
            nb=self.row_nb, y_mean=d.y_mean, y_std=d.y_std, theta_diag=theta_diag,
            return_cov=return_cov, return_grad=with_grad, unroll=self.row_unroll,
        )
        if warp is not None and with_grad:
            jac = wp.warp_grad(Xq, *warp)
            out = (out[0], out[1], out[2] * jac, out[3] * jac)
        return out

    def _prior_kernel_theta(self):
        """(kernel, theta0) of the GP prior for unfitted predictions: the
        user kernel at its initial hyperparameters, without the WhiteKernel
        that ``fit`` appends (sklearn GPR semantics, as in the JAX
        package)."""
        kernel = self._user_kernel
        return kernel, self._tensor(kernel.theta0)

    def _prior_predict(self, X, return_std, return_cov, return_mean_grad, return_std_grad):
        """Predictions of the GP prior (unfitted model): mean 0, variance
        from the kernel diagonal."""
        kernel, theta = self._prior_kernel_theta()
        Xq = self._tensor(X)
        results = [np.zeros(Xq.shape[0])]
        if return_cov:
            results.append(kernel.eval(theta, Xq).cpu().numpy())
        elif return_std:
            results.append(torch.sqrt(torch.clamp(kernel.diag(theta, Xq), min=0.0)).cpu().numpy())
        if return_mean_grad:
            results.append(np.zeros(Xq.shape))
        if return_std_grad:
            # identically zero for stationary kernels, exact for any spec
            Xg = Xq.clone().requires_grad_(True)
            with torch.enable_grad():
                std = torch.sqrt(torch.clamp(kernel.diag(theta, Xg), min=1e-30))
                g = None
                if std.requires_grad:
                    (g,) = torch.autograd.grad(std.sum(), Xg, allow_unused=True)
            results.append(np.zeros(Xq.shape) if g is None else g.cpu().numpy())
        return results[0] if len(results) == 1 else tuple(results)

    def _predict_grads(self, X):
        """Gradients of the predictive mean and std with respect to each
        query point, by autograd through :func:`gp.predict` (each point's
        mean and std depend on that point alone, so one backward pass of
        their sums gives every row)."""
        Xq = self._tensor(X).requires_grad_(True)
        with torch.enable_grad():
            mean, std = gpc.predict(
                self._spec, self._theta_diag(), self._post, self._post_data,
                self._warp_tensor(Xq), return_std=True,
            )
            (mg,) = torch.autograd.grad(mean.sum(), Xq, retain_graph=True)
            (sg,) = torch.autograd.grad(std.sum(), Xq)
        return mg.cpu().numpy(), sg.cpu().numpy()

    @torch.no_grad()
    def predict(
        self, X, return_std: bool = False, return_cov: bool = False,
        return_mean_grad: bool = False, return_std_grad: bool = False,
    ):
        """Predictive mean (and std or covariance, and the gradients of
        mean and std in each query point) of the consensus GP; with warping
        ``X`` (in [0, 1]) is warped by the consensus warp. Before ``fit``,
        the predictions of the GP prior."""
        X = np.atleast_2d(X)
        if not self._is_fitted():
            return self._prior_predict(
                X, return_std, return_cov, return_mean_grad, return_std_grad
            )
        if self.warp_inputs:
            validate_zeroone(X)
        if self.row_mesh is not None:
            with_grad = return_mean_grad or return_std_grad
            if with_grad and return_cov:
                raise ValueError(
                    "return_cov cannot be combined with prediction "
                    "gradients in row-sharded mode"
                )
            out = self._row_predict(
                self._tensor(self._theta), self._theta_diag(), self._tensor(X),
                self._warp_params(), return_cov=return_cov, with_grad=with_grad,
            )
            results = [out[0].cpu().numpy()]
            if return_std or return_cov:
                results.append(out[1].cpu().numpy())
            if return_mean_grad:
                results.append(out[2].cpu().numpy())
            if return_std_grad:
                results.append(out[3].cpu().numpy())
            return results[0] if len(results) == 1 else tuple(results)
        out = gpc.predict(
            self._spec, self._theta_diag(), self._post, self._post_data,
            self._warp_tensor(self._tensor(X)), return_std=return_std,
            return_cov=return_cov,
        )
        if return_std or return_cov:
            results = [out[0].cpu().numpy(), out[1].cpu().numpy()]
        else:
            results = [out.cpu().numpy()]
        if return_mean_grad or return_std_grad:
            mg, sg = self._predict_grads(X)
            if return_mean_grad:
                results.append(mg)
            if return_std_grad:
                results.append(sg)
        return results[0] if len(results) == 1 else tuple(results)

    def _seed(self, random_state):
        if isinstance(random_state, np.random.RandomState):
            return int(random_state.randint(0, 2**31 - 1))
        if random_state is None:
            return int(self.random_state.randint(0, 2**31 - 1))
        return int(random_state)

    def _normals(self, seed, shape):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def sample_y(
        self,
        X,
        sample_mean: bool = False,
        noise: bool = False,
        n_samples: int = 1,
        random_state=0,
    ):
        """Function draws (n_points, n_samples): from the consensus GP with
        ``sample_mean=True``, else one draw per random chain row (each
        with its own warp, when warping). Before ``fit``, joint draws from
        the GP prior."""
        seed = self._seed(random_state)
        Xq = self._tensor(np.atleast_2d(X))
        if not self._is_fitted():
            kernel, theta = self._prior_kernel_theta()
            cov = kernel.eval(theta, Xq)
            z = self._normals(seed, (Xq.shape[0], n_samples))
            return gpc.eigh_draws(torch.zeros_like(cov[:, 0]), cov, z).cpu().numpy()
        widx = self.white_index_
        if self.row_mesh is not None:
            return self._row_sample_y(Xq, sample_mean, noise, n_samples, seed)
        if sample_mean:
            theta = self._tensor(self._theta)
            td = theta if noise else gpc.noise_free_theta(self._spec, theta, widx)
            z = self._normals(seed, (Xq.shape[0], n_samples))
            return gpc.sample_y(
                self._spec, td, self._post, self._post_data, self._warp_tensor(Xq), z
            ).cpu().numpy()
        rs = np.random.RandomState(seed)
        idx = rs.choice(len(self.chain_), size=n_samples, replace=True)
        rows, data, Xq = gpc.warped_draws(
            self._tensor(self.chain_[idx]), self._data, self._n_warp(), Xq
        )
        grams = gpc.fused_marginal_grams(self._spec, rows, data, n_real=len(self._y_orig))
        post, invs = gpc.posterior_and_invs(self._spec, rows, data, Kp=grams)
        td = rows if noise else gpc.noise_free_theta(self._spec, rows, widx)
        z = self._normals(seed, (n_samples, Xq.shape[-2], 1))
        draws = gpc.sample_y(self._spec, td, post, data, Xq, z, invs=invs)
        return draws[..., 0].T.cpu().numpy()

    def _row_sample_y(self, Xq, sample_mean, noise, n_samples, seed):
        """Row mode's draws: the consensus GP's joint draws from one sweep
        (``sample_mean``), else one sweep per draw, each with a chain row
        (and its own warp), rows picked by a NumPy RandomState of the seed
        as in the JAX package. The normals are the dense path's (from the
        seed's torch generator, in its layout), so a draw equals the dense
        model's draw for the same seed."""
        from ..ops.dist_chol import row_sharded_sample_y

        widx, d = self.white_index_, self._data

        def draws(theta, warp, zc):
            td = theta if noise else gpc.noise_free_theta(self._spec, theta, widx)
            X, Xw = d.X, Xq
            if warp is not None:
                X, Xw = wp.warp(X, *warp), wp.warp(Xq, *warp)
            return row_sharded_sample_y(
                self._spec, theta, X, d.y, d.alpha_diag, d.mask, Xw, zc, self.row_mesh,
                n_samples=zc.shape[1], nb=self.row_nb, y_mean=d.y_mean, y_std=d.y_std,
                theta_diag=td,
            )

        if sample_mean:
            z = self._normals(seed, (Xq.shape[0], n_samples))
            return draws(self._tensor(self._theta), self._warp_params(), z).cpu().numpy()
        z = self._normals(seed, (n_samples, Xq.shape[0], 1))
        n_warp = self._n_warp()
        rs = np.random.RandomState(seed)
        idx = rs.choice(len(self.chain_), size=n_samples, replace=True)
        cols = []
        for j, i in enumerate(idx):
            row = self._tensor(self.chain_[i])
            if n_warp:
                th, la, lb = wp.split_warp_params(row, n_warp)
                warp = (la, lb)
            else:
                th, warp = row, None
            cols.append(draws(th, warp, z[j])[:, 0])
        return torch.stack(cols, dim=1).cpu().numpy()

    def _fused_spec(self):
        from ..ops.gram import match_fusable

        spec = match_fusable(self._spec)
        if spec is None:
            raise NotImplementedError(
                "Pathwise sampling requires a Constant*(Matern|RBF)[+White] "
                "kernel; use sample_y instead."
            )
        return spec

    def _pathwise_randoms(self, spec, seed, n_features, n_samples, batch=()):
        from .pathwise import draw_pathwise_randoms

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n_pad, d = self._data.X.shape
        return draw_pathwise_randoms(
            gen, spec.nu, n_features, d, n_pad, n_samples, batch=batch,
            dtype=self.dtype, device=self.device,
        )

    @torch.no_grad()
    def sample_y_pathwise(self, X, n_samples: int = 1, random_state=0, n_features: int = 1024):
        """Consensus-GP draws (n_points, n_samples) by pathwise sampling:
        linear in the number of points, so tens of thousands are fine.
        Needs a ``Constant * (Matern|RBF) [+ White]`` kernel."""
        from .pathwise import pathwise_samples

        spec = self._fused_spec()
        seed = self._seed(random_state)
        Xq = self._warp_tensor(self._tensor(np.atleast_2d(X)))
        rand = self._pathwise_randoms(spec, seed, n_features, n_samples)
        out = pathwise_samples(
            spec, self._tensor(self._theta), self._post_data, self._post.L, Xq, rand
        )
        return out.cpu().double().numpy() * self.y_train_std_ + self.y_train_mean_

    @torch.no_grad()
    def thompson_argmin_pathwise(
        self, X, n_samples: int = 1, top_k: int = 8, random_state=0,
        n_features: int = 1024, sample_mean: bool = True,
    ):
        """Per-draw top-k minimizer indices (n_samples, top_k), computed
        on the device: only the index table reaches the host.

        ``sample_mean=True`` draws from the consensus GP (one set of
        features for all draws); ``sample_mean=False`` gives each draw a
        chain row (rows picked by a NumPy RandomState of the seed, as in
        the JAX package) and its own features
        (:func:`~bask_tpu_torch.models.pathwise.pathwise_topk_hyper`).
        The randoms come from a torch generator seeded with the seed."""
        from .pathwise import pathwise_topk, pathwise_topk_hyper

        spec = self._fused_spec()
        seed = self._seed(random_state)
        Xq = self._tensor(np.atleast_2d(X))
        if sample_mean:
            rand = self._pathwise_randoms(spec, seed, n_features, n_samples)
            idx = pathwise_topk(
                spec, self._tensor(self._theta), self._post_data, self._post.L,
                self._warp_tensor(Xq), rand, top_k,
            )
            return idx.cpu().numpy()
        rs = np.random.RandomState(seed)
        rows = self._tensor(self.chain_[rs.choice(len(self.chain_), n_samples, replace=True)])
        rand = self._pathwise_randoms(spec, seed, n_features, 1, batch=(n_samples,))
        idx = pathwise_topk_hyper(
            spec, rows, self._data, Xq, rand, self._n_warp(), top_k,
            n_real=len(self._y_orig),
        )
        return idx.cpu().numpy()

    def log_marginal_likelihood(self, theta=None, clone_kernel=True):
        """The consensus LML, or the LML at ``theta`` on the posterior's
        (warped) data. ``clone_kernel`` is accepted for scikit-learn's
        signature and changes nothing, as in the JAX package."""
        if theta is None:
            return self.log_marginal_likelihood_value_
        data = self._post_data if self._post_data is not None else self._data
        with torch.no_grad():
            if self.row_mesh is not None:
                return float(self._row_lml(self._tensor(theta), self._warp_params()))
            return float(gpc.log_marginal_likelihood(self._spec, self._tensor(theta), data))

    # -- public warper API (reference bask/bayesgpr.py:249-316) ------------

    def create_warpers(self, alphas, betas):
        """Set the warp log-parameters (call :meth:`rewarp` afterwards)."""
        if not self.warp_inputs:
            return
        self.warp_alphas_ = np.array(alphas, dtype=float)
        self.warp_betas_ = np.array(betas, dtype=float)

    def rewarp(self):
        """Re-warp the training data after the warp parameters changed and
        refresh the factorized posterior."""
        if self.warp_inputs and self.warp_alphas_ is not None:
            self._refresh_posterior(with_lml=False)

    @property
    def warpers_(self):
        """Per-column warp callables (scipy Beta CDFs), reference-compatible."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        import scipy.stats as st

        return [
            st.beta(a=np.exp(a), b=np.exp(b)).cdf
            for a, b in zip(self.warp_alphas_, self.warp_betas_)
        ]

    @property
    def unwarpers_(self):
        """Per-column unwarp callables (scipy Beta PPFs), reference-compatible."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        import scipy.stats as st

        return [
            st.beta(a=np.exp(a), b=np.exp(b)).ppf
            for a, b in zip(self.warp_alphas_, self.warp_betas_)
        ]

    def warp(self, X):
        """X (n, d) in the consensus-warped space (NumPy in, NumPy out);
        X itself without warping."""
        params = self._warp_params()
        if params is None:
            return X
        return wp.warp(self._tensor(X), *params).cpu().double().numpy()

    def unwarp(self, X):
        """The inverse of :meth:`warp` (``span.gp.unwarp``, its readback a
        ``span.wait``; without warping X itself, and no span)."""
        params = self._warp_params()
        if params is None:
            return X
        with trace.span("span.gp.unwarp"):
            x = wp.unwarp(self._tensor(X), *params)
            with trace.wait():
                x = x.cpu()
            return x.double().numpy()
