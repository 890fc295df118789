"""Carry state of the JAX package (``bask_tpu``) into the PyTorch port.

Plain values in, port objects out; nothing here imports JAX. A kernel
spec tree of ``bask_tpu.ops.kernels`` is read by class name and field;
arrays come as NumPy. With these conversions both packages compute the
consensus, predictions and acquisition values from one fitted state.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import gp as gpc
from .models.bayesgpr import BayesGPR
from .ops import kernels as bk

__all__ = ["kernel_spec", "gp_data", "fitted_bayesgpr", "bayesgpr_from_jax"]

# constructor fields of BayesGPR that both packages share
_SETTINGS = (
    "alpha", "noise", "normalize_y", "warp_inputs", "moves", "optimizer",
    "n_restarts_optimizer", "copy_X_train", "chain_init", "ml2_subsample",
    "ml2_objective",
)


def kernel_spec(kernel) -> bk.Kernel:
    """A ``bask_tpu.ops.kernels`` spec tree -> the port's spec (same theta
    order, values and bounds). Raises for kernels the port lacks."""
    name = type(kernel).__name__
    if name == "CompoundKernel":
        return bk.CompoundKernel(tuple(kernel_spec(k) for k in kernel.kernels))
    if name == "Exponentiation":
        return bk.Exponentiation(kernel_spec(kernel.kernel), kernel.exponent)
    if name in ("Sum", "Product"):
        cls = bk.Sum if name == "Sum" else bk.Product
        return cls(kernel_spec(kernel.k1), kernel_spec(kernel.k2))
    if name == "ConstantKernel":
        return bk.ConstantKernel(kernel.constant_value, kernel.constant_value_bounds)
    if name == "WhiteKernel":
        return bk.WhiteKernel(kernel.noise_level, kernel.noise_level_bounds)
    if name == "RBF":
        return bk.RBF(kernel.length_scale, kernel.length_scale_bounds)
    if name == "Matern":
        return bk.Matern(kernel.length_scale, kernel.length_scale_bounds, nu=kernel.nu)
    raise NotImplementedError(f"kernel {name} is not ported")


def gp_data(X, y, alpha_diag, mask, y_mean=0.0, y_std=1.0, device=None, dtype=torch.float64):
    """Padded GPData arrays (NumPy) -> the port's :class:`GPData`
    (``device=None`` is the CUDA card)."""
    device = torch.device("cuda" if device is None else device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return gpc.make_data(
        t(X), t(y), t(alpha_diag), np.asarray(mask, dtype=bool), y_mean, y_std
    )


def fitted_bayesgpr(
    *,
    kernel,
    theta,
    chain,
    pos,
    X,
    y,
    noise=None,
    y_mean=0.0,
    y_std=1.0,
    alpha=1e-10,
    noise_vector=None,
    warp_alphas=None,
    warp_betas=None,
    chain_steps=None,
    n_accepted=0,
    n_proposals=0,
    normalize_y=None,
    device=None,
    dtype=torch.float64,
    random_state=None,
    **settings,
) -> BayesGPR:
    """A fitted JAX ``BayesGPR``'s state -> a fitted port ``BayesGPR``.

    ``kernel`` is the fitted spec (``gp._spec``, White included),
    ``theta`` the consensus, ``chain``/``pos`` the flat chain and the
    final ensemble, ``X``/``y`` the unpadded raw data with its
    normalization ``y_mean``/``y_std``, and ``noise_vector`` the
    per-point noise in normalized units (``gp._noise_vector``). A warped
    model (``warp_inputs=True``) also passes ``warp_alphas``/``warp_betas``
    (``gp.warp_alphas_``/``gp.warp_betas_``); its chain and ensemble
    carry the 2d warp columns. ``chain_steps`` (``gp.chain_steps_``),
    ``n_accepted`` and ``n_proposals`` feed ``mcmc_diagnostics``;
    ``normalize_y`` (``gp.normalize_y``; ``None`` infers it from a
    normalization other than 0/1) decides whether a later fit on new
    data standardizes its targets. The consensus posterior and LML are
    recomputed by the port, on ``device`` (``None``: the CUDA card).
    ``settings`` are further constructor fields (``optimizer``,
    ``chain_init``, ``ml2_objective``, ...).
    """
    spec = kernel_spec(kernel)
    if normalize_y is None:
        normalize_y = float(y_mean) != 0.0 or float(y_std) != 1.0
    gpr = BayesGPR(
        kernel=spec, alpha=alpha, noise=None, random_state=random_state,
        normalize_y=bool(normalize_y), warp_inputs=warp_alphas is not None,
        device=device, dtype=dtype, **settings,
    )
    gpr._spec = spec
    gpr.y_train_mean_ = float(y_mean)
    gpr.y_train_std_ = float(y_std)
    gpr._X_orig = np.atleast_2d(np.asarray(X, dtype=float))
    gpr._y_orig = np.asarray(y, dtype=float).ravel()
    gpr._noise_vector = None if noise_vector is None else np.asarray(noise_vector, dtype=float)
    gpr._upload()
    # copies: arrays read from JAX are read-only, and torch warns on those
    gpr.chain_ = np.array(chain, dtype=float)
    gpr.pos_ = np.array(pos, dtype=float)
    gpr.chain_steps_ = None if chain_steps is None else np.array(chain_steps, dtype=float)
    gpr.n_accepted_, gpr.n_proposals_ = int(n_accepted), int(n_proposals)
    gpr.noise_ = None if noise is None else float(noise)
    gpr.create_warpers(warp_alphas, warp_betas)
    gpr.theta = theta  # refreshes the consensus posterior and its LML
    gpr.log_marginal_likelihood_value_ = float(gpr._consensus_lml_)
    return gpr


def bayesgpr_from_jax(gp, device=None, dtype=torch.float64) -> BayesGPR:
    """A ``bask_tpu`` BayesGPR -> the port's, with the same constructor
    fields (kernel, alpha, noise, normalize_y, warp_inputs, moves, the fit
    options) and a copy of its random state; a fitted model also carries
    its fitted state (:func:`fitted_bayesgpr`), and the user kernel stays
    the one a later ``fit`` starts from."""
    settings = {k: getattr(gp, k) for k in _SETTINGS}
    rs = np.random.RandomState()
    rs.set_state(gp.random_state.get_state())
    if gp._post is None or gp._theta is None:
        return BayesGPR(
            kernel=kernel_spec(gp._user_kernel), random_state=rs,
            device=device, dtype=dtype, **settings,
        )
    ours = fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_, X=gp._X_orig,
        y=gp._y_orig, noise=gp.noise_, y_mean=gp.y_train_mean_, y_std=gp.y_train_std_,
        noise_vector=gp._noise_vector, warp_alphas=gp.warp_alphas_,
        warp_betas=gp.warp_betas_, chain_steps=gp.chain_steps_,
        n_accepted=gp.n_accepted_, n_proposals=gp.n_proposals_,
        device=device, dtype=dtype, random_state=rs,
        **{k: v for k, v in settings.items() if k not in ("noise", "warp_inputs")},
    )
    ours._user_kernel = kernel_spec(gp._user_kernel)
    ours.noise = gp.noise
    return ours
