"""Covariance-kernel specs with sklearn-compatible log-space ``theta``.

PyTorch counterpart of :mod:`bask_tpu.ops.kernels`: ``ConstantKernel``,
``WhiteKernel``, ``RBF``, ``Matern`` (any nu > 0), ``Sum``, ``Product``,
``Exponentiation`` and ``CompoundKernel``. The fused gram kernel
(``gram.match_fusable``) takes ``Constant * (Matern|RBF) [+ White]`` with
nu in {0.5, 1.5, 2.5, inf}; every other spec builds its grams here, in
plain torch, and its factorizations still run the blocked form.

Specs are immutable; all hyperparameters live in a flat log-space vector
``theta`` in sklearn order (depth-first: Sum/Product visit ``k1`` then
``k2``, Exponentiation visits its child, CompoundKernel its members in
order; fixed leaves contribute nothing). Evaluation is batched:
``theta`` may carry leading batch dimensions ``(..., n_theta)`` and ``X``
``(..., n, d)``; the result is ``(..., n, m)``. That is what the JAX
package gets from ``vmap`` over walkers or hyperposterior draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Tuple, Union

import numpy as np
import torch

__all__ = [
    "Kernel",
    "ConstantKernel",
    "WhiteKernel",
    "RBF",
    "Matern",
    "Sum",
    "Product",
    "Exponentiation",
    "CompoundKernel",
    "sqdist",
    "iter_leaves",
    "white_theta_index",
]

Bounds = Union[str, Tuple[float, float]]

# z = sqrt(2 nu) r below this is the r -> 0 limit of the general-nu
# Matern (k = 1, dk/dr = 0): z^nu underflows while K_nu(z) overflows
_MATERN_Z_TINY = 1e-8


def sqdist(X, Y, inv_ls):
    """Pairwise squared distance of scaled inputs, ``(..., n, m)``.

    ``|x|^2 + |y|^2 - 2 x.y`` as one matmul, clamped at 0; ``inv_ls`` is
    ``(..., d)`` or ``()``. ``Y=None`` is the training gram: its squared
    norms are then read off the matmul's own diagonal, so d2 of a point
    with itself is exactly 0 (a separately summed norm differs from the
    BLAS dot by a few ulps, and sqrt turns that into ~1e-3 for nu=1/2 in
    float32).
    """
    Xs = X * (inv_ls[..., None, :] if inv_ls.ndim else inv_ls)
    if Y is None:
        G = torch.matmul(Xs, Xs.transpose(-1, -2))
        sq_x = sq_y = G.diagonal(dim1=-2, dim2=-1)
    else:
        Ys = Y * (inv_ls[..., None, :] if inv_ls.ndim else inv_ls)
        G = torch.matmul(Xs, Ys.transpose(-1, -2))
        sq_x, sq_y = (Xs * Xs).sum(-1), (Ys * Ys).sum(-1)
    return torch.clamp(sq_x[..., :, None] + sq_y[..., None, :] - 2.0 * G, min=0.0)


def _out_shape(theta, X, Y):
    batch = torch.broadcast_shapes(theta.shape[:-1], X.shape[:-2])
    m = X.shape[-2] if Y is None else Y.shape[-2]
    return batch + (X.shape[-2], m)


class Kernel:
    """Base class. ``eval(theta, X, Y=None)`` is the full (cross-)gram;
    ``Y is None`` means the training gram, the only place White adds
    noise. ``diag(theta, X)`` is the diagonal of the training gram."""

    def __add__(self, other):
        return Sum(self, _as_kernel(other))

    def __radd__(self, other):
        return Sum(_as_kernel(other), self)

    def __mul__(self, other):
        return Product(self, _as_kernel(other))

    def __rmul__(self, other):
        return Product(_as_kernel(other), self)

    def __pow__(self, exponent):
        return Exponentiation(self, float(exponent))

    @property
    def n_theta(self) -> int:
        raise NotImplementedError

    @property
    def theta0(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def bounds(self) -> np.ndarray:
        raise NotImplementedError

    def _eval(self, theta, X, Y):
        """Gram values broadcastable to ``(..., n, m)``."""
        raise NotImplementedError

    def _diag(self, theta, X):
        raise NotImplementedError

    def eval(self, theta, X, Y=None):
        return torch.broadcast_to(
            self._eval(theta, X, Y), _out_shape(theta, X, Y)
        )

    def diag(self, theta, X):
        shape = torch.broadcast_shapes(theta.shape[:-1], X.shape[:-2])
        return torch.broadcast_to(self._diag(theta, X), shape + X.shape[-2:-1])

    def with_theta(self, theta) -> "Kernel":
        new, rest = self._with_theta(np.asarray(theta, dtype=float))
        if rest.size:
            raise ValueError("theta has wrong length")
        return new

    def _with_theta(self, theta):
        raise NotImplementedError


def _as_kernel(x):
    if isinstance(x, Kernel):
        return x
    return ConstantKernel(float(x), "fixed")


def _nb(value_bounds):
    """Normalize a bounds argument -> (fixed, log_bounds array)."""
    if isinstance(value_bounds, str):
        if value_bounds != "fixed":
            raise ValueError(f"Unknown bounds: {value_bounds!r}")
        return True, np.zeros((0, 2))
    lo, hi = value_bounds
    return False, np.log(np.asarray([[lo, hi]], dtype=float))


def _scalar(theta, value, fixed):
    """(..., 1, 1) parameter value: exp(theta[..., 0]) or the fixed one."""
    if fixed:
        return torch.full(
            theta.shape[:-1] + (1, 1), value, dtype=theta.dtype,
            device=theta.device,
        )
    return torch.exp(theta[..., 0])[..., None, None]


@dataclass(frozen=True)
class ConstantKernel(Kernel):
    constant_value: float = 1.0
    constant_value_bounds: Bounds = (1e-5, 1e5)

    @property
    def _fixed(self):
        return isinstance(self.constant_value_bounds, str)

    @property
    def n_theta(self):
        return 0 if self._fixed else 1

    @property
    def theta0(self):
        if self._fixed:
            return np.zeros(0)
        return np.log(np.asarray([self.constant_value], dtype=float))

    @property
    def bounds(self):
        return _nb(self.constant_value_bounds)[1]

    def _eval(self, theta, X, Y):
        return _scalar(theta, self.constant_value, self._fixed)

    def _diag(self, theta, X):
        return _scalar(theta, self.constant_value, self._fixed)[..., 0]

    def _with_theta(self, theta):
        if self._fixed:
            return self, theta
        return replace(self, constant_value=float(np.exp(theta[0]))), theta[1:]


@dataclass(frozen=True)
class WhiteKernel(Kernel):
    """noise_level * delta_ij on the training gram only (sklearn
    semantics: a cross-gram gets zeros)."""

    noise_level: float = 1.0
    noise_level_bounds: Bounds = (1e-5, 1e5)

    @property
    def _fixed(self):
        return isinstance(self.noise_level_bounds, str)

    @property
    def n_theta(self):
        return 0 if self._fixed else 1

    @property
    def theta0(self):
        if self._fixed:
            return np.zeros(0)
        with np.errstate(divide="ignore"):
            return np.log(np.asarray([self.noise_level], dtype=float))

    @property
    def bounds(self):
        return _nb(self.noise_level_bounds)[1]

    def _eval(self, theta, X, Y):
        if Y is not None:
            return torch.zeros((), dtype=X.dtype, device=X.device)
        n = X.shape[-2]
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        return _scalar(theta, self.noise_level, self._fixed) * eye

    def _diag(self, theta, X):
        return _scalar(theta, self.noise_level, self._fixed)[..., 0]

    def _with_theta(self, theta):
        if self._fixed:
            return self, theta
        return replace(self, noise_level=float(np.exp(theta[0]))), theta[1:]


def _ls_array(length_scale):
    return np.atleast_1d(np.asarray(length_scale, dtype=float))


@dataclass(frozen=True)
class RBF(Kernel):
    """Squared-exponential kernel, isotropic or anisotropic."""

    length_scale: Union[float, Tuple[float, ...]] = 1.0
    length_scale_bounds: Bounds = (1e-5, 1e5)

    @property
    def _fixed(self):
        return isinstance(self.length_scale_bounds, str)

    @property
    def _n_ls(self):
        return _ls_array(self.length_scale).size

    @property
    def n_theta(self):
        return 0 if self._fixed else self._n_ls

    @property
    def theta0(self):
        if self._fixed:
            return np.zeros(0)
        return np.log(_ls_array(self.length_scale))

    @property
    def bounds(self):
        if self._fixed:
            return np.zeros((0, 2))
        return np.repeat(_nb(self.length_scale_bounds)[1], self._n_ls, axis=0)

    def _inv_ls(self, theta):
        if self._fixed:
            inv = 1.0 / torch.as_tensor(
                _ls_array(self.length_scale), dtype=theta.dtype,
                device=theta.device,
            )
            return inv.expand(theta.shape[:-1] + inv.shape)
        return torch.exp(-theta[..., : self._n_ls])

    def _d2(self, theta, X, Y):
        return sqdist(X, Y, self._inv_ls(theta))

    def _eval(self, theta, X, Y):
        return torch.exp(-0.5 * self._d2(theta, X, Y))

    def _diag(self, theta, X):
        return torch.ones((), dtype=X.dtype, device=X.device)

    def _with_theta(self, theta):
        if self._fixed:
            return self, theta
        n = self._n_ls
        ls = np.exp(theta[:n])
        new_ls = float(ls[0]) if not np.iterable(self.length_scale) else tuple(ls)
        return replace(self, length_scale=new_ls), theta[n:]


@dataclass(frozen=True)
class Matern(RBF):
    """Matern kernel, any nu > 0 (inf = RBF). nu in {0.5, 1.5, 2.5} have
    closed forms, which the fused gram kernel also computes; every other
    nu is the modified-Bessel form (:func:`matern_general`)."""

    nu: float = 1.5

    def _eval(self, theta, X, Y):
        return matern_from_d2(self._d2(theta, X, Y), self.nu)


def matern_from_d2(d2, nu):
    """k_nu as a function of the squared scaled distance (the 1e-36 keeps
    the r -> 0 gradient finite, as in the JAX package)."""
    if nu == math.inf:
        return torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-36)
    if nu == 0.5:
        return torch.exp(-r)
    if nu == 1.5:
        s = math.sqrt(3.0) * r
        return (1.0 + s) * torch.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * r
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    return matern_general(r, float(nu))


def _matern_log_terms(r, nu: float, order: float):
    """(z, log of coef z^nu kve(order, z) e^-z) in float64, z = sqrt(2 nu) r,
    coef = 2^(1-nu) / Gamma(nu): the whole value in log space, so z^nu
    underflow cannot meet K_nu overflow as 0 * inf."""
    from .bessel import log_kve

    z = math.sqrt(2.0 * nu) * r.to(torch.float64)
    logval = (
        (1.0 - nu) * math.log(2.0) - math.lgamma(nu) + nu * torch.log(z)
        + log_kve(order, z) - z
    )
    return z, logval


def _matern_general_value(r, nu: float):
    z, logval = _matern_log_terms(r, nu, nu)
    ok = (z > _MATERN_Z_TINY) & torch.isfinite(logval)
    return torch.where(ok, torch.exp(logval), 1.0).to(r.dtype)


def _matern_general_dr(r, nu: float):
    """dk/dr = -coef sqrt(2 nu) z^nu K_{nu-1}(z); K is even in its order,
    so |nu - 1| covers nu < 1. 0 in the r -> 0 limit."""
    z, logmag = _matern_log_terms(r, nu, abs(nu - 1.0))
    ok = (z > _MATERN_Z_TINY) & torch.isfinite(logmag)
    return torch.where(ok, -torch.exp(logmag) * math.sqrt(2.0 * nu), 0.0).to(r.dtype)


class _MaternGeneral(torch.autograd.Function):
    """k_nu(r) whose backward is the closed-form dk/dr (the JAX package's
    ``_matern_general_jvp``). The backward is plain torch on the saved r,
    so a second derivative (the Laplace init's Hessian) differentiates
    through it, as JAX differentiates its JVP rule."""

    @staticmethod
    def forward(ctx, r, nu):
        ctx.nu = nu
        ctx.save_for_backward(r)
        return _matern_general_value(r, nu)

    @staticmethod
    def backward(ctx, grad):
        (r,) = ctx.saved_tensors
        return grad * _matern_general_dr(r, ctx.nu), None


def matern_general(r, nu: float):
    """General-nu Matern of the scaled distance ``r`` (any nu > 0), in
    float64 inside and cast back to ``r``'s dtype."""
    return _MaternGeneral.apply(r, float(nu))


@dataclass(frozen=True)
class Sum(Kernel):
    k1: Kernel = field(default=None)
    k2: Kernel = field(default=None)

    @property
    def n_theta(self):
        return self.k1.n_theta + self.k2.n_theta

    @property
    def theta0(self):
        return np.concatenate([self.k1.theta0, self.k2.theta0])

    @property
    def bounds(self):
        return np.concatenate([self.k1.bounds, self.k2.bounds], axis=0)

    def _split(self, theta):
        n1 = self.k1.n_theta
        return theta[..., :n1], theta[..., n1 : self.n_theta]

    def _eval(self, theta, X, Y):
        t1, t2 = self._split(theta)
        return self.k1._eval(t1, X, Y) + self.k2._eval(t2, X, Y)

    def _diag(self, theta, X):
        t1, t2 = self._split(theta)
        return self.k1._diag(t1, X) + self.k2._diag(t2, X)

    def _with_theta(self, theta):
        k1, rest = self.k1._with_theta(theta)
        k2, rest = self.k2._with_theta(rest)
        return Sum(k1, k2), rest


@dataclass(frozen=True)
class Product(Sum):
    def _eval(self, theta, X, Y):
        t1, t2 = self._split(theta)
        return self.k1._eval(t1, X, Y) * self.k2._eval(t2, X, Y)

    def _diag(self, theta, X):
        t1, t2 = self._split(theta)
        return self.k1._diag(t1, X) * self.k2._diag(t2, X)

    def _with_theta(self, theta):
        k1, rest = self.k1._with_theta(theta)
        k2, rest = self.k2._with_theta(rest)
        return Product(k1, k2), rest


@dataclass(frozen=True)
class CompoundKernel(Kernel):
    """Container of independent kernels with concatenated theta (sklearn's
    ``CompoundKernel``): a parameter-space container, not a covariance for
    GP fitting; ``eval`` and ``diag`` stack the members' results on a last
    axis, (..., n, m, K) and (..., n, K)."""

    kernels: Tuple[Kernel, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "kernels", tuple(self.kernels))

    @property
    def n_theta(self):
        return sum(k.n_theta for k in self.kernels)

    @property
    def theta0(self):
        if not self.kernels:
            return np.zeros(0)
        return np.concatenate([k.theta0 for k in self.kernels])

    @property
    def bounds(self):
        if not self.kernels:
            return np.zeros((0, 2))
        return np.concatenate([k.bounds for k in self.kernels], axis=0)

    def _split(self, theta):
        out, lo = [], 0
        for k in self.kernels:
            out.append(theta[..., lo : lo + k.n_theta])
            lo += k.n_theta
        return out

    def eval(self, theta, X, Y=None):
        parts = self._split(theta)
        return torch.stack([k.eval(t, X, Y) for k, t in zip(self.kernels, parts)], dim=-1)

    def diag(self, theta, X):
        parts = self._split(theta)
        return torch.stack([k.diag(t, X) for k, t in zip(self.kernels, parts)], dim=-1)

    def _with_theta(self, theta):
        new, rest = [], theta
        for k in self.kernels:
            nk, rest = k._with_theta(rest)
            new.append(nk)
        return CompoundKernel(tuple(new)), rest


@dataclass(frozen=True)
class Exponentiation(Kernel):
    """``kernel ** exponent``, elementwise; the child's theta."""

    kernel: Kernel = field(default=None)
    exponent: float = 1.0

    @property
    def n_theta(self):
        return self.kernel.n_theta

    @property
    def theta0(self):
        return self.kernel.theta0

    @property
    def bounds(self):
        return self.kernel.bounds

    def _eval(self, theta, X, Y):
        return self.kernel._eval(theta, X, Y) ** self.exponent

    def _diag(self, theta, X):
        return self.kernel._diag(theta, X) ** self.exponent

    def _with_theta(self, theta):
        k, rest = self.kernel._with_theta(theta)
        return Exponentiation(k, self.exponent), rest


def iter_leaves(kernel):
    """Depth-first leaf iterator in sklearn theta order."""
    if isinstance(kernel, Exponentiation):
        yield from iter_leaves(kernel.kernel)
    elif isinstance(kernel, CompoundKernel):
        for k in kernel.kernels:
            yield from iter_leaves(k)
    elif isinstance(kernel, Sum):  # Product subclasses Sum
        yield from iter_leaves(kernel.k1)
        yield from iter_leaves(kernel.k2)
    else:
        yield kernel


def white_theta_index(kernel):
    """theta index of the WhiteKernel *summand* of a top-level Sum (never
    a White factor inside a Product), or None if absent or fixed."""

    def scan(k, offset):
        if isinstance(k, WhiteKernel) and k.n_theta == 1:
            return offset
        if type(k) is Sum:
            hit = scan(k.k1, offset)
            if hit is not None:
                return hit
            return scan(k.k2, offset + k.k1.n_theta)
        return None

    return scan(kernel, 0)
