"""Pathwise (decoupled) GP posterior draws with random Fourier features.

PyTorch counterpart of :mod:`bask_tpu.models.pathwise` (Wilson et al.,
"Efficiently Sampling Functions from Gaussian Process Posteriors", ICML
2020). A draw at the queries is

    f~(x) = f0(x) + k(x, X) K^-1 (y - f0(X) - eps),   f0 ~ GP prior (RFF)

with f0 a weight-space prior draw over M random Fourier features and
eps ~ N(0, noise + alpha). Every term is a matmul, so a draw over 65,536
candidates needs no factorization of their covariance: the batch-ask
path. A Matern-nu kernel's spectral measure is a Student-t with 2 nu
degrees of freedom: omega = (z / ls) sqrt(2 nu / u), z ~ N(0, 1),
u ~ chi^2(2 nu); the RBF takes omega = z / ls.

Each sampling function comes in two parts: ``draw_pathwise_randoms``
makes the randoms (z, u, the phases, the feature weights w and the noise
normals e) from a ``torch.Generator`` on the model's device, and the
evaluation functions take them as tensors, so the tests can hand the
JAX package's randoms to the port. For nu in {1/2, 3/2, 5/2}, 2 nu is an
integer and u is a sum of 2 nu squared normals.

:func:`pathwise_topk_hyper` gives each draw its own chain row. Its
per-row grams come from K1 or K4 (``ops.gram.fused_masked_gram_batch``)
on a float32 CUDA tensor and from the plain gram elsewhere; they are
factored by the blocked Cholesky with K3 bases. A draw's values, the
random features and the cross-kernel reduced against their weights, come
from K5 (``ops.pathwise_values.pathwise_values``) on a float32 CUDA
tensor, so no (draws, m, M) or (draws, m, n_pad) tensor is made; the
plain version of the same function runs on the CPU and in float64. The
JAX ``lax.scan`` over draws becomes chunks of draws, each holding at
most :data:`CHUNK_BYTES` in its largest tensors (the draws, and with
warping the warped queries on K6 or the plain warp's temporaries;
:func:`draws_per_chunk`), which at the batch ask, warped or not, is one
chunk of all draws on the card; each draw's values and top-k are those
the per-draw loop gives.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import kernels as bk
from ..ops.fast_cholesky import block_cholesky, block_solve_lower_mat, block_solve_upper_mat
from ..ops.gram import FusedSpec, fused_masked_gram_batch
from ..ops.linalg import masked_gram
from ..ops.pathwise_values import pathwise_values, pathwise_values_plain
from ..ops.warp_values import CF_TERMS

__all__ = [
    "PathwiseRandoms",
    "draw_pathwise_randoms",
    "sample_frequencies",
    "pathwise_samples",
    "pathwise_topk",
    "pathwise_topk_hyper",
    "CHUNK_BYTES",
    "draws_per_chunk",
]

# the largest per-draw tensors of one chunk of draws, summed over its
# draws: the draws (m) and, with warping, the warped queries (m, d) where
# the warp runs on K6 (a CUDA tensor), or the plain warp's continued-
# fraction coefficients of the queries (warp_values.CF_TERMS = 48 of (m, d))
# where it runs op by op (a CPU tensor). At m = 65,536 and d = 15 in
# float32, 1 GiB holds 4,096 unwarped draws (the 256-draw batch ask is one
# chunk), 256 warped ones on K6 (one chunk again) or 5 on the plain warp
CHUNK_BYTES = 1 << 30


class PathwiseRandoms(NamedTuple):
    """The randoms of pathwise draws, batched over leading dims ``...``."""

    z: torch.Tensor  # (..., M, d) standard normals of the frequencies
    u: Optional[torch.Tensor]  # (..., M, 1) chi-square(2 nu); None for the RBF
    phase: torch.Tensor  # (..., M) uniform in [0, 2 pi)
    w: torch.Tensor  # (..., M, S) standard normal feature weights
    e: torch.Tensor  # (..., n_pad, S) standard normals of the noise


def draw_pathwise_randoms(
    generator, nu: float, n_features: int, d: int, n_pad: int, n_samples: int,
    batch=(), dtype=torch.float32, device=None,
) -> PathwiseRandoms:
    """The randoms of ``n_samples`` draws sharing one set of features per
    batch entry, from ``generator`` on ``device``."""
    batch = tuple(batch)
    kw = dict(generator=generator, dtype=dtype, device=device)
    z = torch.randn(batch + (n_features, d), **kw)
    u = None
    if not math.isinf(nu):
        dof = int(round(2 * nu))
        u = (torch.randn(batch + (n_features, 1, dof), **kw) ** 2).sum(-1)
    phase = 2.0 * math.pi * torch.rand(batch + (n_features,), **kw)
    w = torch.randn(batch + (n_features, n_samples), **kw)
    e = torch.randn(batch + (n_pad, n_samples), **kw)
    return PathwiseRandoms(z, u, phase, w, e)


def sample_frequencies(spec: FusedSpec, inv_ls, z, u):
    """(..., M, d) spectral frequencies for ``inv_ls`` (..., d) from the
    normals ``z`` and, for a Matern kernel, the chi-square draws ``u``."""
    if math.isinf(spec.nu):
        return z * inv_ls[..., None, :]
    return z * torch.sqrt(2.0 * spec.nu / u) * inv_ls[..., None, :]


def _unpack(spec: FusedSpec, theta, d: int):
    """(amp, noise, inv_ls) of fused-layout thetas (..., n_theta):
    (...), (...) and (..., d)."""
    off = 1 if spec.has_const else 0
    ones = torch.ones(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
    amp = torch.exp(theta[..., 0]) if spec.has_const else ones
    noise = torch.exp(theta[..., off + spec.n_ls]) if spec.has_white else 0.0 * ones
    inv_ls = torch.exp(-theta[..., off : off + spec.n_ls])
    return amp, noise, inv_ls.expand(theta.shape[:-1] + (d,))


def _base_kernel(spec: FusedSpec):
    ls_init = 1.0 if spec.n_ls == 1 else tuple([1.0] * spec.n_ls)
    if math.isinf(spec.nu):
        return bk.RBF(ls_init, (1e-5, 1e5))
    return bk.Matern(ls_init, (1e-5, 1e5), nu=spec.nu)


def _fused_spec_gram(spec: FusedSpec, theta, X, data):
    """Masked gram (..., n_pad, n_pad) through the generic kernel tree of
    the fused family: the route for tensors K1 does not take."""
    kernel = _base_kernel(spec)
    if spec.has_const:
        kernel = bk.ConstantKernel(1.0, (1e-5, 1e5)) * kernel
    if spec.has_white:
        kernel = kernel + bk.WhiteKernel(1.0, (1e-5, 1e5))
    return masked_gram(kernel, theta, X, data.alpha_diag, data.mask)


def _values_for(Xq):
    """K5 for a float32 CUDA tensor, the plain version elsewhere (the CPU,
    float64): the route ``_row_grams`` takes for K1."""
    if Xq.is_cuda and Xq.dtype == torch.float32:
        return pathwise_values
    return pathwise_values_plain


def _draw_values(spec: FusedSpec, theta, X, data, solve, Xq, rand: PathwiseRandoms,
                 values=None):
    """Pathwise draws (..., m, S) at ``Xq`` (..., m, d) for thetas
    (..., n_theta), training inputs ``X`` (..., n_pad, d) and the
    batched randoms, ``...`` one batch dim or none; ``solve(R)`` applies
    K^-1 of the noisy masked gram to (..., n_pad, S). ``values`` computes
    f0 and the draws (K5's function): by default :func:`_values_for`'s
    choice."""
    if theta.ndim == 1:  # one row: a batch of one
        part = PathwiseRandoms(*(None if r is None else r[None] for r in rand))
        return _draw_values(spec, theta[None], X, data, solve, Xq, part, values)[0]
    values = values or _values_for(Xq)
    n_features = rand.z.shape[-2]
    amp, noise, inv_ls = _unpack(spec, theta, X.shape[-1])
    omega = sample_frequencies(spec, inv_ls, rand.z, rand.u)
    coef = torch.sqrt(2.0 * amp / n_features)
    f0_train = values(spec.nu, X, omega, rand.phase, rand.w, coef)  # (B, n_pad, S)
    eps = torch.sqrt(noise[..., None] + data.alpha_diag)[..., None] * rand.e
    mask = data.mask[:, None]
    resid = torch.where(mask, data.y[:, None] - f0_train - eps, 0.0)
    V = solve(resid) * mask
    return values(spec.nu, Xq, omega, rand.phase, rand.w, coef, X, inv_ls, V, amp)


def pathwise_samples(spec: FusedSpec, theta, data, L, Xq, rand: PathwiseRandoms):
    """S pathwise draws at ``Xq`` (m, d) of the consensus GP: (m, S) in
    normalized units. ``theta`` is the fused-layout consensus theta,
    ``data`` the padded GPData and ``L`` the masked factor of the noisy
    gram; the draws are of the noise-free latent f. ``rand`` is unbatched
    (one set of features shared by the S draws)."""

    def solve(R):
        w = torch.linalg.solve_triangular(L, R, upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)

    return _draw_values(spec, theta, data.X, data, solve, Xq, rand)


def _topk_min(draws, k: int):
    """Indices of the ``k`` smallest entries along the last dim, in
    ascending order, as ``jax.lax.top_k(-draws, k)`` gives them: ties in
    index order, NaN after every number (an all-NaN draw gives 0..k-1)."""
    key = torch.nan_to_num(-draws, nan=-math.inf)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]


def pathwise_topk(spec: FusedSpec, theta, data, L, Xq, rand: PathwiseRandoms, k: int):
    """Per-draw top-k minimizer indices (S, k) of :func:`pathwise_samples`."""
    return _topk_min(pathwise_samples(spec, theta, data, L, Xq, rand).T, k)


def _row_grams(spec: FusedSpec, thetas, Xb, data, n_real: int):
    """Per-row masked grams: K1 on a float32 CUDA tensor, else the plain
    gram of the kernel tree."""
    if Xb.is_cuda and Xb.dtype == torch.float32:
        return fused_masked_gram_batch(spec, thetas, Xb, data.alpha_diag, n_real)
    return _fused_spec_gram(spec, thetas, Xb, data)


@torch.no_grad()
def pathwise_topk_hyper(
    spec: FusedSpec, rows, data, Xq, rand: PathwiseRandoms, n_warp: int, k: int = 8,
    n_real: Optional[int] = None, keep=None,
):
    """Hyperposterior-marginal Thompson top-k over large candidate grids.

    Each of the S draws uses its own chain row (kernel theta, then the
    2 ``n_warp`` warp parameters when warping): one batched gram and one
    blocked factorization for all rows, then chunks of draws
    (:func:`draws_per_chunk`; one at the batch ask on the card) whose values come
    from two K5 launches each (f0 at the training points, then the
    draws) and reduce to top-k indices. ``rows`` is (S, n_theta + 2 n_warp),
    ``rand`` batched over S with one draw each (w (S, M, 1), e
    (S, n_pad, 1)). Returns the (S, k) indices, and with ``keep`` (draw
    indices) also those draws' values (len(keep), m), in normalized
    units. A row whose gram is not PD gives a NaN draw and indices
    0..k-1, as in the JAX package.
    """
    from .warping import split_warp_params, warp

    S, m = rows.shape[0], Xq.shape[-2]
    thetas = rows[:, : rows.shape[1] - 2 * n_warp]
    if n_real is None:
        n_real = int(data.mask.sum())
    if n_warp:
        _, la, lb = split_warp_params(rows, n_warp)
        Xb = warp(data.X, la, lb)  # (S, n_pad, d)
    else:
        Xb = data.X
    L, invs = block_cholesky(_row_grams(spec, thetas, Xb, data, n_real))

    chunk = draws_per_chunk(S, m, Xq.shape[-1], n_warp, Xq.element_size(),
                            warp_on_kernels=Xq.is_cuda)
    keep = [] if keep is None else [int(i) for i in keep]
    idx, kept = [], {}
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        Lc, invc = L[lo:hi], [iv[lo:hi] for iv in invs]

        def solve(R, Lc=Lc, invc=invc):
            return block_solve_upper_mat(Lc, invc, block_solve_lower_mat(Lc, invc, R))

        Xc = Xb[lo:hi] if n_warp else Xb
        Xqc = warp(Xq, la[lo:hi], lb[lo:hi]) if n_warp else Xq
        part = PathwiseRandoms(*(None if r is None else r[lo:hi] for r in rand))
        draws = _draw_values(spec, thetas[lo:hi], Xc, data, solve, Xqc, part)[..., 0]
        idx.append(_topk_min(draws, k))
        for i in keep:
            if lo <= i < hi:
                kept[i] = draws[i - lo]
    idx = torch.cat(idx)
    if keep:
        return idx, torch.stack([kept[i] for i in keep])
    return idx


def draws_per_chunk(S: int, m: int, d: int, n_warp: int, itemsize: int,
                    warp_on_kernels: bool = False) -> int:
    """Draws per chunk of :func:`pathwise_topk_hyper`: as many as keep its
    largest per-draw tensors within :data:`CHUNK_BYTES`, at least 1, at
    most S. Per draw: the draws (m) and, with warping, the warped queries
    (m, d) on K6's route (``warp_on_kernels``, a CUDA tensor), or the plain
    warp's (``CF_TERMS``, m, d) coefficients (a CPU tensor). Each chunk
    launches K5 twice on the card."""
    per_point = 1
    if n_warp:
        per_point += d if warp_on_kernels else CF_TERMS * d
    return max(1, min(S, CHUNK_BYTES // (m * per_point * itemsize)))
