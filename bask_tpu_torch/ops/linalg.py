"""Masked, batched GP linear algebra (GPML Algorithm 2.1).

PyTorch counterpart of :mod:`bask_tpu.ops.linalg`. Every primitive works
on a padded training set: padded rows/columns of the gram are identity
rows and padded targets are 0, so the factor is block-diagonal with an
identity block and the masked LML equals the unpadded LML exactly. Shapes
stay fixed while the BO loop grows the data inside a padding bucket.

A failed factorization gives NaN in the factor, mapped to ``-inf`` LML
without raising. ``torch.linalg.cholesky`` raises on a non-PD input and
``cholesky_ex`` returns a partly filled factor plus ``info``, so
:func:`masked_cholesky` turns ``info > 0`` into a NaN factor on the
device, with no host sync.
"""

from __future__ import annotations

import math

import torch

from . import gram
from .gram import fused_spec_for

__all__ = [
    "masked_gram",
    "masked_cholesky",
    "masked_lml",
    "batched_lml",
    "batched_lml_from_gram",
    "cho_solve_masked",
    "augmented_quadform",
    "route_key",
]

_LOG2PI = math.log(2.0 * math.pi)

# Working-set budget for one walker batch of (chunk, n_pad, n_pad) grams.
# Counted from the code, not measured: the eager blocked factorization
# keeps about six gram-sized buffers alive at once (gram, trailing copy,
# panel columns, concatenated factor, block inverses, temporaries), so
# 8 GB of grams keeps the working set near 50 GB of an 80 GB H100. The
# chain's shape, (50, 512, 512) f32 = 52 MB, never chunks.
LML_MAX_BATCH_BYTES = 8_000_000_000


# The factorization route of the masked LML and of
# ``models.gp.posterior_and_invs``, as in the JAX package: "auto" takes the
# blocked factorization (K3 bases and GEMMs) for float32 grams whose size
# qualifies, "on" for every dtype whose size qualifies (K3 takes float32
# only: other dtypes factor their bases by K3's plain version), "off" never
# (``cholesky_ex``, cuSOLVER on the card, and triangular solves).
FAST_CHOLESKY = "auto"


def route_key(n_pad: int, d: int) -> tuple:
    """The gram's and the factorization's routes at X of ``(n_pad, d)``,
    which a CUDA graph keeps as they were at its capture."""
    return gram.LOWER_GRAM, gram._K4_ROUTE.get((int(n_pad), int(d))), FAST_CHOLESKY


def _use_fast_path(Kp) -> bool:
    """The blocked factorization for a 64-multiple size >= 128: at float32
    under "auto", at any dtype under "on", never under "off"."""
    if FAST_CHOLESKY == "off":
        return False
    n = Kp.shape[-1]
    shape_ok = n >= 128 and n % 64 == 0
    if FAST_CHOLESKY == "on":
        return shape_ok
    return shape_ok and Kp.dtype == torch.float32


def masked_gram(kernel, theta, X, alpha_diag, mask):
    """K + diag(alpha) with identity rows for padded entries.

    ``theta`` may be batched (..., n_theta); the result is (..., n, n).
    """
    K = kernel.eval(theta, X)
    m2 = mask[:, None] & mask[None, :]
    Kp = torch.where(m2, K, 0.0)
    diag = torch.where(mask, K.diagonal(dim1=-2, dim2=-1) + alpha_diag, 1.0)
    n = mask.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=mask.device)
    return torch.where(eye, torch.diag_embed(diag), Kp)


def masked_cholesky(Kp):
    """Lower Cholesky of the masked gram; all-NaN where it is not PD."""
    L, info = torch.linalg.cholesky_ex(Kp)
    return torch.where((info > 0)[..., None, None], math.nan, L)


def cho_solve_masked(L, B):
    """Solve K x = B given the lower factor L (B is (..., n) or (..., n, k))."""
    vec = B.ndim == L.ndim - 1
    Bm = B[..., None] if vec else B
    w = torch.linalg.solve_triangular(L, Bm, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)
    return x[..., 0] if vec else x


def _finite_or_neg_inf(lml):
    return torch.where(torch.isfinite(lml), lml, -math.inf)


def masked_lml(kernel, theta, X, y, alpha_diag, mask):
    """LML of the masked problem, -inf on failure; batched over theta."""
    Kp = masked_gram(kernel, theta, X, alpha_diag, mask)
    return batched_lml_from_gram(Kp, y, mask)


def batched_lml_from_gram(Kp, y, mask):
    """(..., n, n) masked grams -> (...,) LMLs; one batched factorization."""
    n = mask.sum().to(Kp.dtype)
    yb = y.expand(Kp.shape[:-1])
    if _use_fast_path(Kp):
        from .fast_cholesky import fast_lml_terms

        _, logdiag, quad = fast_lml_terms(Kp, yb)
        return _finite_or_neg_inf(-0.5 * quad - logdiag - 0.5 * n * _LOG2PI)
    L = masked_cholesky(Kp)
    w = torch.linalg.solve_triangular(L, yb[..., None], upper=False)[..., 0]
    logdiag = torch.where(mask, torch.log(L.diagonal(dim1=-2, dim2=-1)), 0.0)
    lml = -0.5 * (w * w).sum(-1) - logdiag.sum(-1) - 0.5 * n * _LOG2PI
    return _finite_or_neg_inf(lml)


def _lml_chunk_walkers(n_pad: int, itemsize: int, W: int) -> int:
    per_walker = n_pad * n_pad * itemsize
    return max(1, min(W, int(LML_MAX_BATCH_BYTES // per_walker)))


def _lml_batch_direct(kernel, spec, thetas, X, y, alpha_diag, mask, n_real):
    if spec is not None:
        # the factorization reads only the lower triangle, so K2 may skip
        # the upper 128-tiles (gram.LOWER_GRAM; off by default, as in JAX)
        if gram.LOWER_GRAM == "on" and X.shape[-2] % gram._SQ_TILE == 0:
            Kp = gram.fused_masked_gram_lower_batch(spec, thetas, X, alpha_diag, n_real)
        else:
            Kp = gram.fused_masked_gram_batch(spec, thetas, X, alpha_diag, n_real)
        return batched_lml_from_gram(Kp, y, mask)
    return masked_lml(kernel, thetas, X, y, alpha_diag, mask)


def batched_lml(kernel, thetas, X, y, alpha_diag, mask, mesh=None, n_real=None):
    """LML for a batch of thetas: (W, n_theta) -> (W,).

    On a CUDA float32 problem whose kernel matches the fused family and
    whose bucket is a 64-multiple, the grams come from the K1 kernel (K2
    when ``gram.LOWER_GRAM == "on"`` and the bucket is a 128-multiple)
    and the factorization from the blocked Cholesky with K3 bases. Otherwise
    the grams are built by the kernel spec. ``X`` is (n_pad, d) or
    per-walker (W, n_pad, d). ``n_real`` (the number of unpadded points,
    an int) saves a device sync when the caller knows it.

    Batches beyond ``LML_MAX_BATCH_BYTES`` of grams run in equal walker
    chunks; each walker's result is independent of the chunking.

    ``mesh``: a 1-axis :class:`~bask_tpu_torch.parallel.mesh.Mesh`. Each
    entry's shard of the walkers (and of a per-walker X) runs this whole
    pipeline (gram, factorization, LML) on its device, and the (W,) result
    comes back in walker order on the device of ``thetas``; the budget
    above applies per shard. No walker's result depends on another's, so
    the sharded result equals the unsharded one (JAX's ``shard_map``).
    """
    if mesh is not None:
        return _batched_lml_sharded(kernel, thetas, X, y, alpha_diag, mask, n_real, mesh)
    n_pad = X.shape[-2]
    spec = fused_spec_for(kernel, X)
    if spec is not None and n_real is None:
        n_real = int(mask.sum())
    W = thetas.shape[0]
    chunk = _lml_chunk_walkers(n_pad, X.element_size(), W)
    outs = []
    for lo in range(0, W, chunk):
        Xc = X[lo : lo + chunk] if X.ndim == 3 else X
        outs.append(
            _lml_batch_direct(
                kernel, spec, thetas[lo : lo + chunk], Xc, y, alpha_diag,
                mask, n_real,
            )
        )
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _batched_lml_sharded(kernel, thetas, X, y, alpha_diag, mask, n_real, mesh):
    if len(mesh.axis_names) != 1:
        raise ValueError("batched_lml(mesh=) takes a 1-axis mesh")
    if n_real is None:
        n_real = int(mask.sum())
    t_parts = mesh.split(thetas)
    # a per-walker X is split with the walkers; a shared X is replicated
    x_parts = mesh.split(X) if X.ndim == 3 else [X] * len(t_parts)
    shared = {}  # the replicated inputs, once per distinct device
    outs = []
    for t, Xs in zip(t_parts, x_parts):
        dev = t.device
        if dev not in shared:
            shared[dev] = [a.to(dev) for a in (y, alpha_diag, mask)]
        outs.append(batched_lml(kernel, t, Xs.to(dev), *shared[dev], n_real=n_real))
    return mesh.all_gather(outs, device=thetas.device)


def augmented_quadform(L, l_cand, d_cand, A_sol, b):
    """Summed quadratic forms against rank-1-augmented Cholesky factors.

    For candidate c, K_aug(c) = [[K, k_c], [k_c^T, k_cc]] has the lower
    factor [[L, 0], [l_c^T, d_c]] with l_c = L^-1 k_c and
    d_c = sqrt(k_cc - |l_c|^2). For m probe points with cross rows
    [A_p, b_cp]:

        sum_p q_cp = |L^-1 A^T|^2 + sum_p ((b_cp - l_c.(L^-1 A^T)_p) / d_c)^2

    ``l_cand`` (n, C), ``d_cand`` (C,), ``A_sol`` (n, m), ``b`` (m, C).
    Returns (C,).
    """
    base = (A_sol * A_sol).sum()
    resid = b - A_sol.transpose(-1, -2) @ l_cand
    return base + ((resid / d_cand[None, :]) ** 2).sum(0)
