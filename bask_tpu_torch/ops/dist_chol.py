"""Row-sharded distributed Cholesky and log-marginal likelihood.

PyTorch counterpart of :mod:`bask_tpu.ops.dist_chol`. Walker sharding
(``batched_lml(mesh=)``) spreads the ensemble, but each device still
builds whole (n_pad, n_pad) grams. This module shards ONE factorization
over the entries of a :class:`~bask_tpu_torch.parallel.mesh.Mesh` by
block row: entry ``p`` holds the (n_loc, n) strip of rows
``[p n_loc, (p + 1) n_loc)`` of the masked gram, built from the
replicated (n, d) inputs (the whole matrix exists nowhere), and a
blocked right-looking Cholesky sweeps its n/nb panels. Each step

* hands the owner's (nb, nb) diagonal block and right-hand-side rows to
  every entry (:meth:`Mesh.broadcast`, the counterpart of JAX's ``psum``
  of a block only its owner fills); each distinct device factors it,
* gathers the (n, nb) panel (:meth:`Mesh.all_gather`) for the trailing
  Schur update, which each entry applies to its own strip.

The forward solve ``L^-1 [y, k(X, Xq), dk]`` runs inside the same sweep
(the right-hand sides update like extra trailing columns), so the LML,
predictions and their query gradients need no stored factor.

A float32 diagonal block is factored with
:func:`bask_tpu_torch.ops.fast_cholesky.block_cholesky`'s recursion on
K3 bases (``chol_base.chol_inv_base``): one launch per 128-wide half of
the default 256-wide panel, and the block's inverse comes out of the
same recursion, so the panel is ``K[:, panel] L^-T`` and the block's
solve ``L^-1 B``, two matmuls, with no triangular solve. K3 is float32
only, so another dtype factors its blocks as the dense path does
(:func:`bask_tpu_torch.ops.linalg.masked_cholesky` and a triangular
solve). A non-PD block gives NaN in both (as JAX's ``cholesky`` does),
which reaches the LML as -inf with no raise and no host sync. Every
matmul of the sweep is a ``torch.matmul`` in full float32 (the package
never enables TF32), JAX's ``Precision.HIGHEST``.

Masking follows :mod:`bask_tpu_torch.ops.linalg`: identity rows for
padded points, zero-padded ``y``, so the sharded LML equals the unpadded
one. Panels are static Python offsets (JAX's int32 index juggling has no
counterpart), so every step updates only the rows below the panel and
the columns right of it, the trapezoid, as JAX's unrolled sweep does.
JAX's ``fori_loop`` sweep (``unroll=False``) updates the whole
rectangle only because its shapes must be static; the rest of the
rectangle receives exact zeros, so ``unroll`` is accepted for JAX's
signatures and both values give the same numbers.
"""

from __future__ import annotations

import math

import torch

from .fast_cholesky import _chol_inv_recursive
from .linalg import masked_cholesky

__all__ = [
    "row_sharded_lml",
    "row_sharded_lml_batch",
    "row_sharded_lml_value_grad",
    "row_sharded_predict",
    "row_sharded_sample_y",
    "walker_row_sharded_lml",
    "pick_row_nb",
]

_LOG2PI = math.log(2.0 * math.pi)


def pick_row_nb(n_loc: int, nb: int = 256) -> int:
    """Largest panel width <= ``nb`` that divides the local row count."""
    nb = min(nb, n_loc)
    while n_loc % nb:
        nb -= 1
    return nb


def _prep_row_mesh(mesh, n: int, nb: int, fname: str):
    """(1-axis row mesh, its size, clamped nb). A 2-axis (walkers, rows)
    mesh shards the rows over its last axis; JAX runs a single-theta sweep
    redundantly in every walker group, and since every group gives the
    same numbers the port runs it in the first group alone."""
    if len(mesh.axis_names) not in (1, 2):
        raise ValueError(f"{fname} expects a 1- or 2-axis mesh")
    rows = mesh if len(mesh.axis_names) == 1 else mesh.row(0)
    P_sz = int(rows.devices.shape[0])
    if n % P_sz:
        raise ValueError(f"n_pad={n} must be divisible by the row-axis size {P_sz}")
    return rows, P_sz, pick_row_nb(n // P_sz, nb)


def _factor_block_plain(A):
    """(L, L^-1) by ``cholesky_ex`` (NaN where the block is not PD) and a
    triangular solve: the dense path's factor for dtypes K3 does not
    take, and the ``jvp`` gradient's at every dtype, since forward mode
    differentiates it and K3 has no derivative (K3's plain version,
    ``chol_inv_plain``, would differentiate too, but issues ~10 device
    operations per pivot)."""
    L = masked_cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _factor_block(A):
    """(L, L^-1) of the diagonal block: the recursion on K3 bases at
    float32, as the dense path's blocked factor; ``cholesky_ex`` and a
    triangular solve otherwise."""
    if A.dtype == torch.float32:
        return _chol_inv_recursive(A)
    return _factor_block_plain(A)


class _Strips:
    """This process's strips of the row mesh and the replicated inputs,
    once per distinct device."""

    def __init__(self, mesh, X, y, alpha_diag, mask):
        self.mesh = mesh
        self.n = X.shape[0]
        self.n_loc = self.n // mesh.devices.shape[0]
        self.local = mesh.local
        self.devs = [mesh.devices[p] for p in self.local]
        self.home = mesh.replicas()[0]
        self.rep = {dev: tuple(a.to(dev) for a in (X, y, alpha_diag, mask))
                    for dev in mesh.replicas()}

    def r0(self, i):
        return self.local[i] * self.n_loc

    def inputs(self, i):
        """(X, y, alpha, mask, X_loc, y_loc, alpha_loc, mask_loc) of local strip i."""
        X, y, alpha, mask = self.rep[self.devs[i]]
        s = slice(self.r0(i), self.r0(i) + self.n_loc)
        return X, y, alpha, mask, X[s], y[s], alpha[s], mask[s]

    def below(self, i, row):
        """Local rows of strip i above global row ``row`` (none of them below)."""
        return min(max(row - self.r0(i), 0), self.n_loc)


def _gram_strip(kernel, theta, X, X_loc, alpha_loc, mask, mask_loc, r0):
    """One entry's (n_loc, n) strip of the masked gram: identity rows for
    padded points, ``kernel.diag + alpha`` on the true diagonal (global
    column ``r0 + i`` of local row ``i``). Plain torch, as JAX keeps it in
    XLA; a function of theta alone, which both gradients differentiate."""
    Ks = kernel.eval(theta, X_loc, X)  # cross form: White contributes 0
    K_loc = torch.where(mask_loc[:, None] & mask[None, :], Ks, 0.0)
    dvals = torch.where(mask_loc, kernel.diag(theta, X_loc) + alpha_loc, 1.0)
    n_loc, n = K_loc.shape
    diag_sel = torch.zeros((n_loc, n), dtype=torch.bool, device=K_loc.device)
    diag_sel.diagonal(offset=r0).fill_(True)
    return torch.where(diag_sel, dvals[:, None], K_loc)


def _sweep(strips, K, B, nb, factor):
    """The blocked right-looking sweep over the strips ``K`` (per local
    entry, (n_loc, n)) with the right-hand sides ``B`` ((n_loc, wB)),
    both updated in place, the trapezoid right of and below each panel
    only (a strip whose rows are all factored is left alone). Yields, per panel, ``(row0, owner, loc0, fac,
    Pls)``: ``fac[device] = (Lkk, Lkk^-1, Zk = Lkk^-1 Bk)`` for every
    replica device (the same numbers on each), and each local entry's
    panel rows ``Pls`` (zero above the panel's end). The consumer reads
    them before the trailing update runs."""
    mesh, n, n_loc = strips.mesh, strips.n, strips.n_loc
    wB = B[0].shape[1]
    for row0 in range(0, n, nb):
        owner, loc0 = divmod(row0, n_loc)
        blk = None
        if owner in strips.local:
            i = strips.local.index(owner)
            blk = torch.cat([K[i][loc0:loc0 + nb, row0:row0 + nb],
                             B[i][loc0:loc0 + nb]], dim=1)
        blocks = mesh.broadcast(blk, owner, shape=(nb, nb + wB), dtype=K[0].dtype)
        fac = {}
        for dev, b in blocks.items():
            Lkk, Linv = factor(b[:, :nb])
            fac[dev] = (Lkk, Linv, Linv @ b[:, nb:])
        lo = row0 + nb
        cuts = [strips.below(i, lo) for i in range(len(K))]
        Pls = []
        for i, cut in enumerate(cuts):
            Pb = K[i][cut:, row0:lo] @ fac[strips.devs[i]][1].T
            Pls.append(torch.cat([Pb.new_zeros((cut, nb)), Pb]) if cut else Pb)
        yield row0, owner, loc0, fac, Pls
        P_full = mesh.all_gather(Pls)
        for i, cut in enumerate(cuts):
            if cut == n_loc:
                continue  # every row of this strip is factored
            dev = strips.devs[i]
            if lo < n:
                K[i][cut:, lo:] -= Pls[i][cut:] @ P_full[dev][lo:].T
            B[i][cut:] -= Pls[i][cut:] @ fac[dev][2]


def _sweep_strip(kernel, theta, X, Xq, y, alpha_diag, mask, mesh, nb, theta_diag=None,
                 with_outer=False, with_grad=False, factor=_factor_block):
    """The distributed sweep with the forward solves of ``[y, k(X, Xq),
    dk(X, Xq)/dXq]`` interleaved. Returns ``(quad, logdet, dot, qnorm,
    qouter, dotg, qcross)`` on the first replica device:

    * ``quad`` = |L^-1 y|^2, ``logdet`` = sum log diag L;
    * ``dot`` = (L^-1 Kq)^T (L^-1 y), ``qnorm`` = |L^-1 Kq|^2 per query;
    * ``qouter`` = (L^-1 Kq)^T (L^-1 Kq) with ``with_outer``;
    * ``dotg`` = (L^-1 dKq)^T (L^-1 y) and ``qcross`` = sum (L^-1 Kq)(L^-1 dKq),
      (m, d) each, with ``with_grad``: the query-gradient cross-blocks
      ride the same sweep as m d extra columns (the factor does not depend
      on Xq).

    ``theta_diag`` evaluates the query cross-blocks with another theta
    (noise-free prediction)."""
    strips = _Strips(mesh, X, y, alpha_diag, mask)
    m = 0 if Xq is None else Xq.shape[0]
    dq = Xq.shape[1] if (m and with_grad) else 0
    K, B = [], []
    for i, dev in enumerate(strips.devs):
        Xr, _, _, maskr, X_loc, y_loc, alpha_loc, mask_loc = strips.inputs(i)
        th = theta.to(dev)
        K.append(_gram_strip(kernel, th, Xr, X_loc, alpha_loc, maskr, mask_loc, strips.r0(i)))
        cols = [y_loc[:, None]]
        if m:
            tq = (th if theta_diag is None else theta_diag.to(dev))
            Xqd = Xq.to(dev)
            cols.append(kernel.eval(tq, X_loc, Xqd) * mask_loc[:, None])
            if dq:
                cols.append(_query_jacobian(kernel, tq, X_loc, Xqd, mask_loc))
        B.append(torch.cat(cols, dim=1))
    home, dt = strips.home, K[0].dtype
    zero = torch.zeros((), dtype=dt, device=home)
    quad, logdet = zero, zero
    dot = qnorm = torch.zeros((m,), dtype=dt, device=home)
    qouter = torch.zeros((m, m) if with_outer else (0, 0), dtype=dt, device=home)
    dotg = qcross = torch.zeros((m, dq) if dq else (0, 0), dtype=dt, device=home)
    for _, _, _, fac, _ in _sweep(strips, K, B, nb, factor):
        Lkk, _, Zk = fac[home]
        zy = Zk[:, 0]
        quad = quad + (zy * zy).sum()
        logdet = logdet + torch.log(Lkk.diagonal()).sum()
        if m:
            Zq = Zk[:, 1:1 + m]
            dot = dot + (Zq * zy[:, None]).sum(0)
            qnorm = qnorm + (Zq * Zq).sum(0)
            if with_outer:
                qouter = qouter + Zq.T @ Zq
            if dq:
                Zg = Zk[:, 1 + m:].reshape(-1, m, dq)
                dotg = dotg + (Zg * zy[:, None, None]).sum(0)
                qcross = qcross + (Zq[:, :, None] * Zg).sum(0)
    return quad, logdet, dot, qnorm, qouter, dotg, qcross


def _query_jacobian(kernel, tq, X_loc, Xq, mask_loc):
    """(n_loc, m d): d k(X_loc, x_j) / d x_j for every query j, one forward
    pass per input dimension (column j depends on x_j alone)."""
    m, d = Xq.shape
    cols = []
    for a in range(d):
        tangent = torch.zeros_like(Xq)
        tangent[:, a] = 1.0
        _, dk = torch.func.jvp(lambda x: kernel.eval(tq, X_loc, x), (Xq,), (tangent,))
        cols.append(dk)
    dK = torch.stack(cols, dim=-1) * mask_loc[:, None, None]  # (n_loc, m, d)
    return dK.reshape(X_loc.shape[0], m * d)


def _lml_from(quad, logdet, mask):
    n_real = mask.sum().to(quad.dtype).to(quad.device)
    lml = -0.5 * quad - logdet - 0.5 * n_real * _LOG2PI
    return torch.where(torch.isfinite(lml), lml, -math.inf)


def _lml_one(kernel, theta, X, y, alpha_diag, mask, rows, nb, n_warp=0,
             factor=_factor_block):
    """Masked LML of one theta row (kernel theta, then the warp
    log-parameters where ``n_warp`` > 0: the Beta-CDF warp of the
    replicated X is applied here, per row, as JAX's ``_lml_strip_body``)."""
    if n_warp:
        from ..models import warping as wp

        theta, la, lb = wp.split_warp_params(theta, n_warp)
        X = wp.warp(X, la, lb)
    quad, logdet, *_ = _sweep_strip(kernel, theta, X, None, y, alpha_diag, mask, rows, nb,
                                    factor=factor)
    return _lml_from(quad, logdet, mask)


def row_sharded_lml(kernel, theta, X, y, alpha_diag, mask, mesh, nb=256, unroll=False):
    """Masked LML of one theta with the gram row-sharded over ``mesh``.

    Arguments as :func:`bask_tpu_torch.ops.linalg.masked_lml`; ``mesh`` is
    a 1-axis :class:`~bask_tpu_torch.parallel.mesh.Mesh` (or a 2-axis one,
    whose last axis shards the rows) whose row-axis size divides
    ``n_pad``; ``nb`` is the panel width, clamped to a divisor of the
    local row count; ``unroll`` gives the same sweep either way (module
    docstring). The result is on the device of ``theta``."""
    rows, _, nb = _prep_row_mesh(mesh, X.shape[0], nb, "row_sharded_lml")
    return _lml_one(kernel, theta, X, y, alpha_diag, mask, rows, nb).to(theta.device)


def _adjoint(kernel, theta, X, y, alpha_diag, mask, mesh, nb):
    """Masked LML and its exact theta-gradient (GPML eq. 5.9):

        dLML/dtheta_i = 1/2 a^T dK_i a - 1/2 tr(K^-1 dK_i),   a = K^-1 y,

    from passes whose cost does not depend on the number of
    hyperparameters D: a factor sweep that stores the factor strips and
    forward-solves ``L^-1 [y, I]``; a backward sweep
    ``L^T [a, K^-1] = [L^-1 y, L^-1]`` (bottom-up, one reduction per
    panel); then the contraction of every ``dK_i`` strip with
    ``W = (a a^T - K^-1) / 2``, one reverse pass of the strip gram per
    entry. About 5 strips of memory."""
    strips = _Strips(mesh, X, y, alpha_diag, mask)
    n, n_loc = strips.n, strips.n_loc
    K, B, gram_fns = [], [], []
    for i, dev in enumerate(strips.devs):
        Xr, _, _, maskr, X_loc, y_loc, alpha_loc, mask_loc = strips.inputs(i)
        r0 = strips.r0(i)

        def gram_fn(t, Xr=Xr, X_loc=X_loc, alpha_loc=alpha_loc, maskr=maskr,
                    mask_loc=mask_loc, r0=r0):
            return _gram_strip(kernel, t, Xr, X_loc, alpha_loc, maskr, mask_loc, r0)

        gram_fns.append(gram_fn)
        Kl = gram_fn(theta.to(dev))
        eye = torch.zeros((n_loc, n), dtype=Kl.dtype, device=dev)
        eye.diagonal(offset=r0).fill_(1.0)
        K.append(Kl)
        B.append(torch.cat([y_loc[:, None], eye], dim=1))
    L = [torch.zeros_like(k) for k in K]
    Z = [torch.zeros_like(b) for b in B]
    home = strips.home
    logdet = torch.zeros((), dtype=K[0].dtype, device=home)
    for row0, owner, loc0, fac, Pls in _sweep(strips, K, B, nb, _factor_block):
        for i, p in enumerate(strips.local):
            L[i][:, row0:row0 + nb] = Pls[i]
            if p == owner:
                Lkk, _, Zk = fac[strips.devs[i]]
                L[i][loc0:loc0 + nb, row0:row0 + nb] = Lkk
                Z[i][loc0:loc0 + nb] = Zk
        logdet = logdet + torch.log(fac[home][0].diagonal()).sum()
    quad = mesh.all_reduce([(z[:, 0] ** 2).sum() for z in Z], device=home)

    # backward sweep: L^T S = Z, S = [a, K^-1] row-sharded
    S = [torch.zeros_like(z) for z in Z]
    for row0 in range(n - nb, -1, -nb):
        owner, loc0 = divmod(row0, n_loc)
        lo = row0 + nb
        parts = []
        for i in range(len(S)):
            cut = strips.below(i, lo)  # rows >= lo are back-solved
            parts.append(L[i][cut:, row0:lo].T @ S[i][cut:])
        contrib = mesh.all_reduce(parts, device=home)
        if owner in strips.local:
            i = strips.local.index(owner)
            dev = strips.devs[i]
            Lkk = L[i][loc0:loc0 + nb, row0:lo]
            rhs = Z[i][loc0:loc0 + nb] - contrib.to(dev)
            S[i][loc0:loc0 + nb] = torch.linalg.solve_triangular(Lkk.T, rhs, upper=True)
    alpha_full = mesh.all_gather([s[:, 0] for s in S])

    # dLML/dtheta_i = <W, dK_i> with W = (a_loc a^T - K^-1_loc) / 2 on each
    # strip: one reverse pass of the strip gram per entry gives every i
    # (JAX takes one forward pass per i; the sum is the same)
    parts = []
    for i, dev in enumerate(strips.devs):
        W = 0.5 * (S[i][:, :1] * alpha_full[dev][None, :] - S[i][:, 1:])
        th = theta.detach().to(dev).requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad((gram_fns[i](th) * W).sum(), th)
        parts.append(g)
    grad = mesh.all_reduce(parts, device=home)
    return _lml_from(quad, logdet, mask), grad


def row_sharded_lml_value_grad(kernel, theta, X, y, alpha_diag, mask, mesh, nb=256,
                               unroll=False, method="adjoint"):
    """Masked LML and its theta-gradient, every pass row-sharded.

    Reverse mode through the sweep would keep every panel (O(steps n^2/P)
    memory, what this module exists to avoid), so two storage-free forms:

    * ``method="adjoint"`` (default): the closed-form GPML gradient from
      about three distributed passes, whatever the hyperparameter count D;
    * ``method="jvp"``: one ``torch.func.jvp`` of the LML sweep per
      hyperparameter, D sweeps at about 2 strips of memory. K3 has no
      derivative, so its diagonal blocks are factored by ``cholesky_ex``
      and a triangular solve. It runs on a mesh inside one process.

    Returns ``(lml, grad)``, ``grad`` of ``theta``'s shape, on ``theta``'s
    device."""
    if method not in ("adjoint", "jvp"):
        raise ValueError(f"unknown method {method!r} (adjoint|jvp)")
    rows, _, nb = _prep_row_mesh(mesh, X.shape[0], nb, "row_sharded_lml_value_grad")
    if method == "adjoint":
        v, g = _adjoint(kernel, theta, X, y, alpha_diag, mask, rows, nb)
        return v.to(theta.device), g.to(theta.device)
    if rows.group is not None:
        raise ValueError("method='jvp' runs on a mesh inside one process; use 'adjoint'")

    def f(t):
        return _lml_one(kernel, t, X, y, alpha_diag, mask, rows, nb,
                        factor=_factor_block_plain)

    vals, grads = [], []
    for j in range(theta.shape[0]):
        tangent = torch.zeros_like(theta)
        tangent[j] = 1.0
        v, g = torch.func.jvp(f, (theta,), (tangent,))
        vals.append(v)
        grads.append(g.to(theta.device))
    return vals[0].to(theta.device), torch.stack(grads)


def row_sharded_predict(kernel, theta, X, y, alpha_diag, mask, Xq, mesh, nb=256,
                        y_mean=0.0, y_std=1.0, theta_diag=None, return_lml=False,
                        return_cov=False, return_grad=False, unroll=False):
    """Predictive mean and std (or covariance) with the gram row-sharded:
    the forward solves of ``y`` and ``k(X, Xq)`` ride the factorization
    sweep, with no stored factor and no backward solve:

        mean = y_mean + y_std (L^-1 Kq)^T (L^-1 y)
        var  = diag k(Xq, Xq) - |L^-1 Kq|^2
        cov  = (k(Xq, Xq) - (L^-1 Kq)^T (L^-1 Kq)) y_std^2   [return_cov]

    ``theta_diag`` is the theta of the query side (noise-free
    prediction). ``return_grad`` appends the gradients of mean and std in
    each query point, (m, d) each, from extra columns of the same sweep;
    ``return_lml`` appends the masked LML. Order:
    ``mean, uncert[, mean_grad, std_grad][, lml]``, on ``Xq``'s device."""
    if return_grad and return_cov:
        raise ValueError(
            "return_grad gives mean/std gradients; it is incompatible with return_cov"
        )
    rows, _, nb = _prep_row_mesh(mesh, X.shape[0], nb, "row_sharded_predict")
    tq = theta if theta_diag is None else theta_diag
    quad, logdet, dot, qnorm, qouter, dotg, qcross = _sweep_strip(
        kernel, theta, X, Xq, y, alpha_diag, mask, rows, nb, theta_diag=tq,
        with_outer=return_cov, with_grad=return_grad,
    )
    dev = Xq.device
    dot, qnorm, qouter, dotg, qcross = (t.to(dev) for t in (dot, qnorm, qouter, dotg, qcross))
    lml = _lml_from(quad, logdet, mask).to(dev)
    tq = tq.to(dev)
    mean = y_mean + y_std * dot
    if return_cov:
        uncert = (kernel.eval(tq, Xq) - qouter) * y_std**2
    else:
        uncert = torch.sqrt(torch.clamp(kernel.diag(tq, Xq) - qnorm, min=0.0)) * y_std
    out = [mean, uncert]
    if return_grad:
        # mean = y_mean + y_std (L^-1 Kq)^T (L^-1 y)  ->  d mean = y_std dotg;
        # var = diag k(x, x) - |L^-1 Kq|^2  ->  d std = y_std (d diag / 2 - qcross) / std,
        # with std clipped as reported (0, not an epsilon: a zero variance
        # gives inf/NaN as the dense path's autograd through sqrt does)
        xg = Xq.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            dg = kernel.diag(tq, xg)
            ddiag = (torch.autograd.grad(dg.sum(), xg, allow_unused=True)[0]
                     if dg.requires_grad else None)
        if ddiag is None:
            ddiag = torch.zeros_like(Xq)
        std = torch.sqrt(torch.clamp(kernel.diag(tq, Xq) - qnorm, min=0.0))
        out.append(y_std * dotg)
        out.append(y_std * (0.5 * ddiag - qcross) / std[:, None])
    if return_lml:
        out.append(lml)
    return tuple(out)


def row_sharded_sample_y(kernel, theta, X, y, alpha_diag, mask, Xq, z, mesh, n_samples=1,
                         nb=256, y_mean=0.0, y_std=1.0, theta_diag=None):
    """Joint predictive draws (m, n_samples) at ``Xq`` with the gram
    row-sharded: the (m, m) covariance from the sweep, then
    :func:`bask_tpu_torch.models.gp.eigh_draws` (m << n). ``z`` are the
    standard normals, (m, n_samples), in place of JAX's PRNG ``key``."""
    from ..models.gp import eigh_draws

    if tuple(z.shape) != (Xq.shape[0], n_samples):
        raise ValueError(f"z must be ({Xq.shape[0]}, {n_samples}), got {tuple(z.shape)}")
    mean, cov = row_sharded_predict(
        kernel, theta, X, y, alpha_diag, mask, Xq, mesh=mesh, nb=nb, y_mean=y_mean,
        y_std=y_std, theta_diag=theta_diag, return_cov=True,
    )
    return eigh_draws(mean, cov, z.to(mean.device))


def row_sharded_lml_batch(kernel, thetas, X, y, alpha_diag, mask, mesh, nb=256,
                          unroll=False, n_warp=0):
    """(W, n_theta) -> (W,) LMLs, each factorization row-sharded; the
    walkers run one after another (at this n the mesh's parallelism goes
    to the rows). ``n_warp`` > 0: each row carries its Beta-CDF warp
    parameters, applied to the replicated X inside its own sweep."""
    rows, _, nb = _prep_row_mesh(mesh, X.shape[0], nb, "row_sharded_lml_batch")
    out = [_lml_one(kernel, t, X, y, alpha_diag, mask, rows, nb, n_warp)
           for t in thetas]
    return torch.stack([v.to(thetas.device) for v in out])


def walker_row_sharded_lml(kernel, thetas, X, y, alpha_diag, mask, mesh, nb=256,
                           unroll=False, n_warp=0):
    """(W, n_theta) -> (W,) LMLs on a 2-axis (walkers, rows) mesh: the
    walkers split over the first axis (no communication), and each
    walker's factorization row-shards over its group's entries of the
    second. The walker count must be divisible by the first axis size,
    ``n_pad`` by the second. The groups run in turn here; on distinct
    cards their work is queued on each card without waiting."""
    if len(mesh.axis_names) != 2:
        raise ValueError("walker_row_sharded_lml expects a 2-axis mesh (walkers, rows)")
    w_ax, r_ax = mesh.axis_names
    W_sz, P_sz = mesh.shape[w_ax], mesh.shape[r_ax]
    W, n = thetas.shape[0], X.shape[0]
    if W % W_sz:
        raise ValueError(
            f"walker count {W} must be divisible by the mesh's {w_ax} axis size {W_sz}"
        )
    if n % P_sz:
        raise ValueError(
            f"n_pad={n} must be divisible by the mesh's {r_ax} axis size {P_sz}"
        )
    nb = pick_row_nb(n // P_sz, nb)
    per = W // W_sz
    out = []
    for g in range(W_sz):
        out.append(row_sharded_lml_batch(
            kernel, thetas[g * per:(g + 1) * per], X, y, alpha_diag, mask, mesh.row(g),
            nb=nb, unroll=unroll, n_warp=n_warp,
        ))
    return torch.cat(out)
