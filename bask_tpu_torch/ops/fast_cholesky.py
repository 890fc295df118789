"""Blocked Cholesky with the factor's inverse built in the same recursion.

PyTorch counterpart of :mod:`bask_tpu.ops.fast_cholesky`:

* recursive 2x2 block Cholesky,  A = [[A11, .], [A21, A22]] ->
  L11 = chol(A11), L21 = A21 L11^-T, L22 = chol(A22 - L21 L21^T),
* the inverse assembled in the same recursion,
  inv([[L11, 0], [L21, L22]]) = [[inv11, 0], [-inv22 (L21 inv11), inv22]],
* bases of size <= ``_BASE`` = 128 factor and invert in one call of the
  K3 kernel (:func:`bask_tpu_torch.ops.chol_base.chol_inv_base`; its plain
  version on the CPU), which reads a diagonal block where it lies.

The base is 128 wide, not the JAX package's 32, on the card and on the
CPU alike (so the CPU tests run the blocking the card runs). On the TPU
the recursion's glue (two GEMMs, a ``zeros_like`` and six
concatenations per level) ran inside one jitted program and cost no
launches; here the port runs eagerly and the host pays ~15-18 us for
every device operation, more than most of these operations take on the
card. A 128 base removes the recursion below each 128-wide panel: one
(50, 512, 512) factorization with its forward solve issues 4 K3 launches
and 37 device operations instead of 16 launches and 205 (measured on an
H100 by ``chip_smoke.py``'s factorization A/B). The panels of
:func:`pick_nb` (128/256) are unchanged, so the diagonal-block inverses
``invs`` that the solves and ``predict(invs=)`` take keep their layout.

The GEMMs around the base are ``torch.matmul`` at full f32 (the package
never enables TF32). A non-PD input surfaces as NaN in a base factor and
propagates through every downstream matmul, so a failed factorization
gives a NaN (then -inf) log-likelihood without a branch.

Lower-only contract: everything here reads only the lower triangle of
``A`` at the granularity of 128 x 128 tiles, so a gram whose strictly
upper 128-tiles are zeros (kernel K2, ``ops.gram.LOWER_GRAM``) gives
bit-identical results to the full gram. It holds because

* a base is a whole diagonal 128-tile (or a ragged last panel of 64, or
  a half of a 256 panel), which K2 computes in full, and K3 (and its
  plain version) reads only the lower triangle of it;
* the recursion of a 256 panel splits at ``h = n // 2`` = 128 and reads
  ``A[:h, :h]``, ``A[h:, :h]`` and ``A[h:, h:]``, never ``A[:h, h:]``;
* the panels of :func:`pick_nb` are 128 or 256 wide and start on
  128-multiples, so a strictly upper 128-tile is only ever in the upper
  part of a trailing block or of a 256 panel, which the recursion does
  not read;
* the solves read ``L``, which is built from lower blocks only.

A panel or split that is not a multiple of 128 would read a zeroed tile.
``tests/test_torch_gram.py`` holds the LML from a K2 gram bit-equal to
the LML from a K1 gram at n_pad 128, 512 and 640 (256/256/128 panels).
"""

from __future__ import annotations

import torch

from .chol_base import chol_inv_base

__all__ = [
    "block_cholesky",
    "block_forward_solve",
    "block_solve_lower_mat",
    "block_solve_upper_mat",
    "fast_lml_terms",
    "pick_nb",
]

_BASE = 128  # K3's largest block: one launch per 128-wide panel


def _chol_inv_recursive(A, base=chol_inv_base):
    """(L, L^-1) of (..., n, n), built together; ``base`` factors the
    blocks of at most ``_BASE`` (K3, or its plain version)."""
    n = A.shape[-1]
    if n <= _BASE:
        return base(A)
    h = n // 2
    L11, inv11 = _chol_inv_recursive(A[..., :h, :h], base)
    L21 = A[..., h:, :h] @ inv11.transpose(-1, -2)
    S = A[..., h:, h:] - L21 @ L21.transpose(-1, -2)
    L22, inv22 = _chol_inv_recursive(S, base)
    zeros = torch.zeros_like(A[..., :h, h:])
    L = torch.cat(
        [torch.cat([L11, zeros], dim=-1), torch.cat([L21, L22], dim=-1)],
        dim=-2,
    )
    inv21 = -(inv22 @ (L21 @ inv11))
    inv = torch.cat(
        [torch.cat([inv11, zeros], dim=-1), torch.cat([inv21, inv22], dim=-1)],
        dim=-2,
    )
    return L, inv


def pick_nb(n: int) -> int:
    """Panel width: 128 up to n=512, 256 beyond (the JAX package's split;
    not yet re-measured on the H100)."""
    return 256 if n > 512 else 128


def _panel_sizes(n: int, nb: int):
    sizes = []
    while n > 0:
        sizes.append(min(nb, n))
        n -= sizes[-1]
    return sizes


def _offsets(sizes):
    out, lo = [], 0
    for s in sizes:
        out.append((lo, lo + s))
        lo += s
    return out


def block_cholesky(A, nb: int | None = None):
    """Lower Cholesky of (..., n, n) via matmul-rich blocking.

    Returns ``(L, diag_invs)``: the factor and the list of inverted
    diagonal blocks (the last may be ragged), which the solves below
    reuse.
    """
    n = A.shape[-1]
    if nb is None:
        nb = pick_nb(n)
    if n <= nb:
        L, L_inv = _chol_inv_recursive(A)
        return L, [L_inv]
    M = A.clone()
    cols, invs = [], []
    for lo, hi in _offsets(_panel_sizes(n, nb)):
        Ld, Ld_inv = _chol_inv_recursive(M[..., lo:hi, lo:hi])
        invs.append(Ld_inv)
        P = M[..., hi:, lo:hi] @ Ld_inv.transpose(-1, -2)
        cols.append(
            torch.cat([torch.zeros_like(M[..., :lo, lo:hi]), Ld, P], dim=-2)
        )
        if hi < n:
            # only the trailing block is read again; update it in place
            M[..., hi:, hi:] -= P @ P.transpose(-1, -2)
    return torch.cat(cols, dim=-1), invs


def _layout_from_invs(invs):
    return _offsets([iv.shape[-1] for iv in invs])


def _check_nb(L, invs, nb):
    """The panel width comes from ``invs``; an ``nb`` given beside them
    must be the one :func:`block_cholesky` made them with."""
    if nb is None:
        return
    n = L.shape[-1]
    widths = [iv.shape[-1] for iv in invs]
    if widths != ([n] if n <= nb else _panel_sizes(n, nb)):
        raise ValueError(f"nb={nb} disagrees with the diagonal-block inverses "
                         f"(panel widths {widths} for n={n})")


def block_forward_solve(L, invs, y, nb: int | None = None):
    """w = L^-1 y for ``y`` of shape (..., n), with the cached
    diagonal-block inverses (the one-column case of
    :func:`block_solve_lower_mat`). The panel layout comes from ``invs``;
    ``nb``, where given, must agree with it."""
    return block_solve_lower_mat(L, invs, y[..., None], nb=nb)[..., 0]


def block_solve_lower_mat(L, invs, Y, nb: int | None = None, precision=None):
    """W = L^-1 Y with cached diagonal-block inverses; Y is (..., n, m).
    Right-looking: each panel updates the remaining rows in one matmul.
    ``nb``, where given, must agree with ``invs``. ``precision`` (the JAX
    package's matmul precision override) is accepted and has no effect:
    the port's matmuls are full float32."""
    _check_nb(L, invs, nb)
    n = L.shape[-1]
    if len(invs) == 1 and invs[0].shape[-1] == n:
        return invs[0] @ Y
    R = Y
    ws = []
    for j, (lo, hi) in enumerate(_layout_from_invs(invs)):
        wj = invs[j] @ R[..., : hi - lo, :]
        ws.append(wj)
        if hi < n:
            R = R[..., hi - lo :, :] - L[..., hi:, lo:hi] @ wj
    return torch.cat(ws, dim=-2)


def block_solve_upper_mat(L, invs, Y, nb: int | None = None):
    """X = L^-T Y with cached diagonal-block inverses; Y is (..., n, m).
    ``nb``, where given, must agree with ``invs``."""
    _check_nb(L, invs, nb)
    n = L.shape[-1]
    if len(invs) == 1 and invs[0].shape[-1] == n:
        return invs[0].transpose(-1, -2) @ Y
    spans = _layout_from_invs(invs)
    R = Y
    xs = [None] * len(spans)
    for j in range(len(spans) - 1, -1, -1):
        lo, hi = spans[j]
        xj = invs[j].transpose(-1, -2) @ R[..., lo:hi, :]
        xs[j] = xj
        if lo > 0:
            R = R[..., :lo, :] - L[..., lo:hi, :lo].transpose(-1, -2) @ xj
    return torch.cat(xs, dim=-2)


def fast_lml_terms(Kp, y, nb: int | None = None):
    """(L, sum log diag L, |L^-1 y|^2) via the blocked factorization."""
    L, invs = block_cholesky(Kp, nb=nb)
    w = block_forward_solve(L, invs, y)
    logdiag = torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1)
    quad = (w * w).sum(-1)
    return L, logdiag, quad
