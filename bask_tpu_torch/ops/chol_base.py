"""Batched Cholesky factor and its inverse of small blocks (kernel K3).

Replaces the TPU kernel ``bask_tpu/ops/pallas_chol_base.py::chol_inv_base``
(steps in ``chol_inv_steps``). For a batch of SPD blocks (m <= 128) it
returns the lower factor ``L`` and ``L^-1`` together, in ``m``
right-looking steps with the forward-substitution inverse interleaved.
A non-PD block gives ``rsqrt(negative) = NaN``, which propagates to the
factor's last entry: the branchless "failed factorization -> -inf
log-probability" contract of the MCMC. Only the lower triangle of each
block is read.

On a CUDA tensor :func:`chol_inv_base` launches ``csrc/chol_base.cu``;
on a CPU tensor it runs :func:`chol_inv_plain`, a torch transcription of
``chol_inv_steps``.

What bounds the kernel on an H100: latency. The ``m`` steps depend on
each other and the bytes are few (a (50, 128, 128) batch moves 8.2 MB,
2.5 us at 3.35 TB/s). One 256-thread block factors one matrix: each
thread keeps an 8 x 8 share of the trailing matrix and of the residual
in registers, a step publishes the pivot column through shared memory
behind one barrier, and the entries that a step cannot change are left
out at compile time. The kernel reads each block where it lies (a batch
and a row stride), so the diagonal blocks of
:func:`bask_tpu_torch.ops.fast_cholesky.block_cholesky` are factored in
place, one launch per 128-wide panel.
"""

from __future__ import annotations

import math

import torch

from ..utils.graphs import counted

__all__ = ["chol_inv_base", "chol_inv_plain"]

_MAX_M = 128


def chol_inv_plain(A):
    """Plain PyTorch version of K3: ``(..., m, m) -> (L, L^-1)``, reading
    the lower triangle of ``A``; each step updates only the rows below
    and the columns right of its pivot."""
    m = A.shape[-1]
    M = A.clone()
    L = torch.zeros_like(A)
    X = torch.zeros_like(A)
    R = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for j in range(m):
        inv_s = torch.rsqrt(M[..., j : j + 1, j])  # NaN on non-PD
        col = M[..., j:, j] * inv_s  # (..., m - j)
        L[..., j:, j] = col
        xrow = R[..., j, : j + 1] * inv_s  # (..., j + 1)
        X[..., j, : j + 1] = xrow
        if j + 1 < m:
            below = col[..., 1:, None]
            M[..., j + 1 :, j + 1 :] -= below * below.transpose(-1, -2)
            R[..., j + 1 :, : j + 1] -= below * xrow[..., None, :]
    return L, X


@counted
def chol_inv_base(A):
    """``(L, L^-1)`` of a batch of small SPD matrices ``(..., m, m)``.

    Any leading batch shape. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (float32, m <= 128) or raises. The kernel
    reads ``A`` in place when its rows are unit-stride and its batch
    dimensions flatten to one stride (a diagonal block of a larger
    matrix does); otherwise the batch is copied first. ``L`` and ``L^-1``
    are fresh contiguous tensors.
    """
    if not A.is_cuda:
        return chol_inv_plain(A)
    from ._cuda import check, library

    m = A.shape[-1]
    if A.dtype != torch.float32:
        raise TypeError(f"chol_inv kernel takes float32, got {A.dtype}")
    if A.ndim < 2 or A.shape[-2] != m or not 1 <= m <= _MAX_M:
        raise ValueError(f"need (..., m, m) with m <= {_MAX_M}, got {tuple(A.shape)}")
    batch = math.prod(A.shape[:-2])
    # a view where the strides allow it; a copy (freed on return, reused
    # by the caching allocator only for work queued after this launch)
    # where they do not
    A3 = A.reshape(batch, m, m)
    if A3.stride(-1) != 1 or A3.stride(-2) < m:
        A3 = A3.contiguous()
    L = torch.empty((batch, m, m), dtype=A.dtype, device=A.device)
    Linv = torch.empty_like(L)
    if batch:
        stream = torch.cuda.current_stream(A.device).cuda_stream
        check(
            library().bask_chol_inv_f32(
                A3.data_ptr(), A3.stride(0), A3.stride(1), L.data_ptr(),
                Linv.data_ptr(), batch, m, stream,
            ),
            "bask_chol_inv_f32",
        )
        chol_inv_base.launches += 1
    return L.reshape(A.shape), Linv.reshape(A.shape)
