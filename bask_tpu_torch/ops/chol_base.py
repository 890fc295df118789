"""Batched base-case Cholesky factor and its inverse (kernel K3).

Replaces the TPU kernel ``bask_tpu/ops/pallas_chol_base.py::chol_inv_base``
(steps in ``chol_inv_steps``). For a batch of small SPD blocks (m <= 32)
it returns the lower factor ``L`` and ``L^-1`` together, in ``m``
right-looking steps with the forward-substitution inverse interleaved.
A non-PD block gives ``rsqrt(negative) = NaN``, which propagates to the
factor's last entry: the branchless "failed factorization -> -inf
log-probability" contract of the MCMC.

On a CUDA tensor :func:`chol_inv_base` launches ``csrc/chol_base.cu``;
on a CPU tensor it runs :func:`chol_inv_plain`, a torch transcription of
``chol_inv_steps``.

What bounds the kernel on an H100: latency. The ``m`` steps depend on
each other and the bytes are tiny (a (50, 32, 32) batch is 200 KB). The
design keeps one matrix in one warp's registers (lane r holds row r of
the trailing matrix and column r of the residual), so a step is a few
shuffles and FMAs with no shared memory and no block barrier. At the
chain's shapes the launch itself is expected to dominate.
"""

from __future__ import annotations

import math

import torch

__all__ = ["chol_inv_base", "chol_inv_plain"]

_MAX_M = 32


def chol_inv_plain(A):
    """Plain PyTorch version of K3: ``(..., m, m) -> (L, L^-1)``."""
    m = A.shape[-1]
    M = A
    L = torch.zeros_like(A)
    X = torch.zeros_like(A)
    idx = torch.arange(m, device=A.device)
    R = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape)
    for j in range(m):
        dcol = M[..., :, j : j + 1]  # (..., m, 1)
        inv_s = torch.rsqrt(M[..., j : j + 1, j : j + 1])  # NaN on non-PD
        col = torch.where((idx >= j)[:, None], dcol * inv_s, 0.0)
        L = L + torch.where(idx[None, :] == j, col, 0.0)
        xrow = R[..., j : j + 1, :] * inv_s  # (..., 1, m)
        X = X + torch.where((idx == j)[:, None], xrow, 0.0)
        if j + 1 < m:
            M = M - col * col.transpose(-1, -2)
            R = R - torch.where((idx > j)[:, None], col, 0.0) * xrow
    return L, X


def chol_inv_base(A):
    """``(L, L^-1)`` of a batch of small SPD matrices ``(..., m, m)``.

    Any leading batch shape; flattened for the kernel. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (float32,
    m <= 32) or raises.
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
    # a contiguous copy may be freed on return: the caching allocator
    # reuses it only for work queued after this launch on the stream
    A2 = A.reshape(batch, m, m).contiguous()
    L = torch.empty_like(A2)
    Linv = torch.empty_like(A2)
    if batch:
        stream = torch.cuda.current_stream(A.device).cuda_stream
        check(
            library().bask_chol_inv_f32(
                A2.data_ptr(), L.data_ptr(), Linv.data_ptr(), batch, m, stream
            ),
            "bask_chol_inv_f32",
        )
        chol_inv_base.launches += 1
    return L.reshape(A.shape), Linv.reshape(A.shape)


chol_inv_base.launches = 0
