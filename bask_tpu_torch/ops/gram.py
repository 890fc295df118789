"""Fused masked Matern/RBF gram for a batch of walkers (kernel K1).

Replaces the TPU kernel ``bask_tpu/ops/pallas_gram.py::
fused_masked_gram_batch`` (math in ``_tile_values``, packing in
``_pack_params``). For walker ``b``, from the packed row
``[amp, noise, 1/ls...]``:

    d2 = |x_i/ls|^2 + |x_j/ls|^2 - 2 (x_i/ls).(x_j/ls)   (full f32, >= 0)
    K  = amp * k_nu(d2),  r = sqrt(d2 + 1e-36),  nu in {1/2, 3/2, 5/2, inf}

entries outside the ``n_real x n_real`` block are 0, the real diagonal
gets ``+ noise + alpha_i`` and the padded diagonal is 1.

On a CUDA tensor :func:`fused_masked_gram_batch` launches the
hand-written kernel ``csrc/gram.cu``; on a CPU tensor it runs
:func:`fused_masked_gram_plain`, a torch transcription of the same math.

What bounds the kernel on an H100: the output write. At the chain's shape
(50, 512, 512) f32 that is 52 MB, about 16 us at 3.35 TB/s, against
about 2d + 20 flops per entry. So the kernel keeps every intermediate
(scaled rows, norms, distances) in shared memory and registers, and each
warp stores whole 128-byte row segments. One block computes a 64 x 64
tile of one walker's gram with plain FP32 FMAs (no TF32), looping over
``d`` in 32-wide chunks so any input width works.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import kernels as bk

__all__ = [
    "FusedSpec",
    "match_fusable",
    "fused_spec_for",
    "fused_masked_gram_batch",
    "fused_masked_gram_plain",
]

_TILE = 64  # the kernel's output tile; n_pad must be a multiple
_NU_CODE = {0.5: 0, 1.5: 1, 2.5: 2, math.inf: 3}


class FusedSpec(NamedTuple):
    """Structure of a fusable kernel tree."""

    nu: float  # 0.5 / 1.5 / 2.5 / inf (inf = RBF)
    n_ls: int  # number of lengthscales (1 = isotropic)
    has_const: bool  # leading ConstantKernel amplitude param
    has_white: bool  # trailing WhiteKernel noise param


def match_fusable(kernel) -> Optional[FusedSpec]:
    """Match ``Constant * (Matern|RBF) [+ White]`` (free params only)."""
    base = kernel
    has_white = False
    # Product subclasses Sum: compare exact types
    if type(base) is bk.Sum:
        if not (isinstance(base.k2, bk.WhiteKernel) and base.k2.n_theta == 1):
            return None
        has_white = True
        base = base.k1
    has_const = False
    if type(base) is bk.Product:
        if not (
            isinstance(base.k1, bk.ConstantKernel) and base.k1.n_theta == 1
        ):
            return None
        has_const = True
        base = base.k2
    if not isinstance(base, bk.RBF) or base.n_theta == 0:
        return None
    nu = base.nu if isinstance(base, bk.Matern) else math.inf
    if nu not in _NU_CODE:
        return None
    return FusedSpec(
        nu=nu, n_ls=base.n_theta, has_const=has_const, has_white=has_white
    )


def fused_spec_for(kernel, X) -> Optional[FusedSpec]:
    """The spec under which K1 builds the grams of ``kernel`` on ``X``, or
    ``None`` where it does not apply: a CPU or non-float32 ``X``, a bucket
    that is not a multiple of the kernel's tile, or a kernel outside
    ``Const * (Matern|RBF) [+ White]``."""
    if not (X.is_cuda and X.dtype == torch.float32 and X.shape[-2] % _TILE == 0):
        return None
    return match_fusable(kernel)


def _pack_params(spec: FusedSpec, thetas, d: int):
    """Per-walker packed rows ``[amp, noise, 1/ls...]``: (B, d + 2) f32."""
    B = thetas.shape[0]
    off = 1 if spec.has_const else 0
    ones = torch.ones(B, dtype=thetas.dtype, device=thetas.device)
    amp = torch.exp(thetas[:, 0]) if spec.has_const else ones
    noise = (
        torch.exp(thetas[:, off + spec.n_ls]) if spec.has_white else 0.0 * ones
    )
    inv_ls = torch.exp(-thetas[:, off : off + spec.n_ls])
    if spec.n_ls == 1:
        inv_ls = inv_ls.expand(B, d)
    return torch.cat(
        [amp[:, None], noise[:, None], inv_ls], dim=1
    ).to(torch.float32).contiguous()


def fused_masked_gram_plain(spec: FusedSpec, thetas, X, alpha_diag, n_real):
    """Plain PyTorch version of K1 over the whole batch: (B, n_pad, n_pad)
    in the dtype of ``X`` (float32 where the kernel would run; float64
    gives a reference for the kernel's rounding). ``X`` is (n_pad, d)
    shared or (B, n_pad, d) per walker. A point's distance to itself is
    exactly 0 here, as in the kernel, whose norm and dot FMA chains
    coincide for i == j (see ``kernels.sqdist``)."""
    n_pad, d = X.shape[-2:]
    packed = _pack_params(spec, thetas, d).to(X.dtype)
    amp, noise, inv_ls = packed[:, 0], packed[:, 1], packed[:, 2:]
    d2 = bk.sqdist(X, None, inv_ls)  # (B, n_pad, n_pad)
    K = amp[:, None, None] * bk.matern_from_d2(d2, spec.nu)
    idx = torch.arange(n_pad, device=X.device)
    real = idx < n_real
    real2 = real[:, None] & real[None, :]
    K = torch.where(real2, K, 0.0)
    diag = torch.where(
        real,
        K.diagonal(dim1=-2, dim2=-1) + noise[:, None] + alpha_diag.to(X.dtype),
        1.0,
    )
    eye = idx[:, None] == idx[None, :]
    return torch.where(eye, torch.diag_embed(diag), K)


def fused_masked_gram_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real: int):
    """Masked grams for a batch of walkers: (B, n_pad, n_pad) float32.

    ``thetas``: (B, n_theta) log-params in the fused layout; ``X``:
    (n_pad, d) shared or (B, n_pad, d) per-walker inputs; ``alpha_diag``:
    (n_pad,) real-point jitter; ``n_real``: the number of unpadded points
    (an int: it is a kernel argument).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot).
    """
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    from ._cuda import check, library

    B = thetas.shape[0]
    n_pad, d = X.shape[-2:]
    if X.dtype != torch.float32 or alpha_diag.dtype != torch.float32:
        raise TypeError("gram kernel takes float32 X and alpha_diag")
    if X.ndim not in (2, 3) or (X.ndim == 3 and X.shape[0] != B):
        raise ValueError(f"X must be (n_pad, d) or ({B}, n_pad, d), got {tuple(X.shape)}")
    if n_pad % _TILE:
        raise ValueError(f"n_pad={n_pad} is not a multiple of {_TILE}")
    if alpha_diag.shape != (n_pad,):
        raise ValueError(f"alpha_diag must be ({n_pad},), got {tuple(alpha_diag.shape)}")
    if thetas.device != X.device or alpha_diag.device != X.device:
        raise ValueError("thetas, X and alpha_diag must be on one CUDA device")
    if not 0 <= int(n_real) <= n_pad:
        raise ValueError(f"n_real={n_real} outside [0, {n_pad}]")
    X = X.contiguous()
    alpha_diag = alpha_diag.contiguous()
    packed = _pack_params(spec, thetas, d)
    if thetas.ndim != 2 or packed.shape != (B, d + 2):
        raise ValueError(
            f"thetas {tuple(thetas.shape)} do not give one [amp, noise, 1/ls] "
            f"row of {d + 2} per walker for {spec}"
        )
    # the temporaries (packed, contiguous copies) may be freed on return:
    # the caching allocator hands their blocks only to work queued after
    # this launch on the same stream
    out = torch.empty((B, n_pad, n_pad), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    check(
        library().bask_gram_f32(
            packed.data_ptr(),
            X.data_ptr(),
            ctypes.c_longlong(n_pad * d if X.ndim == 3 else 0),
            alpha_diag.data_ptr(),
            int(n_real),
            B,
            n_pad,
            d,
            _NU_CODE[spec.nu],
            out.data_ptr(),
            stream,
        ),
        "bask_gram_f32",
    )
    fused_masked_gram_batch.launches += 1
    return out


fused_masked_gram_batch.launches = 0
