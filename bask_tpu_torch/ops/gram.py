"""Fused masked Matern/RBF gram for a batch of walkers (kernels K1, K2).

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

K2, :func:`fused_masked_gram_lower_batch`, replaces
``pallas_gram.py::fused_masked_gram_lower_batch``: K1's values in every
128 x 128 tile on or below the diagonal, exact zeros in every strictly
upper 128-tile, which it never computes. Its only consumer is a
factorization that reads the lower triangle (see
:mod:`bask_tpu_torch.ops.fast_cholesky`). It is the same CUDA kernel with
its ``lower`` template flag set, so the entries it computes are
bit-identical to K1's. The chain uses it when :data:`LOWER_GRAM` is
``"on"`` and ``n_pad`` is a multiple of :data:`_SQ_TILE`
(``ops.linalg._lml_batch_direct``); the default is ``"off"``, as in the
JAX package.

What bounds the kernel on an H100: the output write. At the chain's shape
(50, 512, 512) f32 that is 52.4 MB, 15.7 us at 3.35 TB/s, against about
2d + 20 operations per entry. So the kernel keeps every intermediate
(scaled rows, norms, distances) in shared memory and registers and
writes each entry once, as part of a float4 (a warp stores 512
contiguous bytes of a row). One 256-thread block computes a 64 x 128
tile of one walker's gram with plain FP32 FMAs (no TF32), each thread an
8 x 4 register tile; the tile's rows of X are staged with coalesced
loads in 16-wide chunks of ``d``, so any input width works, and each
row's squared norm is computed once per tile by the dot product's own
FMA chain (so d2(i, i) is exactly 0). The kernel also does the packing:
it reads ``thetas`` and the spec's flags and forms ``amp``, ``noise``
and ``1/ls`` with ``expf``, so the wrapper issues one device operation,
the launch. CUDA's ``expf`` is within 2 ulp (2.4e-7 relative) of the
exact exponential, as is ``torch.exp``; that moves an entry by at most
about 5e-7 max|K| (|r dk/dr| <= max|K| over the four nu), inside the
4e-6 max|K| that the kernel is held to against float64.
K2 writes the same bytes (its zeros are stored, as on the TPU) and
computes only the lower 128-tiles, 10 of 16 at n_pad = 512: the same
write bound.

K4, :func:`fused_masked_gram_wb_batch`, replaces
``benchmarks/bench_gram_wb.py::gram_wb``: K1's function for shared X,
with one CUDA block serving ``wb`` walkers of a tile. The block stages
the tile's raw X once and scales it by each walker's own ``1/ls``, so
every entry is K1's bit for bit; what it saves is K1's per-block latency
(the X loads and the block's start) on all but one walker of ``wb``. Its
plain version is K1's, :func:`fused_masked_gram_plain`.
:func:`fused_masked_gram_batch` sends shared-X calls at the shapes of
:data:`_K4_SHAPES` (the batch ask's) to it.

:func:`_pack_params` (the packed rows ``[amp, noise, 1/ls...]``, as the
JAX package packs them) stays for the plain version and the tests.
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
    "fused_masked_gram_lower_batch",
    "fused_masked_gram_lower_plain",
    "fused_masked_gram_wb_batch",
    "LOWER_GRAM",
]

_TILE = 64  # the kernel's row tile; n_pad must be a multiple
# K2 for the chain's grams: "on" or "off" (the JAX package's default)
LOWER_GRAM = "off"
_SQ_TILE = 128  # K2's zero pattern follows 128-tiles; n_pad must be a multiple
_NU_CODE = {0.5: 0, 1.5: 1, 2.5: 2, math.inf: 3}
# The shared-X shapes (walkers, n_pad, d) at which fused_masked_gram_batch
# launches K4 with _K4_WB walkers per block instead of K1: those where
# chip_smoke.py phase 11 measured K4 faster than K1 by more than the
# spread of both (the batch ask's grams). Device time alone, medians of
# four turns in each of three runs, on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (PERF.md section 6):
#   (256, 1024, 1024), d 15: K1 690.7-695.8 us, K4 wb 8 635.4-644.5 us;
#   (128, 1024, 1024), d 15: K1 350.1-350.5 us, K4 wb 8 337.9-338.8 us.
# Not routed: (50, 512, 512), d 15, where K4 lost (K1 40.0-40.1 us, K4
# wb 2 44.6-44.8 us: fewer, longer blocks leave more of the last wave
# idle), and any shape not measured. The gain is per layer only: the
# grams are ~1 % of a 2-second batch ask.
_K4_SHAPES = frozenset({(256, 1024, 15), (128, 1024, 15)})
_K4_WB = 8


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


def _upper_tiles(n_pad: int, device):
    """(n_pad, n_pad) bool: True in the strictly upper 128-tiles."""
    t = torch.arange(n_pad, device=device) // _SQ_TILE
    return t[None, :] > t[:, None]


def fused_masked_gram_lower_plain(spec: FusedSpec, thetas, X, alpha_diag, n_real):
    """Plain PyTorch version of K2: :func:`fused_masked_gram_plain` with
    the strictly upper 128-tiles set to 0."""
    n_pad = X.shape[-2]
    if n_pad % _SQ_TILE:
        raise ValueError(f"n_pad={n_pad} is not a multiple of {_SQ_TILE}")
    K = fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    return torch.where(_upper_tiles(n_pad, X.device), 0.0, K)


def fused_masked_gram_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real: int):
    """Masked grams for a batch of walkers: (B, n_pad, n_pad) float32.

    ``thetas``: (B, n_theta) log-params in the fused layout; ``X``:
    (n_pad, d) shared or (B, n_pad, d) per-walker inputs; ``alpha_diag``:
    (n_pad,) real-point jitter; ``n_real``: the number of unpadded points
    (an int: it is a kernel argument).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot): K1, or K4 (bit-equal) for shared X
    at a shape of :data:`_K4_SHAPES`.
    """
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    if X.ndim == 2 and (thetas.shape[0], *X.shape) in _K4_SHAPES:
        return fused_masked_gram_wb_batch(spec, thetas, X, alpha_diag, n_real, _K4_WB)
    return _k1_gram_batch(spec, thetas, X, alpha_diag, n_real)


fused_masked_gram_batch.launches = 0  # K1's launches


def _k1_gram_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real: int):
    """K1 itself at every shape (no K4 route), counted in
    ``fused_masked_gram_batch.launches``: for the checks and timings that
    hold K1, or K4 against it. A CPU tensor runs the plain version."""
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    out = _launch("bask_gram_f32", _TILE, spec, thetas, X, alpha_diag, n_real)
    fused_masked_gram_batch.launches += 1
    return out


def fused_masked_gram_lower_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real: int):
    """K2: the lower 128-tiles of :func:`fused_masked_gram_batch`, zeros
    above; the same arguments, with ``n_pad`` a multiple of 128.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot).
    """
    if not X.is_cuda:
        return fused_masked_gram_lower_plain(spec, thetas, X, alpha_diag, n_real)
    out = _launch("bask_gram_lower_f32", _SQ_TILE, spec, thetas, X, alpha_diag, n_real)
    fused_masked_gram_lower_batch.launches += 1
    return out


fused_masked_gram_lower_batch.launches = 0


def fused_masked_gram_wb_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real: int, wb: int):
    """K4: :func:`fused_masked_gram_batch` for shared ``X`` (n_pad, d),
    with one CUDA block serving ``wb`` walkers of a tile (the last block
    the ``B % wb`` left over). The same function as K1, bit for bit on
    the card; per-walker X and ``wb < 1`` are refused.

    A CPU tensor runs the plain version (:func:`fused_masked_gram_plain`);
    a CUDA tensor launches the kernel (and raises if it cannot).
    """
    if X.ndim != 2:
        raise ValueError(f"K4 takes shared X (n_pad, d), got {tuple(X.shape)}")
    if int(wb) < 1:
        raise ValueError(f"wb={wb}: K4 needs at least one walker per block")
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    out = _launch("bask_gram_wb_f32", _TILE, spec, thetas, X, alpha_diag, n_real, wb=int(wb))
    fused_masked_gram_wb_batch.launches += 1
    return out


fused_masked_gram_wb_batch.launches = 0


def _blocks_per_sm(kernel: str, nu: float, d: int) -> int:
    """Resident blocks per SM of the built ``kernel`` ("K1", "K2" or "K4")
    for ``nu`` and ``d`` on the current CUDA device, from CUDA's occupancy
    calculator (K4's count holds for every ``wb``)."""
    from ._cuda import check, library

    out = ctypes.c_int(0)
    err = library().bask_gram_blocks_per_sm(
        ("K1", "K2", "K4").index(kernel), _NU_CODE[nu], int(d), ctypes.byref(out)
    )
    check(err, "bask_gram_blocks_per_sm")
    return out.value


def _launch(entry: str, multiple: int, spec, thetas, X, alpha_diag, n_real, wb=None):
    """Check the arguments, then launch the C entry point ``entry`` of
    ``csrc/gram.cu`` on the current stream: one device operation. ``wb``
    (K4's walkers per block) goes after the nu code where it is given."""
    from ._cuda import check, library

    B = thetas.shape[0]
    n_pad, d = X.shape[-2:]
    if X.dtype != torch.float32 or alpha_diag.dtype != torch.float32:
        raise TypeError("gram kernel takes float32 X and alpha_diag")
    if thetas.dtype != torch.float32:
        raise TypeError(f"gram kernel takes float32 thetas, got {thetas.dtype}")
    if X.ndim not in (2, 3) or (X.ndim == 3 and X.shape[0] != B):
        raise ValueError(f"X must be (n_pad, d) or ({B}, n_pad, d), got {tuple(X.shape)}")
    if n_pad % multiple:
        raise ValueError(f"n_pad={n_pad} is not a multiple of {multiple}")
    if alpha_diag.shape != (n_pad,):
        raise ValueError(f"alpha_diag must be ({n_pad},), got {tuple(alpha_diag.shape)}")
    if thetas.device != X.device or alpha_diag.device != X.device:
        raise ValueError("thetas, X and alpha_diag must be on one CUDA device")
    if not 0 <= int(n_real) <= n_pad:
        raise ValueError(f"n_real={n_real} outside [0, {n_pad}]")
    n_theta = int(spec.has_const) + spec.n_ls + int(spec.has_white)
    if spec.n_ls not in (1, d) or thetas.ndim != 2 or thetas.shape[1] < n_theta:
        raise ValueError(
            f"thetas {tuple(thetas.shape)} do not give one [amp, noise, 1/ls] "
            f"row per walker for {spec} and d={d}"
        )
    # no-ops for the chain's tensors; a copy, where one is made, may be
    # freed on return: the caching allocator hands its block only to work
    # queued after this launch on the same stream
    X = X.contiguous()
    alpha_diag = alpha_diag.contiguous()
    if thetas.stride(1) != 1:
        thetas = thetas.contiguous()
    out = torch.empty((B, n_pad, n_pad), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    args = [
        thetas.data_ptr(),
        thetas.stride(0),
        int(spec.has_const),
        int(spec.has_white),
        spec.n_ls,
        X.data_ptr(),
        ctypes.c_longlong(n_pad * d if X.ndim == 3 else 0),
        alpha_diag.data_ptr(),
        int(n_real),
        B,
        n_pad,
        d,
        _NU_CODE[spec.nu],
    ]
    if wb is not None:
        args.append(wb)
    check(getattr(library(), entry)(*args, out.data_ptr(), stream), entry)
    return out
