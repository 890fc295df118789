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
``benchmarks/bench_gram_wb.py::gram_wb``: K1's function for shared X
(``csrc/gram_wb.cu``), redesigned for Hopper. A persistent grid (one
block per SM) walks units of (``wb`` walkers, one 128 x 128 tile on or
below the diagonal); each block holds the whole X in shared memory where
it fits (one bulk copy at its start; otherwise each unit's rows are read
a step ahead), computes the cross term on the tensor cores in 3xTF32
(``mma.sync``, the counterpart of JAX's ``Precision.HIGHEST`` product),
applies K1's epilogue, and writes the tile and its transpose to shared
memory, from where a storing warp sends them to the gram with TMA tensor
stores while the next tile computes. Its values are within the same
4e-6 max|K| of float64 as K1's, not equal to K1's bit for bit; each
K[b] is exactly symmetric, the diagonal is exact, and a walker's values
do not depend on B, ``wb`` or the block. Its plain version is K1's,
:func:`fused_masked_gram_plain`. :func:`fused_masked_gram_batch` sends
shared-X float32 calls to it at every ``(n_pad, d)`` of :data:`_K4_ROUTE`,
for every number of walkers.

:func:`_pack_params` (the packed rows ``[amp, noise, 1/ls...]``, as the
JAX package packs them) stays for the plain version and the tests.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..utils.graphs import counted
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
# K4's route: the (n_pad, d) of shared X at which fused_masked_gram_batch
# launches K4 (with the given walkers per unit) instead of K1, for every
# number of walkers, so that splitting the walkers never switches kernels.
# Routed where chip_smoke.py phase 11 measured K4 faster than K1 beyond the
# spread of both (device time alone, medians of four turns K1, K4 by wb,
# reversed, twice), on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit:
#   (512, 15):  (50, 512, 512):    K1 39.9 us, K4 wb 1 36.6, wb 2 39.0, wb 5 46.3;
#   (1024, 15): (128, 1024, 1024): K1 342.9 us, K4 wb 1 290.2, wb 2 288.4,
#                                  wb 4 284.2, wb 8 323.8;
#               (256, 1024, 1024): K1 695.8 us, K4 wb 1 581.2, wb 2 563.0,
#                                  wb 4 564.5, wb 8 559.1 (spreads 12-16 us).
# Any other (n_pad, d) stays on K1 (not measured). The gain is per layer
# only: the grams are ~1 % of a 2-second batch ask, and the chain is
# host-bound.
_K4_ROUTE = {(512, 15): 1, (1024, 15): 4}


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


@counted  # K1's launches
def fused_masked_gram_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real):
    """Masked grams for a batch of walkers: (B, n_pad, n_pad) float32.

    ``thetas``: (B, n_theta) log-params in the fused layout; ``X``:
    (n_pad, d) shared or (B, n_pad, d) per-walker inputs; ``alpha_diag``:
    (n_pad,) real-point jitter; ``n_real``: the number of unpadded points,
    a Python int or a 1-element int32 tensor on ``X``'s device (the
    kernels read it from device memory, so a CUDA graph that captured the
    launch serves every count its tensor is given; see :func:`_n_real_arg`).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot): K1, or K4 for shared X at an
    ``(n_pad, d)`` of :data:`_K4_ROUTE`.
    """
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    wb = _K4_ROUTE.get(tuple(X.shape)) if X.ndim == 2 else None
    if wb is not None:
        return fused_masked_gram_wb_batch(spec, thetas, X, alpha_diag, n_real, wb)
    return _k1_gram_batch(spec, thetas, X, alpha_diag, n_real)


def _k1_gram_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real):
    """K1 itself at every shape (no K4 route), counted in
    ``fused_masked_gram_batch.launches``: for the checks and timings that
    hold K1, or K4 against it. A CPU tensor runs the plain version."""
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    out = _launch("bask_gram_f32", _TILE, spec, thetas, X, alpha_diag, n_real)
    fused_masked_gram_batch.launches += 1
    return out


@counted
def fused_masked_gram_lower_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real):
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


@counted
def fused_masked_gram_wb_batch(spec: FusedSpec, thetas, X, alpha_diag, n_real, wb: int):
    """K4: :func:`fused_masked_gram_batch` for shared ``X`` (n_pad, d),
    with ``wb`` walkers per work unit (the last unit takes the ``B % wb``
    left over). The same function as K1, within its float64 tolerance;
    per-walker X and ``wb < 1`` are refused.

    A CPU tensor runs the plain version (:func:`fused_masked_gram_plain`);
    a CUDA tensor launches the kernel (and raises if it cannot).
    """
    _check_wb(X, wb)
    if not X.is_cuda:
        return fused_masked_gram_plain(spec, thetas, X, alpha_diag, n_real)
    out = _launch("bask_gram_wb_f32", _TILE, spec, thetas, X, alpha_diag, n_real, wb=int(wb))
    fused_masked_gram_wb_batch.launches += 1
    return out


def _check_wb(X, wb):
    if X.ndim != 2:
        raise ValueError(f"K4 takes shared X (n_pad, d), got {tuple(X.shape)}")
    if int(wb) < 1:
        raise ValueError(f"wb={wb}: K4 needs at least one walker per unit")


def _wb_tf32_control(spec: FusedSpec, thetas, X, alpha_diag, n_real, wb: int):
    """K4 built with its cross term in one-pass TF32 (no lo products): a
    control that the precision checks must reject. Card only, uncounted,
    on no path of the package."""
    _check_wb(X, wb)
    if not X.is_cuda:
        raise ValueError("the TF32 control is a CUDA kernel: give it CUDA tensors")
    return _launch("bask_gram_wb_tf32_control_f32", _TILE, spec, thetas, X, alpha_diag,
                   n_real, wb=int(wb))


def _wb_info(nu: float, B: int, n_pad: int, d: int, wb: int) -> dict:
    """K4's launch plan on the current CUDA device for these sizes: dynamic
    shared memory per block (bytes), whether X is resident in it, resident
    blocks per SM (CUDA's occupancy calculator), grid blocks and units."""
    from ._cuda import check, library

    info = (ctypes.c_int * 5)()
    check(library().bask_gram_wb_info(_NU_CODE[nu], int(B), int(n_pad), int(d), int(wb), info),
          "bask_gram_wb_info")
    keys = ("smem_bytes", "x_resident", "blocks_per_sm", "grid", "units")
    return {k: (bool(v) if k == "x_resident" else int(v)) for k, v in zip(keys, info)}


def _blocks_per_sm(kernel: str, nu: float, d: int, n_pad: int = 1024) -> int:
    """Resident blocks per SM of the built ``kernel`` ("K1", "K2" or "K4")
    for ``nu`` and ``d`` on the current CUDA device, from CUDA's occupancy
    calculator (K4's shared memory, hence its count, depends on
    ``n_pad`` too; not on ``wb``)."""
    from ._cuda import check, library

    if kernel == "K4":
        return _wb_info(nu, 1, n_pad, d, 1)["blocks_per_sm"]
    out = ctypes.c_int(0)
    err = library().bask_gram_blocks_per_sm(
        ("K1", "K2").index(kernel), _NU_CODE[nu], int(d), ctypes.byref(out)
    )
    check(err, "bask_gram_blocks_per_sm")
    return out.value


def _launch(entry: str, multiple: int, spec, thetas, X, alpha_diag, n_real, wb=None):
    """Check the arguments, then launch the C entry point ``entry`` of
    ``csrc/gram.cu`` or ``csrc/gram_wb.cu`` on the current stream: one
    device operation. ``wb`` (K4's walkers per unit) goes after the nu
    code where it is given."""
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
    n_real = _n_real_arg(n_real, n_pad, X.device)
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
    if wb is not None and X.data_ptr() % 16:  # K4's bulk copy of X
        X = X.clone()
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
        n_real.data_ptr(),
        B,
        n_pad,
        d,
        _NU_CODE[spec.nu],
    ]
    if wb is not None:
        args.append(wb)
    check(getattr(library(), entry)(*args, out.data_ptr(), stream), entry)
    return out


def _n_real_arg(n_real, n_pad: int, device):
    """``n_real`` as the kernels take it, a 1-element int32 tensor on
    ``device``. A tensor is passed through (its value is never read on the
    host; the kernels write NaN where it lies outside [0, n_pad]). An int is
    range-checked here and becomes a cached tensor, made outside any graph
    capture and never written, so an eager call issues no copy for it."""
    if isinstance(n_real, torch.Tensor):
        if n_real.device != device or n_real.dtype != torch.int32 or n_real.numel() != 1:
            raise ValueError(
                f"n_real must be a 1-element int32 tensor on {device}, got "
                f"{tuple(n_real.shape)} {n_real.dtype} on {n_real.device}"
            )
        return n_real
    n = int(n_real)
    if not 0 <= n <= n_pad:
        raise ValueError(f"n_real={n} outside [0, {n_pad}]")
    return _n_real_tensor(device, n)


@functools.lru_cache(maxsize=None)  # at most n_pad + 1 counts a device
def _n_real_tensor(device, n: int):
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"n_real={n} is a Python int inside a CUDA graph capture: pass it "
            "as a 1-element int32 device tensor, whose value a replay reads"
        )
    return torch.full((1,), n, dtype=torch.int32, device=device)
