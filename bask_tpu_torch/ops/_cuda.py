"""Build and load the package's hand-written CUDA kernels.

The sources are ``bask_tpu_torch/csrc/*.cu``, each with a plain C
interface. At first use each is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library under ``bask_tpu_torch/_build/``, loaded with ``ctypes``.
The library's file name carries a hash of the sources, so an edited
source is rebuilt and a built one is reused. No ``--use_fast_math``: a
kernel takes an approximate operation only where it says so (K1's root,
K3's pivot rsqrt); ``expf`` stays exact, as the tests' bounds assume.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises when
that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["library", "check", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_GRAM_ARGS = [  # thetas, theta_stride, has_const, has_white, n_ls,
    # X, x_walker_stride, alpha, n_real, B, n_pad, d, nu_code, out, stream
    _P, _LL, _I, _I, _I, _P, _LL, _P, _I, _I, _I, _I, _I, _P, _P,
]
_SIGNATURES = {
    "bask_gram_f32": _GRAM_ARGS,
    "bask_gram_lower_f32": _GRAM_ARGS,  # n_pad a multiple of 128
    # K1's arguments with wb (walkers per block) after nu_code; shared X
    "bask_gram_wb_f32": _GRAM_ARGS[:13] + [_I] + _GRAM_ARGS[13:],
    # kernel (0 K1, 1 K2, 2 K4), nu_code, d, out: resident blocks per SM
    "bask_gram_blocks_per_sm": [_I, _I, _I, _P],
    # A, batch_stride, row_stride, L, Linv, batch, m, stream
    "bask_chol_inv_f32": [_P, _LL, _LL, _P, _P, _I, _I, _P],
}

# filled by library(): build seconds and nvcc's resource report
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(_ARCH.encode())
    so = _BUILD / f"libbask_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [_BUILD / f"{src.stem}.{tag}.o" for src in sources]
        nvcc = _nvcc()
        # one nvcc per source, all running at once
        procs = [
            subprocess.Popen(
                [nvcc, _ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        reports = [(src.name, *proc.communicate(), proc.returncode)
                   for src, proc in zip(sources, procs)]
        failed = [r for r in reports if r[3] != 0]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            link = subprocess.run(
                [nvcc, _ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                failed.append(("link", link.stdout, link.stderr, link.returncode))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{out}\n{err}" for name, out, err, rc in failed
            ))
        os.replace(tmp, so)
        build_info["ptxas"] = "\n".join(err for _, _, err, _ in reports)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["library"] = so.name
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bask_error_string.argtypes = [ctypes.c_int]
    lib.bask_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        name = library().bask_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
