"""Build and load the package's hand-written CUDA kernels.

The sources are ``bask_tpu_torch/csrc/*.cu``, each with a plain C
interface. At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library under ``bask_tpu_torch/_build/``
and loaded with ``ctypes``. The library's file name carries a hash of the
sources, so an edited source is rebuilt and a built one is reused.
No ``--use_fast_math``: approximate ``expf``/``sqrtf`` would move the
parity the tests pin.

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
_SIGNATURES = {
    # packed, X, x_walker_stride, alpha, n_real, B, n_pad, d, nu_code, out, stream
    "bask_gram_f32": [_P, _P, ctypes.c_longlong, _P, _I, _I, _I, _I, _I, _P, _P],
    # A, L, Linv, batch, m, stream
    "bask_chol_inv_f32": [_P, _P, _P, _I, _I, _P],
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
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(tmp),
            *map(str, sources),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
        build_info["ptxas"] = proc.stderr
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
