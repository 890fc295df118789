"""Build and load the package's hand-written CUDA kernels.

The sources are ``bask_tpu_torch/csrc/*.cu``, each with a plain C
interface, and the headers they share (``csrc/*.cuh``). At first use each is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library, loaded with ``ctypes``. It lives in the build directory:
``bask_tpu_torch/_build/``, or the directory that
:func:`bask_tpu_torch.utils.aot.enable_aot_cache` names. The library's file
name carries a hash of the sources, the target, the ``nvcc`` version,
torch's version and CUDA version and the card's compute capability
(:func:`library_name`), so an edited source or another toolchain or card
builds anew, and a build for the same ones is reused. No ``--use_fast_math``: a
kernel takes an approximate operation only where it says so (the Matern
root of K1, K2, K4 and K5, K3's pivot rsqrt, the cosine of K5's
tensor-core kernel on an exactly reduced argument); ``expf`` stays exact,
as the tests' bounds assume.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises when
that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import json
import subprocess
import time
from pathlib import Path

__all__ = ["library", "check", "build_info", "library_name", "set_build_dir"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_DEFAULT_BUILD = _PKG / "_build"
_build_dir = _DEFAULT_BUILD  # where library() looks for the build and puts it
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_GRAM_ARGS = [  # thetas, theta_stride, has_const, has_white, n_ls,
    # X, x_walker_stride, alpha, n_real (a device int), B, n_pad, d, nu_code,
    # out, stream
    _P, _LL, _I, _I, _I, _P, _LL, _P, _P, _I, _I, _I, _I, _P, _P,
]
_SIGNATURES = {
    "bask_gram_f32": _GRAM_ARGS,
    "bask_gram_lower_f32": _GRAM_ARGS,  # n_pad a multiple of 128
    # K1's arguments with wb (the walkers of a unit) after nu_code; shared X
    "bask_gram_wb_f32": _GRAM_ARGS[:13] + [_I] + _GRAM_ARGS[13:],
    # the same, the cross term in one-pass TF32 (a precision control)
    "bask_gram_wb_tf32_control_f32": _GRAM_ARGS[:13] + [_I] + _GRAM_ARGS[13:],
    # nu_code, B, n_pad, d, wb, info[5]: K4's launch plan
    "bask_gram_wb_info": [_I, _I, _I, _I, _I, _P],
    # kernel (0 K1, 1 K2), nu_code, d, out: resident blocks per SM
    "bask_gram_blocks_per_sm": [_I, _I, _I, _P],
    # A, batch_stride, row_stride, L, Linv, batch, m, stream
    "bask_chol_inv_f32": [_P, _LL, _LL, _P, _P, _I, _I, _P],
    # xq, xq_stride, omega, phase, w, coef, x (or null), x_stride, inv_ls,
    # v, amp, out, B, m, n_feat, n_pts, d, r, nu_code, stream
    "bask_pathwise_values_f32": [_P, _LL, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    # d, r, nu_code, info[4]: K5's launch plan
    "bask_pathwise_values_info": [_I, _I, _I, _P],
}

# filled by library(): seconds to build or load, whether nvcc built it, the
# library's path, and nvcc's resource report
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _nvcc_version() -> str:
    """The toolkit's nvcc version from its ``version.json``; where the
    toolkit has none, the nvcc binary's resolved path, size and
    modification time. No process is started, so a process that finds its
    library built runs no nvcc at all."""
    from torch.utils.cpp_extension import CUDA_HOME

    try:
        with open(Path(CUDA_HOME or "") / "version.json") as f:
            return json.load(f)["cuda_nvcc"]["version"]
    except (OSError, KeyError, TypeError, ValueError):
        nvcc = Path(_nvcc()).resolve()
        st = nvcc.stat()
        return f"{nvcc}:{st.st_size}:{st.st_mtime_ns}"


def _toolchain() -> list:
    """What a build depends on besides the sources: the nvcc version,
    torch's version and CUDA version, the current card's compute
    capability (the JAX package's ``aot._fingerprint`` keys its executables
    on the toolchain and the device the same way)."""
    import torch

    major, minor = torch.cuda.get_device_capability()
    return [_nvcc_version(), torch.__version__, str(torch.version.cuda), f"sm_{major}{minor}"]


def library_name() -> str:
    """The library's file name: a hash of the sources and headers, the
    target and :func:`_toolchain`."""
    digest = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    for part in [_ARCH, *_toolchain()]:
        digest.update(b"\0" + part.encode())
    return f"libbask_kernels_{digest.hexdigest()[:16]}.so"


def set_build_dir(path=None) -> None:
    """Look for the library in ``path``, and build it there, from the next
    :func:`library` load on (``None``: ``bask_tpu_torch/_build/``). A
    library this process has loaded stays loaded."""
    global _build_dir
    _build_dir = _DEFAULT_BUILD if path is None else Path(path)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The compiled kernel library, loaded from the build directory, or
    built there first where it is missing."""
    sources = sorted(_CSRC.glob("*.cu"))
    name = library_name()
    so = _build_dir / name
    t0 = time.perf_counter()
    build_info["built"] = not so.exists()
    if build_info["built"]:
        _build_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        objs = [_build_dir / f"{src.stem}.{tag}.o" for src in sources]
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
    build_info["path"] = str(so)
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
