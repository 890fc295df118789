"""A persistent cache of the built kernel library, across processes.

PyTorch counterpart of :mod:`bask_tpu.utils.aot`, with its names. What JAX
caches there is the compiled executable of each jitted program. The port
runs eagerly and has no such executable; what a fresh process compiles is
the kernel library (``csrc/*.cu`` by ``nvcc``, :mod:`bask_tpu_torch.ops._cuda`),
and that is what this cache keeps:

    from bask_tpu_torch import enable_aot_cache
    enable_aot_cache("~/.cache/bask_tpu_torch")   # or set BASK_TPU_AOT_CACHE

The library is then looked up, and built where it is missing, in that
directory instead of the package's ``_build/``, under a name that hashes
the sources, the target, the ``nvcc`` version, torch's version and CUDA
version and the card's compute capability: a library from another
toolchain or card is never loaded, and one for the same is loaded without
running ``nvcc``. Enabling the cache after this process loaded the library
copies the loaded file there, so the next process finds it.
"""

from __future__ import annotations

import os
import shutil
import threading

from ..ops import _cuda

__all__ = ["enable_aot_cache", "disable_aot_cache", "aot_call"]


def _normalize_dir(path):
    if not path:
        return None
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    return path


_LOCK = threading.Lock()
_DIR: str | None = _normalize_dir(os.environ.get("BASK_TPU_AOT_CACHE"))
_cuda.set_build_dir(_DIR)


def enable_aot_cache(path: str) -> str:
    """Keep the kernel library in ``path`` (made if missing); returns the
    absolute path."""
    global _DIR
    path = _normalize_dir(path)
    with _LOCK:
        _DIR = path
        _cuda.set_build_dir(path)
        if _cuda.library.cache_info().currsize:  # loaded: copy it there
            src = _cuda.build_info["path"]
            dst = os.path.join(path, os.path.basename(src))
            if not os.path.exists(dst):
                tmp = f"{dst}.{os.getpid()}.tmp"
                shutil.copyfile(src, tmp)
                os.replace(tmp, dst)
    return path


def disable_aot_cache() -> None:
    """Back to the package's own build directory, ``bask_tpu_torch/_build/``."""
    global _DIR
    with _LOCK:
        _DIR = None
        _cuda.set_build_dir(None)


def aot_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``. JAX routes its jitted programs through a
    serialized executable here; a PyTorch function has no executable to
    serialize (the kernels it launches come from the cached library), so
    the call is direct. Kept so that code written for the JAX package runs
    unchanged."""
    return fn(*args, **kwargs)
