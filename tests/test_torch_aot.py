"""``enable_aot_cache`` in the port: where the kernel library is kept, the
environment variable, the copy of a loaded library, and the library's
name, which changes with each of the nvcc version, torch's version and
CUDA version, the card's compute capability and the sources (all
monkeypatched: no nvcc or card here). ``aot_call`` calls through."""

import importlib
import json
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu_torch import disable_aot_cache, enable_aot_cache  # noqa: E402
from bask_tpu_torch.ops import _cuda  # noqa: E402
from bask_tpu_torch.utils import aot  # noqa: E402


@pytest.fixture
def toolchain(monkeypatch):
    """A fixed toolchain and card, each part replaceable by the test."""
    monkeypatch.setattr(_cuda, "_nvcc_version", lambda: "12.8.93")
    monkeypatch.setattr(torch, "__version__", "2.11.0+cu128")
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    yield monkeypatch
    disable_aot_cache()


def test_enable_and_disable_move_the_build_directory(tmp_path, toolchain):
    where = enable_aot_cache(str(tmp_path / "cache" / "."))
    assert where == str(tmp_path / "cache") and Path(where).is_dir()
    assert _cuda._build_dir == Path(where) and aot._DIR == where
    disable_aot_cache()
    assert _cuda._build_dir == _cuda._DEFAULT_BUILD and aot._DIR is None


def test_environment_variable_enables_the_cache(tmp_path, toolchain):
    toolchain.setenv("BASK_TPU_AOT_CACHE", str(tmp_path / "env"))
    try:
        importlib.reload(aot)  # read at import, as JAX's aot.py reads it
        assert _cuda._build_dir == tmp_path / "env" and (tmp_path / "env").is_dir()
    finally:
        toolchain.delenv("BASK_TPU_AOT_CACHE")
        importlib.reload(aot)
    assert _cuda._build_dir == _cuda._DEFAULT_BUILD


def test_enabling_after_a_load_copies_the_library(tmp_path, toolchain):
    built = tmp_path / "pkg" / _cuda.library_name()
    built.parent.mkdir()
    built.write_bytes(b"\x7fELF stand-in")

    class Loaded:
        @staticmethod
        def cache_info():
            return type("Info", (), {"currsize": 1})()

    toolchain.setattr(_cuda, "library", Loaded)
    toolchain.setitem(_cuda.build_info, "path", str(built))
    enable_aot_cache(str(tmp_path / "next"))
    assert (tmp_path / "next" / built.name).read_bytes() == built.read_bytes()


def test_library_name_keys_on_toolchain_card_and_sources(tmp_path, toolchain):
    base = _cuda.library_name()
    assert _cuda.library_name() == base  # the same toolchain reuses the build
    changes = {
        "nvcc": lambda m: m.setattr(_cuda, "_nvcc_version", lambda: "12.9.41"),
        "torch": lambda m: m.setattr(torch, "__version__", "2.12.0+cu128"),
        "cuda": lambda m: m.setattr(torch.version, "cuda", "12.9"),
        "capability": lambda m: m.setattr(torch.cuda, "get_device_capability",
                                          lambda *a: (10, 0)),
    }
    names = {base}
    for what, change in changes.items():
        with pytest.MonkeyPatch.context() as m:
            change(m)
            name = _cuda.library_name()
        assert name not in names, what
        names.add(name)
    assert _cuda.library_name() == base
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda._CSRC, csrc)
    toolchain.setattr(_cuda, "_CSRC", csrc)
    assert _cuda.library_name() == base
    for src in ("gram.cu", "gram_common.cuh"):
        (csrc / src).write_text((csrc / src).read_text() + "\n// edited\n")
        name = _cuda.library_name()
        assert name not in names, src
        names.add(name)


def test_nvcc_version_is_read_without_running_nvcc(tmp_path, monkeypatch):
    """From the toolkit's version.json; without one, from the nvcc
    binary's path, size and time, which change when nvcc is replaced."""
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", str(tmp_path))

    def no_process(*a, **k):
        raise AssertionError("nvcc was run")

    monkeypatch.setattr(_cuda.subprocess, "run", no_process)
    monkeypatch.setattr(_cuda.subprocess, "Popen", no_process)
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_bytes(b"nvcc 12.8")
    without_json = _cuda._nvcc_version()
    assert str(nvcc.resolve()) in without_json
    nvcc.write_bytes(b"nvcc 12.9, longer")
    assert _cuda._nvcc_version() != without_json
    (tmp_path / "version.json").write_text(
        json.dumps({"cuda": {"version": "12.8.1"}, "cuda_nvcc": {"version": "12.8.93"}}))
    assert _cuda._nvcc_version() == "12.8.93"


def test_aot_call_calls_through():
    assert aot.aot_call(lambda a, b=1: (a, b), 3, b=4) == (3, 4)
