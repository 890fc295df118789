"""The PyTorch port's example scripts (``examples/torch_*.py``) on the CPU.

Each runs with ``--cpu`` at a small size through its ``main`` and prints
its summary; one runs as a script, as a user starts it. Without ``--cpu``
on a machine with no CUDA card each raises before any work (no fallback to
the CPU). None imports JAX or the JAX package. On the card they run in
``chip_smoke.py`` phase 14 (c) at their default sizes (the searchcv
example needs scikit-learn, which the card's machine lacks)."""

import ast
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("production_loop", "optimize_1d", "fit_gp", "large_n_mesh", "searchcv_svc")


def _path(name):
    return os.path.join(ROOT, "examples", f"torch_{name}.py")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", _path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def aot_dir_restored():
    """The production loop enables a library cache; put the previous one back."""
    from bask_tpu_torch.utils import aot

    before = aot._DIR
    yield
    if before is None:
        aot.disable_aot_cache()
    else:
        aot.enable_aot_cache(before)


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_production_loop(capsys, monkeypatch, tmp_path, aot_dir_restored):
    monkeypatch.setenv("BASK_TPU_AOT_CACHE", str(tmp_path / "aot"))
    assert _load("production_loop").main(["--cpu", "--iters", "6"]) == 0
    out = _lines(capsys)
    assert out[0] == f"kernel library cache: {tmp_path / 'aot'}"
    assert any(line.startswith("warmup (buckets [64]): ") for line in out)
    summary = [line for line in out if line.startswith("6 iterations: ")]
    assert len(summary) == 1
    assert "median warm iteration" in summary[0] and "best y=" in summary[0]
    assert np.isfinite(float(summary[0].split("best y=")[1].split()[0]))


def test_optimize_1d(capsys):
    assert _load("optimize_1d").main(["--cpu", "--iters", "7"]) == 0
    out = _lines(capsys)
    assert out[0].startswith("7 ask/tell iterations: ")
    best = float(out[1].split("y=")[1])
    assert best < 0.0  # the objective's values run from about -1.5 to 1
    assert any(line.startswith("95% HDI for the optimum location: ") for line in out)


def test_fit_gp(capsys):
    assert _load("fit_gp").main(["--cpu", "--burnin", "10"]) == 0
    out = _lines(capsys)
    assert out[1].startswith("chain: (100, 3), acceptance ")
    preds = [line for line in out if line.startswith("  x=")]
    assert len(preds) == 11


def test_large_n_mesh_as_a_script():
    """Started as a user starts it: a fresh process, exit status 0; the
    row-sharded LML equals the single-device one at float64."""
    run = subprocess.run([sys.executable, _path("large_n_mesh"), "--cpu", "--n", "200"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    out = run.stdout.splitlines()
    assert out[0] == "mesh: 4 x cpu, axis 'rows'"
    assert float(out[1].split("|diff| ")[1].rstrip(")")) < 1e-9
    assert out[-1].startswith("sample_y: draws shape (16, 5), spread ")


def test_searchcv_svc(capsys):
    pytest.importorskip("sklearn")
    assert _load("searchcv_svc").main(["--cpu", "--iters", "5"]) == 0
    out = _lines(capsys)
    assert out[0].startswith("5 iterations: ")
    assert 0.0 <= float(out[-1].split("test score: ")[1]) <= 1.0


@pytest.mark.parametrize("name", EXAMPLES)
def test_no_card_and_no_cpu_flag_raises(name, monkeypatch, tmp_path, aot_dir_restored):
    """Run without ``--cpu``: on a machine with no card the example raises
    before it computes anything, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BASK_TPU_AOT_CACHE", str(tmp_path / "aot"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _load(name).main([])


@pytest.mark.parametrize("name", EXAMPLES)
def test_imports_no_jax(name):
    """No ``jax`` and no JAX package (``bask_tpu``, ``bask``) import; the
    port's package is the only one of the repo's."""
    tree = ast.parse(open(_path(name)).read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert "bask_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "bask_tpu", "bask"}, tops
    assert "jax" not in open(_path(name)).read().replace("JAX", "")
