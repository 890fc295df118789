"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the command refuses to run without a card."""

import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.parametrize("modules,found", [
    (["bask_tpu_torch", "bask_tpu_torch.ops.gram", "portbench.core"], []),
    (["bask_tpu.ops.kernels"], ["bask_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["bask.optimizer", "benchmarks.bench_gram_wb", "flax"], ["bask", "benchmarks", "flax"]),
    (["jax_tools", "baskets", "benchmarks_torch"], []),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    from portbench import core

    assert core.forbidden_loaded(modules) == found


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted(m.split('.')[0] for m in sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    from portbench import core

    loaded = _modules_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import bask_tpu_torch, bask_tpu_torch.optimizer\n"
        "from portbench import core, common, checks, control, faults\n"
        "from portbench.loops import seq_loop, batch_ask, fit_loop\n"
        "from portbench.reference import gp, warp\n"
        "bench = core.benchmark()\n"
        "[core.metric_reader(m['name']) for m in bench['per_layer']]\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('r', 'portbench/run.py'); u.module_from_spec(s)")
    assert core.forbidden_loaded(loaded) == []


def test_reference_imports_nothing_of_the_program():
    loaded = _modules_after("import sys; sys.path.insert(0, '.')\n"
                            "from portbench.reference import gp, priors, warp")
    assert not {"bask_tpu_torch", "bask_tpu", "bask", "jax"} & loaded


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ns15d.seq_pvrs",
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True)
    if proc.returncode == 0:
        pytest.skip("this machine has a card")
    assert proc.returncode == 2 and "{" not in proc.stdout
