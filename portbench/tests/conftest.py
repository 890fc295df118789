"""Shared helpers of the benchmark's own tests (CPU; a few need the card
and carry the ``cuda`` marker)."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_run_module():
    """``portbench/run.py`` as a module (it is also the command)."""
    spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# cells whose files the folder keeps while BENCHMARK.json does not list
# them (PERF.md, Open questions): their loops stay tested here
DORMANT = {"batch15d.ask": {"name": "batch15d.ask", "config": "batch15d_n1000",
                            "traffic": "ask256", "chips": 1}}


def cell_entry(cell_name):
    """(the cell's entry, its configuration), listed or dormant."""
    from portbench import core

    bench = core.benchmark()
    if cell_name in DORMANT:
        entry = DORMANT[cell_name]
        return entry, core.load_json(core.HERE / "configs" / f"{entry['config']}.json")
    entry = core.cell(bench, cell_name)
    return entry, core.config(bench, entry["config"])


def tiny(cell_name):
    """The cell's configuration and mix at a size the CPU runs in seconds:
    3 dimensions, 16 walkers, tens of points; the batch ask keeps more
    than 2,048 candidates so that it takes the pathwise draws. A mix is
    sized by its keys, whatever its loop: ``studies`` the sequential
    studies', ``batch`` the batch ask's, any other the fit's."""
    from portbench import core

    cell, cfg = cell_entry(cell_name)
    mix = core.traffic(cell["traffic"])
    cfg.update(d=3, walkers=16, n=40)
    cfg["optimizer_kwargs"]["n_points"] = 4096 if "batch" in mix else 50
    if "studies" in mix:
        mix.update(studies=2, n_start=30, reload_at=34, cold_extensions=0)
    elif "batch" in mix:
        mix.update(batch=8, check_draws=2)
    else:
        mix.update(steps=20, burnin=10)
    return cfg, mix


@pytest.fixture
def run_tiny():
    """Run a cell at :func:`tiny` size on the CPU: ``run_tiny(cell, ...)``
    gives the result line's object."""
    module = load_run_module()

    def run(cell_name, seed=2147483911, seconds=1.5, trace=False, share=0.5, side="program"):
        cfg, mix = tiny(cell_name)
        return module.run_cell(cell_name, seed, seconds, trace, "cpu", cfg=cfg, mix=mix,
                               sample_share=share, side=side, entry=cell_entry(cell_name)[0])
    return run


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
