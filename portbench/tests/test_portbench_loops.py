"""Each loop runs a few units at a tiny size on the CPU through the
test entry (``run.run_cell``), and the result keeps the last line's form."""

import json
import math

import pytest

from conftest import DORMANT, ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS += sorted(DORMANT)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_at_a_tiny_size(run_tiny, cell):
    result = run_tiny(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-2:] == ["checks", "info"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"], result["checks"]
    from portbench import core

    bench = core.benchmark()
    names = [m["name"] for m in core.cell_metrics(bench, "end_to_end", cell)]
    if cell in DORMANT:
        assert names == ["setup_s"] and set(result["metrics"]) == {"setup_s"}
        return
    assert list(result["metrics"]) == names
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] <= c["limit"]
    json.dumps({k: v for k, v in result.items() if k != "info"})


def test_the_same_seed_makes_the_same_inputs():
    from portbench import core

    assert core.seed32(2**31 + 77, 1, 2) == core.seed32(2**31 + 77, 1, 2)
    assert core.seed32(2**31 + 77, 1, 2) != core.seed32(2**31 + 78, 1, 2)
    a = core.rng(2**33 + 5, 0).uniform(size=4)
    assert (a == core.rng(2**33 + 5, 0).uniform(size=4)).all()


def test_configuration_options_reach_the_program_unchanged():
    import torch

    from portbench import common, core
    from conftest import tiny

    cfg, mix = tiny("ns15d.seq_pvrs")
    cfg["gp_kwargs"] = {"normalize_y": False}
    cfg["optimizer_kwargs"] = {"n_points": 37}
    run = common.Run("ns15d.seq_pvrs", cfg, mix, 2**31 + 5, 1.0, torch.device("cpu"))
    opt = common.optimizer(run, 10, "pvrs", {})
    assert opt.n_points == 37 and opt.gp.normalize_y is False
    assert opt.gp_sample_kwargs["n_walkers_per_thread"] == cfg["walkers"]


@pytest.mark.parametrize("option", [("gp_kwargs", "warp_inputs", True),
                                    ("optimizer_kwargs", "acq_polish", 2),
                                    ("kernel", "nu", 1.7)])
def test_an_option_the_reference_does_not_model_is_refused(option):
    from portbench import checks
    from conftest import tiny

    cfg, _ = tiny("ns15d.fit")
    group, key, value = option
    cfg[group][key] = value
    with pytest.raises(ValueError, match="does not model"):
        checks.modelled(cfg)
