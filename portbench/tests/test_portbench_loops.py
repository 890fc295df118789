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


OPTIONS = [("gp_kwargs", "warp_inputs", True), ("optimizer_kwargs", "acq_polish", 2),
           ("kernel", "nu", 1.7)]


@pytest.mark.parametrize("loop", [None, "seq_loop", "fit_loop", "batch_ask"])
@pytest.mark.parametrize("option", OPTIONS)
def test_an_option_the_reference_does_not_model_is_refused(option, loop):
    """Under the shared set alone and under each loop's ``MODELS``, but
    the warp under the batch ask's, which models it."""
    from portbench import checks, core
    from conftest import tiny

    cfg, _ = tiny("ns15d.fit")
    group, key, value = option
    cfg[group][key] = value
    models = core.loop(loop).MODELS if loop else None
    if loop == "batch_ask" and key == "warp_inputs":
        checks.modelled(cfg, models)
        return
    with pytest.raises(ValueError, match="does not model"):
        checks.modelled(cfg, models)


@pytest.mark.parametrize("models,option", [
    ({"gp_kwargs": {"warp_inputs"}}, ("gp_kwargs", "warp_inputs", True)),
    ({"kernel": {"nu"}}, ("kernel", "nu", 1.7)),
])
def test_a_new_loop_that_models_an_option_accepts_it(models, option):
    """A loop file that names an option in its ``MODELS`` takes a
    configuration with it; the same configuration stays refused where no
    loop names it."""
    from portbench import checks
    from conftest import tiny

    cfg, _ = tiny("ns15d.fit")
    group, key, value = option
    cfg[group][key] = value
    checks.modelled(cfg, models)
    with pytest.raises(ValueError, match="does not model"):
        checks.modelled(cfg, {})


# each mix at the CPU's size, as the tests have always run it: (config keys, mix keys)
TINY = {
    "ns15d.seq_pvrs": ({"d": 3, "walkers": 16, "n": 40, "n_points": 50},
                       {"studies": 2, "n_start": 30, "reload_at": 34, "cold_extensions": 0}),
    "ns15d.seq_ei": ({"d": 3, "walkers": 16, "n": 40, "n_points": 50},
                     {"studies": 2, "n_start": 30, "reload_at": 34, "cold_extensions": 0}),
    "ns15d.fit": ({"d": 3, "walkers": 16, "n": 40, "n_points": 50}, {"steps": 20, "burnin": 10}),
    "batch15d.ask": ({"d": 3, "walkers": 16, "n": 40, "n_points": 4096},
                     {"batch": 8, "check_draws": 2}),
    "batch15d_warp.ask": ({"d": 3, "walkers": 16, "n": 40, "n_points": 4096},
                          {"batch": 8, "check_draws": 2}),
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_sizes_a_mix_by_its_keys(cell):
    """The size each mix has always had on the CPU, whatever its loop's
    name; the other keys of the configuration and the mix as in their
    files."""
    from portbench import core
    from conftest import cell_entry, tiny

    entry, full = cell_entry(cell)
    cfg, mix = tiny(cell)
    want_cfg, want_mix = TINY[cell]
    assert {k: cfg[k] for k in ("d", "walkers", "n")} == {k: want_cfg[k] for k in ("d", "walkers", "n")}
    assert cfg["optimizer_kwargs"]["n_points"] == want_cfg["n_points"]
    assert {k: v for k, v in cfg.items() if k not in ("d", "walkers", "n", "optimizer_kwargs")} == {
        k: v for k, v in full.items() if k not in ("d", "walkers", "n", "optimizer_kwargs")}
    assert mix == {**core.traffic(entry["traffic"]), **want_mix}
