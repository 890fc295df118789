"""BENCHMARK.json against the harness's files and the contract's form."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    path = ROOT / entry["file"]
    assert entry["file"].startswith("portbench/configs/") and path.is_file()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and 1 <= len(entry["source"]) <= 200
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(cell):
    from portbench import core

    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    core.config(BENCH, cell["config"])
    mix = core.traffic(cell["traffic"])
    loop = core.loop(mix["loop"])
    assert callable(loop.run) and callable(loop.numbers)
    cfg = core.config(BENCH, cell["config"])
    from portbench import checks

    checks.modelled(cfg, loop.MODELS)
    limits = core.limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in core.cell_metrics(BENCH, "end_to_end", cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert core.cell_metrics(BENCH, "per_layer", cell["name"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form_and_reader(metric):
    from portbench import core

    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert metric["workloads"] and "\n" not in metric["layer"]
    assert callable(core.metric_reader(metric["name"]))


def test_names_are_unique():
    for key in ("configs", "workloads", "end_to_end"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
