"""The precision control on the card: the reference in the program's place
in float32 with TF32 matmuls fails each cell's limits, where the program
meets them, at the cell's own configuration on a short window (two
studies in the sequential loops); ``portbench/control.py`` reads both
sides over many seeds at the cell's full load."""

import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    from portbench import common, core

    bench = core.benchmark()
    entry = core.cell(bench, cell)
    cfg, mix = core.config(bench, entry["config"]), core.traffic(entry["traffic"])
    if mix["loop"] == "seq_loop":
        mix["studies"] = 2
    loop = core.loop(mix["loop"])
    out = loop.run(common.Run(cell, cfg, mix, 2147483921, 3.0, card, None, 1.0))
    limits = core.limits(cell)
    numbers = loop.numbers
    program = numbers(out["records"], cfg, mix, "program", card)
    control = numbers(out["records"], cfg, mix, "tf32", card)
    assert all(program[k] <= limits[k] for k in limits), program
    assert not all(control[k] <= limits[k] for k in limits), control
