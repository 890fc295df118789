"""The reader of ``median_replays.seq`` on profiled stretches made of known
events: the share of consensuses that replayed and captured nothing; no
reading where the program opens no replay (a program that runs the median
eagerly) or has no tracing module; the cells that list it."""

import sys
import types

import pytest

from portbench import core

NAME = "median_replays.seq"


def _event(name, start, end):
    return types.SimpleNamespace(name=name, device_type=types.SimpleNamespace(name="CPU"),
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Tracer:
    def __init__(self, events):
        self.events, self.spans, self.counts = events, {}, {"chain_steps": 22}
        self.launches = []
        self.profiled = True

    def profiled_events(self):
        return self.events, 0.0, 1000.0


def _trace(ranges, units=4):
    events = [_event("portbench.stretch", 0.0, 1000.0)]
    events += [_event(n, a, b) for n, a, b in ranges]
    return core.Trace(_Tracer(events), units, {"d": 15}, {"trace_units": units})


# two iterations: each consensus replays, the second twice
RANGES = [
    ("span.opt.tell", 0, 400), ("span.gp.consensus", 300, 390),
    ("span.gp.median_replay", 301, 305), ("span.wait", 306, 310),
    ("span.opt.tell", 500, 900), ("span.gp.consensus", 800, 890),
    ("span.gp.median_replay", 801, 805), ("span.wait", 806, 810),
    ("span.gp.median_replay", 811, 815), ("span.wait", 816, 820),
]


def test_every_consensus_replays():
    assert core.metric_reader(NAME)(_trace(RANGES, units=2)) == 1.0


@pytest.mark.parametrize("second", [
    # the key seen anew: the median captures again before it replays
    [("span.gp.median_capture", 801, 809), ("span.gp.median_replay", 811, 815)],
    # the key's first call: eager, no replay
    [("span.wait", 806, 810)],
])
def test_a_capture_or_an_eager_median_lowers_the_share(second):
    ranges = RANGES[:4] + [("span.opt.tell", 500, 900), ("span.gp.consensus", 800, 890)] + second
    assert core.metric_reader(NAME)(_trace(ranges, units=2)) == 0.5


def test_an_eager_median_gives_no_reading():
    eager = [r for r in RANGES if r[0] != "span.gp.median_replay"]
    assert core.metric_reader(NAME)(_trace(eager, units=2)) is None


def test_a_program_without_tracing_gives_no_reading(monkeypatch):
    import bask_tpu_torch.utils

    monkeypatch.delattr(bask_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "bask_tpu_torch.utils.trace", None)
    assert core.metric_reader(NAME)(_trace(RANGES, units=2)) is None


@pytest.mark.parametrize("cell", ["ns15d.seq_pvrs", "ns15d.seq_ei", "ns15d_warp.seq_pvrs"])
def test_the_seq_cells_report_it(cell):
    reported = {m["name"] for m in core.cell_metrics(core.benchmark(), "per_layer", cell)}
    assert NAME in reported
