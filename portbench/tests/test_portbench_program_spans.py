"""The readers of the program's own spans (``portbench/program_spans.py``
and the ``metrics/`` files that use it) on profiled stretches made of
known events: the program's ranges beside the harness's, device
operations; no reading for a program without tracing; a raise for a
stretch that misses what a reader reads; and an untraced tiny run leaves
the program's tracing off."""

import sys
import types

import pytest

from portbench import core, program_spans


def _event(name, start, end, cuda=False):
    kind = types.SimpleNamespace(name="CUDA" if cuda else "CPU")
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Tracer:
    def __init__(self, events, spans, counts):
        self.events, self.spans, self.counts = events, spans, counts
        self.launches = []
        self.profiled = True

    def profiled_events(self):
        return self.events, 0.0, 1000.0


# one seq iteration (all microseconds): a tell of 0-600 and an ask of 620-630;
# the refit 10-400 with a chain inside the harness's span.chain, three
# readbacks, the consensus with two; the acquisition 400-590 with its grid
# and fused pass, one readback
SEQ = [
    ("span.opt.tell", 0, 600), ("span.opt.refit", 10, 400), ("span.refit", 15, 398),
    ("span.gp.stage", 20, 40), ("span.chain", 40, 230), ("span.mcmc.run", 41, 170),
    ("span.mcmc.init", 45, 60), ("span.mcmc.replays", 60, 160),
    ("span.wait", 230, 250), ("span.wait", 252, 260), ("span.wait", 261, 262),
    ("span.gp.consensus", 270, 395), ("span.wait", 300, 310), ("span.wait", 380, 394),
    ("span.opt.acquisition", 400, 590), ("span.grid", 405, 455), ("span.opt.grid", 405, 455),
    ("span.acquisition", 460, 580), ("span.acq.fused", 461, 579),
    ("span.acq.probes", 470, 500), ("span.wait", 540, 578),
    ("span.opt.ask", 620, 630),
]
SEQ_DEVICE = [("gram_wb_kernel", 60, 200), ("chol_inv_kernel", 200, 250),
              ("syevj", 470, 540), ("elementwise", 700, 800)]
FIT = [
    ("span.gp.fit", 100, 900), ("span.ml2", 110, 400), ("span.gp.ml2", 110, 400),
    ("span.gp.objective", 120, 200), ("span.wait", 180, 200),
    ("span.gp.objective", 250, 300), ("span.wait", 290, 300),
    ("span.gp.stage", 400, 420), ("span.chain", 420, 800), ("span.mcmc.run", 421, 600),
    ("span.mcmc.replays", 440, 590), ("span.wait", 800, 850),
    ("span.gp.consensus", 850, 899), ("span.wait", 890, 899),
]
HARNESS = {"span.refit", "span.chain", "span.grid", "span.acquisition", "span.ml2"}
FIT_DEVICE = [("gram_wb_kernel", 150, 200), ("chol_inv_kernel", 440, 850)]


def _trace(ranges, device, units, mix, counts, chains):
    events = [_event("portbench.stretch", 0.0, 1000.0)]
    events += [_event(n, a, b) for n, a, b in ranges]
    events += [_event(n, a, b, cuda=True) for n, a, b in ranges]  # the device-side mirror
    events += [_event(n, a, b, cuda=True) for n, a, b in device]
    spans = {"span.chain": (0.5, chains)}
    return core.Trace(_Tracer(events, spans, counts), units, {"d": 15}, mix)


def _seq(ranges=SEQ, units=3, chain_steps=22, chains=2):
    return _trace(ranges, SEQ_DEVICE, units, {"trace_units": 1}, {"chain_steps": chain_steps},
                  chains)


def _fit(ranges=FIT):
    return _trace(ranges, FIT_DEVICE, 2, {"trace_units": 1, "steps": 30},
                  {"chain_steps": 60}, 2)


SEQ_READINGS = {"waits.seq": 6.0}
FIT_READINGS = {"ml2_evals.fit": 2.0}


@pytest.mark.parametrize("name, value", sorted({**SEQ_READINGS, **FIT_READINGS}.items()))
def test_each_reader_on_a_known_stretch(name, value):
    tr = _seq() if name.endswith(".seq") else _fit()
    assert core.metric_reader(name)(tr) == pytest.approx(value, rel=1e-9)


def test_the_readers_are_the_benchmarks():
    bench = core.benchmark()
    listed = {m["name"] for m in bench["per_layer"]}
    assert set(SEQ_READINGS) | set(FIT_READINGS) <= listed
    for cell, names in (("ns15d.seq_pvrs", SEQ_READINGS), ("ns15d.seq_ei", SEQ_READINGS),
                        ("ns15d.fit", FIT_READINGS)):
        reported = {m["name"] for m in core.cell_metrics(bench, "per_layer", cell)}
        assert set(names) <= reported


@pytest.mark.parametrize("name", sorted({**SEQ_READINGS, **FIT_READINGS}))
def test_a_program_without_tracing_gives_no_reading(monkeypatch, name):
    # the parent's program: no bask_tpu_torch.utils.trace, no program ranges
    import bask_tpu_torch.utils

    monkeypatch.delattr(bask_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "bask_tpu_torch.utils.trace", None)
    harness_only = [r for r in (SEQ + FIT) if r[0] in HARNESS]
    tr = _seq(harness_only) if name.endswith(".seq") else _fit(harness_only)
    assert core.metric_reader(name)(tr) is None


@pytest.mark.parametrize("name, missing", [
    ("waits.seq", "span.wait"), ("ml2_evals.fit", "span.gp.objective"),
])
def test_a_span_that_never_opened_raises(name, missing):
    if name.endswith(".seq"):
        tr = _seq([r for r in SEQ if r[0] != missing])
    else:
        tr = _fit([r for r in FIT if r[0] != missing])
    with pytest.raises(RuntimeError, match="never opened"):
        core.metric_reader(name)(tr)


@pytest.mark.parametrize("name", sorted({**SEQ_READINGS, **FIT_READINGS}))
def test_no_program_range_raises(name):
    tr = _seq([]) if name.endswith(".seq") else _fit([])
    with pytest.raises(RuntimeError, match="none of the program's spans"):
        core.metric_reader(name)(tr)


def test_breakdown_names_gaps_by_the_innermost_program_span():
    gaps = dict((round(s * 1e6), n) for n, s in _seq().breakdown()["idle_gaps"])
    assert gaps[60] == "span.gp.stage"  # 0-60, its middle in the stage
    assert gaps[220] == "span.gp.consensus"  # 250-470, its middle in the consensus
    assert gaps[160] == "span.opt.ask"  # 540-700, its middle in the ask
    assert gaps[200] == "outside any span"  # 800-1000


def test_the_harness_spans_are_not_the_programs():
    spans = program_spans.of(_seq())
    assert {r[0] for r in spans.ranges} == {r[0] for r in SEQ} - HARNESS


def test_an_untraced_run_leaves_the_programs_tracing_off(run_tiny):
    from bask_tpu_torch.utils import trace

    out = run_tiny("ns15d.fit", trace=False)
    assert out["correct"] and not trace.enabled()
    assert trace.snapshot()["spans"] == {}
