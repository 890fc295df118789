"""The traced run's readers and breakdown, on a profiled stretch made of
known events, and a traced tiny run on the CPU up to its kernel readers."""

import types

import pytest

from portbench import core


def _event(name, start, end, cuda):
    kind = types.SimpleNamespace(name="CUDA" if cuda else "CPU")
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Tracer:
    def __init__(self, events, spans, counts, launches):
        self.events, self.spans, self.counts = events, spans, counts
        self.launches = launches
        self.profiled = True

    def profiled_events(self):
        return self.events, 0.0, 1000.0


def _k4(B, n_pad, captured=False, profiled=True):
    return dict(kernel="K4", B=B, n_pad=n_pad, d=15, captured=captured, window=not captured,
                profiled=profiled and not captured)


K4_NOTES = [_k4(50, 448, captured=True), _k4(50, 512, captured=True), _k4(100, 512)]


def _trace(units=2, kernels=(("gram_wb_kernel<1>", 100, 150), ("chol_inv_kernel", 150, 180),
                             ("gram_wb_kernel<1>", 600, 640)), launches=K4_NOTES):
    events = [_event("portbench.stretch", 0.0, 1000.0, False),
              _event("span.refit", 50.0, 700.0, False),
              # the profiler mirrors the spans on the device's timeline: no device work
              _event("portbench.stretch", 0.0, 1000.0, True),
              _event("span.refit", 50.0, 700.0, True)]
    events += [_event(n, a, b, True) for n, a, b in kernels]
    spans = {"span.refit": (0.5, units), "span.grid": (0.01, units),
             "span.acquisition": (0.1, units), "span.chain": (0.3, 1)}
    cfg = {"walkers": 100, "d": 15, "n": 1000, "optimizer_kwargs": {"n_points": 65536}}
    return core.Trace(_Tracer(events, spans, {"chain_steps": 300}, launches), units, cfg,
                      {"steps": 300, "batch": 256})


def test_device_shares_and_breakdown():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(120e-6)
    assert tr.idle_pct() == pytest.approx(88.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gram_wb_kernel<1>", pytest.approx(90e-6)]
    assert bd["idle_gaps"][0] == ["span.refit", pytest.approx(420e-6)]
    assert bd["idle_gaps"][1] == ["outside any span", pytest.approx(360e-6)]


def test_seq_readers():
    tr = _trace()
    read = core.metric_reader
    assert read("refit_ms.seq")(tr) == pytest.approx(250.0)
    assert read("acq_ms.seq")(tr) == pytest.approx(55.0)
    assert read("k4_roofline_pct.seq")(tr) == pytest.approx(100 * 15.661 / 45.0, rel=1e-3)
    assert read("device_idle_pct.seq")(tr) == pytest.approx(88.0)


def test_a_trace_without_the_cells_kernels_gives_no_share():
    tr = _trace(kernels=(("elementwise_kernel", 10, 20),))
    with pytest.raises(RuntimeError, match="recorded no"):
        core.metric_reader("k4_roofline_pct.seq")(tr)
    with pytest.raises(RuntimeError, match="recorded no"):
        core.metric_reader("device_idle_pct.ask")(tr)


def test_k4_reader_needs_one_chain_shape_for_the_stretchs_bucket():
    with pytest.raises(RuntimeError, match="not of one shape"):
        core.metric_reader("k4_roofline_pct.seq")(_trace(launches=K4_NOTES[:1] + K4_NOTES[2:]))
    two = K4_NOTES + [_k4(25, 512, captured=True)]
    with pytest.raises(RuntimeError, match="not of one shape"):
        core.metric_reader("k4_roofline_pct.seq")(_trace(launches=two))


def _k5(query):
    return dict(kernel="K5", B=256, m=65536 if query else 1024, M=1024, d=15, R=1,
                n=1000 if query else 0, n_pad=1024 if query else 0, query=query,
                captured=False, window=True, profiled=True)


def test_k5_reader_takes_each_query_launch_at_its_own_shape():
    kernels = (("pathwise_mma_kernel", 0, 20), ("pathwise_mma_kernel", 20, 500),
               ("pathwise_mma_kernel", 500, 520), ("pathwise_mma_kernel", 520, 1000))
    tr = _trace(kernels=kernels, launches=[_k5(False), _k5(True), _k5(False), _k5(True)])
    # 480 us and 480 us query launches against the 3.029 ms bound
    assert core.metric_reader("k5_roofline_pct.ask")(tr) == pytest.approx(
        100 * 3028.9 / 480.0, rel=1e-3)
    tr = _trace(kernels=kernels, launches=[_k5(False), _k5(True)])
    with pytest.raises(RuntimeError, match="noted calls"):
        core.metric_reader("k5_roofline_pct.ask")(tr)


def _k6(n):
    return dict(kernel="K6", B=256, n=n, d=15, shared=True, pdf=False, itemsize=4,
                captured=False, window=True, profiled=True)


K7_NOTE = dict(kernel="K7", n=65536, d=15, n_iter=60, itemsize=4, captured=False, window=True,
               profiled=True)
WARPS = (("void unwarp_kernel<float, 2>(float const*)", 0, 180),
         ("void warp_kernel<float, 4>(float const*)", 180, 200),
         ("void warp_kernel<float, 4>(float const*)", 200, 900))


def test_k6_and_k7_readers_take_the_grid_launches():
    tr = _trace(kernels=WARPS, launches=[K7_NOTE, _k6(1024), _k6(65536)])
    # the grid's K6 launch, 700 us against 608.5 us; K7's 180 us against 143.5 us
    assert core.metric_reader("k6_roofline_pct.ask")(tr) == pytest.approx(
        100 * 608.487 / 700.0, rel=1e-4)
    assert core.metric_reader("k7_roofline_pct.ask")(tr) == pytest.approx(
        100 * 143.524 / 180.0, rel=1e-4)


def test_warp_readers_read_nothing_in_an_unwarped_ask_and_check_their_counts():
    tr = _trace(kernels=(("pathwise_mma_kernel", 0, 20),), launches=[_k5(True)])
    assert core.metric_reader("k6_roofline_pct.ask")(tr) is None
    assert core.metric_reader("k7_roofline_pct.ask")(tr) is None
    tr = _trace(kernels=WARPS, launches=[K7_NOTE, _k6(65536)])
    with pytest.raises(RuntimeError, match="noted calls"):
        core.metric_reader("k6_roofline_pct.ask")(tr)


def test_warp_notes_leave_the_launch_counters_in_place(monkeypatch):
    """The notes sit on the launchers, so the program's counters, which
    are attributes of its entry functions, stay where it updates them."""
    import contextlib

    import torch

    from bask_tpu_torch.ops import warp_values
    from portbench import common

    monkeypatch.setattr(warp_values, "_launch_warp", lambda X, la, lb, with_pdf=False: X)
    monkeypatch.setattr(warp_values, "_launch_unwarp", lambda Z, la, lb, n_iter=60: Z)
    tracer = core.Tracer(torch)
    with contextlib.ExitStack() as stack:
        common.note_warps(stack, tracer)
        warp_values._launch_warp(torch.rand(64, 3), torch.zeros(8, 3), torch.zeros(8, 3))
        warp_values._launch_unwarp(torch.rand(64, 3), torch.zeros(3), torch.zeros(3), 30)
    assert [(x["kernel"], x["n"], x["d"]) for x in tracer.launches] == [("K6", 64, 3),
                                                                         ("K7", 64, 3)]
    assert tracer.launches[0]["B"] == 8 and tracer.launches[1]["n_iter"] == 30
    assert hasattr(warp_values.warp_values, "launches")
    assert hasattr(warp_values.unwarp_values, "launches")


def test_chain_step_reader_checks_the_step_count():
    tr = _trace(units=1)
    assert core.metric_reader("chain_step_ms.fit")(tr) == pytest.approx(1.0)
    tr.counts["chain_steps"] = 299
    with pytest.raises(RuntimeError, match="chain steps"):
        core.metric_reader("chain_step_ms.fit")(tr)


def test_traced_tiny_run_reaches_its_kernel_readers(run_tiny):
    with pytest.raises(RuntimeError, match="recorded no"):
        run_tiny("ns15d.seq_pvrs", trace=True)
