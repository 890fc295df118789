"""The port's tracing (``bask_tpu_torch/utils/trace.py``) on the CPU: off
by default and then free of clocks and allocations; on, the tree of spans
of a tell with one id per tell, ask or fit, self and waited time, one
wait per wrapped readback, ``last_timings_`` on the spans' own readings,
no synchronize, the profiler's ranges only inside a profiler session, and
``reset`` leaving the chain's and the kernels' counts to their owners."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu_torch import BayesGPR, Optimizer  # noqa: E402
from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.ops import gram  # noqa: E402
from bask_tpu_torch.ops import kernels as bk  # noqa: E402
from bask_tpu_torch.parallel import mcmc  # noqa: E402
from bask_tpu_torch.utils import median, trace  # noqa: E402

from torch_graph_stand_in import stand_in_graphs  # noqa: E402,F401

PACKAGE = Path(__file__).resolve().parents[1] / "bask_tpu_torch"


@pytest.fixture
def traced():
    """Tracing on for the test, off and empty after it."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _optimizer(acq_func="pvrs"):
    opt = Optimizer(dimensions=[(0.0, 1.0), (0.0, 1.0)], n_points=30, n_initial_points=6,
                    init_strategy="random", random_state=3, device="cpu", dtype=torch.float64,
                    acq_func=acq_func,
                    gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 8})
    X = np.random.RandomState(1).uniform(size=(6, 2))
    return opt, X, ((X - 0.4) ** 2).sum(1)


def _tell(opt, x, y):
    return opt.tell(x, y, n_samples=2, gp_samples=16, gp_burnin=2)


def _two_tells():
    """A cold tell and a warm one, then an ask, all traced; the records."""
    opt, X, y = _optimizer()
    _tell(opt, X.tolist(), y.tolist())
    trace.reset()
    _tell(opt, [0.3, 0.6], 0.05)
    opt.ask()
    return opt, trace.snapshot(records=True)


def _children(rec, records):
    return [r for r in records if r["parent"] == rec["name"] and r["id"] == rec["id"]
            and rec["start_ns"] <= r["start_ns"] and r["end_ns"] <= rec["end_ns"]]


def _ancestry(rec, records):
    """The names of the spans ``rec`` opened in, innermost first."""
    names = []
    while rec["parent"] is not None:
        rec = next(r for r in records if r["name"] == rec["parent"] and r["id"] == rec["id"]
                   and r["start_ns"] <= rec["start_ns"] and rec["end_ns"] <= r["end_ns"])
        names.append(rec["name"])
    return names


def test_off_by_default_records_nothing():
    assert not trace.enabled()
    assert trace.span("span.opt.tell") is trace.NOOP
    assert trace.wait() is trace.NOOP
    assert trace.span("span.opt.refit", 5) is trace.NOOP
    opt = Optimizer(dimensions=[(0.0, 1.0), (0.0, 1.0)], n_points=20, n_initial_points=3,
                    init_strategy="random", random_state=0, device="cpu", dtype=torch.float64,
                    gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 8})
    opt.run(lambda x: float(np.sum(np.square(np.asarray(x) - 0.4))), n_iter=4, n_samples=2,
            gp_samples=16, gp_burnin=2)
    snap = trace.snapshot(records=True)
    assert snap["spans"] == {} and snap["records"] == []
    assert not trace.enabled()


def test_a_tell_records_its_tree_under_one_id(traced):
    _, snap = _two_tells()
    recs = snap["records"]
    tell = [r for r in recs if r["name"] == "span.opt.tell"]
    ask = [r for r in recs if r["name"] == "span.opt.ask"]
    assert len(tell) == 1 and len(ask) == 1
    assert tell[0]["parent"] is None and ask[0]["parent"] is None
    assert tell[0]["id"] != ask[0]["id"]
    of_tell = [r for r in recs if r["id"] == tell[0]["id"]]
    assert len(of_tell) == len(recs) - 1  # all but the ask
    expected = {
        "span.opt.refit": ["span.opt.tell"],
        "span.gp.stage": ["span.opt.refit", "span.opt.tell"],
        "span.mcmc.run": ["span.opt.refit", "span.opt.tell"],
        "span.gp.consensus": ["span.opt.refit", "span.opt.tell"],
        "span.opt.acquisition": ["span.opt.tell"],
        "span.opt.grid": ["span.opt.acquisition", "span.opt.tell"],
        "span.acq.fused": ["span.opt.acquisition", "span.opt.tell"],
        "span.acq.probes": ["span.acq.fused", "span.opt.acquisition", "span.opt.tell"],
    }
    for name, ancestry in expected.items():
        (rec,) = [r for r in of_tell if r["name"] == name]
        assert _ancestry(rec, recs) == ancestry, name
    refit = next(r for r in of_tell if r["name"] == "span.opt.refit")
    acq = next(r for r in of_tell if r["name"] == "span.opt.acquisition")
    assert refit["end_ns"] <= acq["start_ns"]
    # self time: each name's total less its records' direct children
    for name, total in snap["spans"].items():
        mine = [r for r in recs if r["name"] == name]
        took = sum(r["end_ns"] - r["start_ns"] for r in mine)
        kids = sum(c["end_ns"] - c["start_ns"] for r in mine for c in _children(r, recs))
        assert total["count"] == len(mine)
        assert total["seconds"] == pytest.approx(took / 1e9, rel=1e-12, abs=1e-12)
        assert total["self_seconds"] == pytest.approx((took - kids) / 1e9, rel=1e-9, abs=1e-12)
    # waited time: every wait beneath the span, all of its own
    waits = [r for r in recs if r["name"] == "span.wait"]
    assert snap["spans"]["span.wait"]["count"] == len(waits) >= 5
    waited = sum(w["end_ns"] - w["start_ns"] for w in waits
                 if "span.opt.refit" in _ancestry(w, recs))
    assert snap["spans"]["span.opt.refit"]["wait_seconds"] == pytest.approx(waited / 1e9,
                                                                             abs=1e-12)
    assert snap["spans"]["span.wait"]["wait_seconds"] == snap["spans"]["span.wait"]["seconds"]


def test_a_fit_outside_a_tell_is_a_root_with_its_own_id(traced):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(12, 2))
    ids = []
    for seed in (0, 1):
        gp = BayesGPR(bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3, 0.3), (0.05, 2.0)),
                      random_state=seed, device="cpu", dtype=torch.float64)
        gp.fit(X, np.sin(3 * X[:, 0]), n_desired_samples=16, n_burnin=2,
               n_walkers_per_thread=8, progress=False)
    recs = trace.snapshot(records=True)["records"]
    for fit in (r for r in recs if r["name"] == "span.gp.fit"):
        assert fit["parent"] is None
        ids.append(fit["id"])
        mine = {r["name"] for r in recs if r["id"] == fit["id"]}
        assert {"span.gp.ml2", "span.gp.stage", "span.mcmc.run", "span.gp.consensus",
                "span.wait"} <= mine
    assert len(set(ids)) == 2
    snap = trace.snapshot()
    objectives = [r for r in recs if r["name"] == "span.gp.objective"]
    assert snap["spans"]["span.gp.objective"]["count"] == len(objectives) >= 2
    assert all(_ancestry(r, recs)[:2] == ["span.gp.ml2", "span.gp.fit"] for r in objectives)


def _median_readback():
    X = torch.as_tensor(np.random.RandomState(0).randn(40, 3))
    median.geometric_median(X, max_iter=26)  # one stop check, at the 25th iteration


def _lml_readback():
    gp = BayesGPR(bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,), (0.05, 2.0)),
                  random_state=0, device="cpu", dtype=torch.float64)
    gp._spec = gp._user_kernel
    X = np.linspace(0, 1, 9)[:, None]
    gp._set_data(X, np.sin(4 * X[:, 0]), None)
    theta = gp._tensor(gp._spec.theta0)
    trace.reset()
    tbg._log_post_value_grad(gp._data, theta, gp._spec, (), 0)


def _chain_readbacks():
    gp = BayesGPR(bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,), (0.05, 2.0)),
                  random_state=0, device="cpu", dtype=torch.float64, optimizer=None)
    X = np.linspace(0, 1, 9)[:, None]
    gp.fit(X, np.sin(4 * X[:, 0]), n_desired_samples=16, n_burnin=0,
           n_walkers_per_thread=8, progress=False)
    trace.reset()
    gp.sample(n_desired_samples=16, n_walkers_per_thread=8, _consensus=False)


def _pvrs_readback():
    opt, X, y = _optimizer()
    _tell(opt, X.tolist(), y.tolist())
    trace.reset()
    tacq.PVRS()(np.random.RandomState(2).uniform(size=(10, 2)), opt.gp, random_state=1)


@pytest.mark.parametrize("readback, waits", [
    (_median_readback, 1),  # the median's stop check
    (_lml_readback, 1),  # ML-II's value and gradient
    # the start's upload; the kept steps, the walkers' positions, the accepted count
    (_chain_readbacks, 4),
    # the grid's and theta's uploads, the noise-free theta, eigh, the values
    (_pvrs_readback, 5),
])
def test_each_wrapped_readback_counts_one_wait(traced, readback, waits):
    readback()
    snap = trace.snapshot(records=True)
    assert snap["spans"]["span.wait"]["count"] == waits
    assert [r["name"] for r in snap["records"]].count("span.wait") == waits


def test_median_spans_open_only_on_a_graphed_call(traced, stand_in_graphs):
    """An eager CPU median opens neither median span, however often its key
    comes; through the graph path (a stand-in capture whose replay runs the
    block eagerly) the key's second call opens one capture, and each replayed
    call one replay with the eager loop's single stop check (max_iter 26)."""
    X = torch.as_tensor(np.random.RandomState(0).randn(40, 3))
    for _ in range(3):
        median.geometric_median(X, max_iter=26)
    spans = trace.snapshot()["spans"]
    assert spans["span.wait"]["count"] == 3
    assert not {"span.gp.median_capture", "span.gp.median_replay"} & set(spans)

    counts = []
    for _ in range(3):
        trace.reset()
        median._graphed(X, 1e-5, 26)
        spans = trace.snapshot()["spans"]
        counts.append(tuple(spans.get(n, {"count": 0})["count"] for n in (
            "span.gp.median_capture", "span.gp.median_replay", "span.wait")))
    assert counts == [(0, 0, 1), (1, 1, 1), (0, 1, 1)]


def test_last_timings_are_the_spans_readings(traced):
    opt, snap = _two_tells()
    recs = snap["records"]
    tell_id = next(r["id"] for r in recs if r["name"] == "span.opt.tell")
    for key, name in (("gp_fit_s", "span.opt.refit"), ("acquisition_s", "span.opt.acquisition")):
        (rec,) = [r for r in recs if r["name"] == name and r["id"] == tell_id]
        assert opt.last_timings_[key] == (rec["end_ns"] - rec["start_ns"]) / 1e9
    refit = next(r for r in recs if r["name"] == "span.opt.refit")
    acq = next(r for r in recs if r["name"] == "span.opt.acquisition")
    assert refit["end_ns"] == acq["start_ns"]


def test_last_timings_with_tracing_off():
    opt, X, y = _optimizer(acq_func="ei")
    _tell(opt, X.tolist(), y.tolist())
    t = opt.last_timings_
    assert set(t) == {"gp_fit_s", "acquisition_s", "mcmc_acceptance"}
    assert t["gp_fit_s"] > 0 and t["acquisition_s"] > 0
    assert trace.snapshot()["spans"] == {}


@pytest.mark.parametrize("acq_func", ["pvrs", "ei"])
def test_tracing_never_synchronizes(traced, monkeypatch, acq_func):
    def refuse(*args, **kwargs):
        raise AssertionError("tracing synchronized the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    opt, X, y = _optimizer(acq_func)
    _tell(opt, X.tolist(), y.tolist())
    _tell(opt, [0.2, 0.2], 0.1)
    assert trace.snapshot()["spans"]["span.opt.tell"]["count"] == 2


@pytest.mark.parametrize("on", [True, False])
def test_profiler_ranges_only_inside_a_session(traced, monkeypatch, on):
    """Inside a profiler session the spans are on its timeline, with
    tracing on or off (then recording nothing else); outside one no range
    is opened."""
    from torch.profiler import ProfilerActivity, profile

    opt, X, y = _optimizer()
    _tell(opt, X.tolist(), y.tolist())
    if not on:
        trace.disable()
        trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tell(opt, [0.3, 0.6], 0.05)
    names = {e.name for e in prof.events()}
    assert {"span.opt.tell", "span.opt.refit", "span.mcmc.run", "span.gp.consensus",
            "span.opt.acquisition", "span.acq.fused", "span.wait"} <= names
    assert bool(trace.snapshot()["spans"]) == on

    entered = []
    real = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _tell(opt, [0.7, 0.1], 0.2)
    assert entered == []


def test_reset_leaves_the_owners_counts(traced, monkeypatch):
    monkeypatch.setitem(mcmc.graph_stats, "captures", 7)
    monkeypatch.setitem(mcmc.graph_stats, "replays", 77)
    monkeypatch.setattr(gram.fused_masked_gram_wb_batch, "launches", 11, raising=False)
    with trace.span("span.opt.tell"):
        with trace.wait():
            pass
    before = trace.snapshot()
    assert set(before["spans"]) == {"span.opt.tell", "span.wait"}
    assert set(before) == {"names", "spans"}  # no copy of the owners' counts
    trace.reset()
    after = trace.snapshot(records=True)
    assert after["spans"] == {} and after["records"] == []
    assert mcmc.graph_stats == {"captures": 7, "replays": 77}
    assert gram.fused_masked_gram_wb_batch.launches == 11


def test_every_span_the_package_opens_is_named():
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        opened |= set(re.findall(r'trace\.span\("([^"]+)"', path.read_text()))
    assert opened and opened <= set(trace.NAMES)
    assert all(re.fullmatch(r"span\.[a-z]+\.[a-z0-9_]+", n) for n in opened)
    assert set(trace.NAMES) - opened == {"span.wait"}


def test_the_ring_keeps_the_last_records(traced):
    for _ in range(trace.RING + 10):
        with trace.span("span.opt.ask"):
            pass
    snap = trace.snapshot(records=True)
    assert len(snap["records"]) == trace.RING
    assert snap["spans"]["span.opt.ask"]["count"] == trace.RING + 10
    ids = [r["id"] for r in snap["records"]]
    assert ids == sorted(ids) and len(set(ids)) == trace.RING


def _warped_two_tells():
    """:func:`_two_tells` on a model with ``warp_inputs``."""
    opt = Optimizer(dimensions=[(0.0, 1.0), (0.0, 1.0)], n_points=30, n_initial_points=6,
                    init_strategy="random", random_state=3, device="cpu", dtype=torch.float64,
                    gp_kwargs={"warp_inputs": True},
                    gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 16})
    X = np.random.RandomState(1).uniform(size=(6, 2))
    _tell(opt, X.tolist(), ((X - 0.4) ** 2).sum(1).tolist())
    trace.reset()
    _tell(opt, [0.3, 0.6], 0.05)
    opt.ask()
    return opt, trace.snapshot(records=True)


def test_a_warped_tell_opens_the_warp_spans(traced):
    """The consensus warps the posterior's data and PVRS the candidates
    (``span.gp.warp``); the grid's inverse warp (``span.gp.unwarp``) sits
    in ``span.opt.grid`` and waits once more, for its readback."""
    _, snap = _warped_two_tells()
    recs = snap["records"]
    warps = [_ancestry(r, recs) for r in recs if r["name"] == "span.gp.warp"]
    assert sorted(a[0] for a in warps) == ["span.acq.fused", "span.gp.consensus"]
    (unwarp,) = [r for r in recs if r["name"] == "span.gp.unwarp"]
    assert _ancestry(unwarp, recs) == ["span.opt.grid", "span.opt.acquisition", "span.opt.tell"]
    # the grid's upload and its readback
    assert [r["name"] for r in _children(unwarp, recs)] == ["span.wait"] * 2


def test_an_unwarped_tell_opens_neither_warp_span_and_waits_as_before(traced):
    _, snap = _two_tells()
    assert not {"span.gp.warp", "span.gp.unwarp"} & set(snap["spans"])
    assert snap["spans"]["span.wait"]["count"] == 18  # as before the warp spans existed
    gp = BayesGPR(bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,), (0.05, 2.0)),
                  device="cpu", dtype=torch.float64)
    Z = np.random.RandomState(0).uniform(size=(5, 1))
    Zt = torch.from_numpy(Z)
    trace.reset()
    assert gp.unwarp(Z) is Z and gp._warp_tensor(Zt) is Zt
    assert trace.snapshot()["spans"] == {}


def test_the_unwarp_readback_counts_one_wait(traced):
    opt, _ = _warped_two_tells()
    Z = np.random.RandomState(2).uniform(size=(10, 2))
    trace.reset()
    back = opt.gp.unwarp(Z)
    snap = trace.snapshot(records=True)
    # the warp's two log-parameters, then inside the span the grid's upload and the readback
    assert [r["name"] for r in snap["records"]] == ["span.wait"] * 4 + ["span.gp.unwarp"]
    assert [r["parent"] for r in snap["records"]] == [None] * 2 + ["span.gp.unwarp"] * 2 + [None]
    assert snap["spans"]["span.gp.unwarp"]["wait_seconds"] > 0
    np.testing.assert_allclose(opt.gp.warp(back), Z, atol=1e-12)
