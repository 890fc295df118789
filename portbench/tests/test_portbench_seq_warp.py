"""The warped sequential cell (``ns15d_warp.seq_pvrs``, ``loops/seq_warp.py``)
on the CPU: a tiny run comes out correct, each fault of the warped path
planted underneath it comes out not correct on its own number, the cell's
readers read a profiled stretch of known events and nothing in an unwarped
one, and its reference and loop load nothing of JAX."""

import contextlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import core

CELL = "ns15d_warp.seq_pvrs"
NUMBERS = {"lml_rel", "acq_rel", "chain_lp_rel", "stuck_share", "grid_rel"}
READERS = ("k1_roofline_pct.seq_warp", "k6_roofline_pct.seq_warp", "k7_roofline_pct.seq_warp",
           "warps.seq_warp", "device_idle_pct.seq_warp")


def test_tiny_run_is_correct_on_five_numbers(run_tiny):
    result = run_tiny(CELL)
    assert result["failed"] == 0 and result["correct"], result["checks"]
    assert set(result["checks"]) == NUMBERS == set(core.limits(CELL))
    assert result["info"]["launches"]["K7"] is not None


def test_the_loop_keeps_what_its_check_reads(run_tiny, monkeypatch):
    from portbench.loops import seq_warp

    kept = []
    numbers = seq_warp.numbers

    def spy(records, *args, **kwargs):
        kept.extend(records)
        return numbers(records, *args, **kwargs)
    monkeypatch.setattr(seq_warp, "numbers", spy)
    run_tiny(CELL, seconds=0.5)
    assert kept
    for r in kept:
        assert r["chain"].shape[1] == 5 + 2 * 3  # kernel theta, then the warp of each column
        assert r["acq_theta"].shape == (5,) and [w.shape for w in r["acq_warp"]] == [(3,), (3,)]
        assert r["uniforms"].shape == r["grid"].shape == (50, 3)


def _unwarped_chain_lml(monkeypatch):
    """The chain scores each row by the warp prior and the kernel's LML at
    the unwarped inputs."""
    from bask_tpu_torch.models import bayesgpr, warping

    original = bayesgpr._make_log_prob_batch

    def unwarped(kernel, priors, data, n_real, warp_prior=None, n_warp=0, **kwargs):
        plain = original(kernel, priors, data, n_real, **kwargs)
        if not n_warp:
            return plain

        def log_prob(xs):
            theta, la, lb = warping.split_warp_params(xs, n_warp)
            return plain(theta) + warp_prior(la, lb)
        return log_prob
    monkeypatch.setattr(bayesgpr, "_make_log_prob_batch", unwarped)


def _pvrs_on_unwarped_candidates(monkeypatch):
    """PVRS scores the candidate grid as drawn, not consensus-warped."""
    from bask_tpu_torch import acquisition

    def call(self, X, gp, *args, n_thompson=10, random_state=None, **kwargs):
        Xw = gp._tensor(X)
        z = gp._normals(gp._seed(random_state), (Xw.shape[0], int(n_thompson)))
        vals = acquisition._fused_fullgp_vals(gp._spec, gp._tensor(gp._theta), gp._post,
                                              gp._post_data, Xw, z, gp.white_index_)
        return vals.cpu().numpy()
    monkeypatch.setattr(acquisition.PVRS, "__call__", call)


# each fault: how it is planted (None: the fault of portbench/faults.py of
# that name) and the number it has to fail
FAULTS = {"chain_lml_at_unwarped_x": (_unwarped_chain_lml, "chain_lp_rel"),
          "pvrs_over_unwarped_candidates": (_pvrs_on_unwarped_candidates, "acq_rel"),
          "grid_not_unwarped": (None, "grid_rel"),
          "chain_half_stuck": (None, "stuck_share")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_warped_path_fails_its_number(run_tiny, monkeypatch, fault):
    from portbench import faults

    plant, number = FAULTS[fault]
    if plant is not None:
        plant(monkeypatch)
    with contextlib.nullcontext() if plant else faults.FAULTS[fault]():
        result = run_tiny(CELL)
    checks = result["checks"]
    assert not result["correct"], checks
    assert checks[number]["value"] is None or checks[number]["value"] > checks[number]["limit"]


# ---- the readers, on profiled stretches made of known events ----

def _event(name, start, end, cuda):
    kind = types.SimpleNamespace(name="CUDA" if cuda else "CPU")
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Tracer:
    def __init__(self, events, launches):
        self.events, self.launches = events, launches
        self.spans, self.counts, self.profiled = {}, {}, True

    def profiled_events(self):
        return self.events, 0.0, 1000.0


def _note(kernel, captured=False, **shape):
    return dict(kernel=kernel, captured=captured, window=not captured,
                profiled=not captured, **shape)


WARPED_NOTES = [
    _note("K1", True, B=50, n_pad=448, d=15, per_walker=True),  # set-up's cold bucket
    _note("K1", True, B=50, n_pad=512, d=15, per_walker=True),
    _note("K6", True, B=50, n=448, d=15, shared=True, pdf=False, itemsize=4),
    _note("K6", True, B=50, n=512, d=15, shared=True, pdf=False, itemsize=4),
    _note("K1", B=100, n_pad=512, d=15, per_walker=True),  # the chain's eager start
    _note("K6", B=100, n=512, d=15, shared=True, pdf=False, itemsize=4),
    _note("K7", n=500, d=15, n_iter=30, itemsize=4),  # float32: 30 steps
]
WARPED_KERNELS = (
    [("void gram_kernel<false, 2>(float const*)", 10 + 50 * i, 50 + 50 * i) for i in range(5)]
    + [("void warp_kernel<float, 4>(float const*)", 300 + 20 * i, 310 + 20 * i) for i in range(5)]
    + [("void unwarp_kernel<float, 1>(float const*)", 500, 522),
       ("chol_inv_kernel", 600, 700)])


def _trace(launches, kernels, spans=()):
    events = [_event("portbench.stretch", 0.0, 1000.0, False)]
    events += [_event(n, a, b, False) for n, a, b in spans]
    events += [_event(n, a, b, True) for n, a, b in kernels]
    cfg = {"d": 15, "optimizer_kwargs": {"n_points": 500}}
    return core.Trace(_Tracer(events, launches), 2, cfg, {"trace_units": 2})


def test_warped_readers_read_the_chains_launches():
    spans = [("span.opt.tell", 0, 900), ("span.gp.warp", 100, 110), ("span.gp.unwarp", 200, 230),
             ("span.gp.warp", 240, 250), ("span.gp.warp", 600, 610), ("span.wait", 210, 220)]
    tr = _trace(WARPED_NOTES, WARPED_KERNELS, spans)
    read = core.metric_reader
    # K1 40 us against its 16.11 us bound at (50, 512, 512), per-walker X
    assert read("k1_roofline_pct.seq_warp")(tr) == pytest.approx(100 * 16.1105 / 40.0, rel=1e-4)
    # K6 10 us against 0.928 us at (50, 512, 15) from shared X
    assert read("k6_roofline_pct.seq_warp")(tr) == pytest.approx(100 * 0.92848 / 10.0, rel=1e-4)
    # K7 22 us against 0.5476 us at (500, 15), 30 bisection steps
    assert read("k7_roofline_pct.seq_warp")(tr) == pytest.approx(100 * 0.54761 / 22.0, rel=1e-4)
    assert read("warps.seq_warp")(tr) == pytest.approx(2.0)  # 4 ranges, 2 iterations
    assert read("device_idle_pct.seq_warp")(tr) == pytest.approx(100 * (1 - 372 / 1000))


def test_warped_readers_read_nothing_in_an_unwarped_stretch():
    k4 = [_note("K4", True, B=50, n_pad=512, d=15), _note("K4", B=100, n_pad=512, d=15)]
    kernels = [("gram_wb_kernel<1>", 10, 50), ("chol_inv_kernel", 60, 90)]
    tr = _trace(k4, kernels, [("span.opt.tell", 0, 900), ("span.wait", 100, 110)])
    assert [core.metric_reader(name)(tr) for name in READERS] == [None] * len(READERS)


def test_k1_reader_needs_one_chain_shape_for_the_stretchs_bucket():
    two = WARPED_NOTES + [_note("K1", True, B=25, n_pad=512, d=15, per_walker=True)]
    with pytest.raises(RuntimeError, match="not of one shape"):
        core.metric_reader("k1_roofline_pct.seq_warp")(_trace(two, WARPED_KERNELS))


def test_k1_count_at_the_warped_chains_half_batch():
    from portbench.roofline import k1

    assert k1.bytes_moved(50, 512, 15) == pytest.approx(53.970e6, rel=1e-4)
    assert k1.operations(50, 512, 15) == pytest.approx(5.505e8, rel=1e-3)
    assert k1.bound_us(50, 512, 15) == pytest.approx(16.11, rel=1e-3)
    assert k1.bound_us(50, 512, 15, per_walker=False) == pytest.approx(15.66, rel=1e-3)
    assert k1.is_kernel("void gram_kernel<false, 2>(float const*, long long)")
    assert not k1.is_kernel("void gram_kernel<true, 2>(float const*, long long)")
    assert not k1.is_kernel("void gram_wb_kernel<2, true, false>(float const*)")


# ---- what the loop and its reference load ----

def test_reference_and_loop_load_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench.reference import warp_gp\n"
            "before = set(sys.modules)\n"
            "from portbench.loops import seq_warp\n"
            "import importlib.util as u\n"
            "for name in {readers!r}:\n"
            "    s = u.spec_from_file_location(name, f'portbench/metrics/{{name}}.py')\n"
            "    s.loader.exec_module(u.module_from_spec(s))\n"
            "print(' '.join(sorted({{m.split('.')[0] for m in before}})))\n"
            "print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))\n")
    out = subprocess.run([sys.executable, "-c", code.format(readers=READERS)], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout.splitlines()
    reference, everything = set(out[0].split()), set(out[1].split())
    assert not {"bask_tpu_torch", "bask_tpu", "bask", "jax"} & reference
    assert core.forbidden_loaded(everything) == []


def test_the_loop_models_the_warp_and_refuses_an_unwarped_configuration():
    from portbench import checks, common
    from portbench.loops import seq_warp
    from conftest import tiny

    cfg, mix = tiny(CELL)
    checks.modelled(cfg, seq_warp.MODELS)
    cfg["gp_kwargs"]["warp_inputs"] = False
    run = common.Run(CELL, cfg, mix, 2**31 + 3, 1.0, torch.device("cpu"))
    with pytest.raises(ValueError, match="warped studies"):
        seq_warp.run(run)
    assert np.isfinite(core.limits(CELL)["grid_rel"])
