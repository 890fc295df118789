"""Sequential studies, round robin, one closed-loop client each: an
iteration is ``tell(x, f(x))`` for the point the study's last ``ask()``
gave, then ``ask()``; its latency runs from the tell's call to the ask's
return.

Set-up: one cold tell at ``n_start`` points, saved once and loaded as
every study (each with generators of its own), then one discarded
iteration per study, which captures the chain's graphs for the next
bucket and warms the acquisition. A study that reaches ``reload_at``
points is loaded again from the checkpoint, inside the window but outside
any iteration's latency.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import checks, core
from ..common import (Recorder, bowl, inside, keep_chain, note_k4, optimizer, report_failure,
                      spans, wrapped)
from ..reference import gp as ref

# what this loop's check models beyond checks.MODELLED: nothing
MODELS = {}


class _Study:
    def __init__(self, opt, X, y, noise_rng, generation):
        self.opt, self.X, self.y = opt, list(X), list(y)
        self.noise_rng, self.generation = noise_rng, generation
        self.x = opt.ask()


def run(run) -> dict:
    from bask_tpu_torch import Optimizer, acquisition
    from bask_tpu_torch.models.bayesgpr import BayesGPR
    from bask_tpu_torch.utils.serialization import load_optimizer, save_optimizer

    cfg, mix = run.cfg, run.mix
    d, n0, noise = cfg["d"], mix["n_start"], cfg["objective_noise"]
    n_samples = mix["acq_samples"]
    data_rng = core.rng(run.seed, 0)
    X0 = data_rng.uniform(size=(n0, d))
    y0 = bowl(X0, data_rng, noise)
    run.mark("data")
    opt = optimizer(run, n0, mix["acq_func"],
                    {"max_extensions": mix["cold_extensions"],
                     "extension_steps": mix["extension_steps"]})
    opt.tell(X0.tolist(), y0.tolist(), n_samples=n_samples)
    run.mark("cold tell")
    ckpt_dir = tempfile.mkdtemp(prefix="portbench-")
    path = os.path.join(ckpt_dir, "study.npz")
    save_optimizer(opt, path)
    del opt
    run.mark("checkpoint")

    def load(s, generation):
        o = load_optimizer(path, device=run.device)
        o.rng.seed(core.seed32(run.seed, 4, s, generation))
        o.gp.random_state.seed(core.seed32(run.seed, 5, s, generation))
        return _Study(o, X0, y0, core.rng(run.seed, 1, s, generation), generation)

    rec = Recorder()
    failures, latencies, records = [], [], []
    reloads = 0

    def keep_acquisition(original, *args, **kwargs):
        out = original(*args, **kwargs)
        if rec.active:
            rec.put(grid=np.array(kwargs["X"], dtype=float), acq=np.array(out, dtype=float)[0],
                    acq_seed=kwargs.get("random_state"), acq_samples=kwargs.get("n_samples"))
        return out

    def keep_probes(original, *args, **kwargs):
        P = original(*args, **kwargs)
        if rec.active:
            rec.put(probes=P.detach().double().cpu().numpy())
        return P

    def iterate(st):
        y = float(bowl(st.x, st.noise_rng, noise)[0])
        t0 = time.perf_counter()
        st.opt.tell(list(st.x), y, n_samples=n_samples)
        x_next = st.opt.ask()
        latency = time.perf_counter() - t0
        st.X.append(np.asarray(st.x, dtype=float))
        st.y.append(y)
        st.x = x_next
        return latency

    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(acquisition, "evaluate_acquisitions_fused", keep_acquisition))
        stack.enter_context(wrapped(acquisition, "_thompson_probes", keep_probes))
        keep_chain(stack, rec, run.tracer)
        note_k4(stack, run.tracer)
        spans(stack, run.tracer, [(BayesGPR, "sample", "refit"),
                                  (acquisition, "evaluate_acquisitions_fused", "acquisition"),
                                  (Optimizer, "_candidate_grid", "grid")])
        studies = [load(s, 0) for s in range(mix["studies"])]
        run.mark("study loads")
        for st in studies:  # discarded: the next bucket's graphs, the acquisition
            iterate(st)
        run.mark("discarded iterations")
        window = run.make_window()
        window.start()
        i = 0
        while window.open():
            s = i % len(studies)
            st = studies[s]
            if len(st.y) >= mix["reload_at"]:
                studies[s] = st = load(s, st.generation + 1)
                reloads += 1
            rec.active = run.checked(i)
            try:
                latencies.append(iterate(st))
                if not inside(st.x, d):
                    raise ValueError(f"ask() gave {st.x!r}, not a point of the unit cube")
            except Exception:
                report_failure(failures)
                studies[s] = load(s, st.generation + 1)
                rec.active = False
                rec.take()
            if rec.active:
                gp = st.opt.gp
                records.append(dict(
                    unit=i, X=np.array(st.X), y=np.array(st.y), theta=gp.theta,
                    lml=gp.log_marginal_likelihood_value_, chain=gp.chain_,
                    answer=np.asarray(st.x, dtype=float), **rec.take()))
            rec.active = False
            i += 1
            window.unit_done()
        window.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    done = i - len(failures)
    return dict(
        attempted=i, failed=len(failures), records=records, state=studies,
        metrics={"iters_per_s": done / window.length,
                 "iter_p95_ms": 1e3 * float(np.percentile(latencies, 95))
                 if latencies else math.nan},
        info={"iterations": i, "reloads": reloads, "window_s": window.length,
              "checked_units": [r["unit"] for r in records]},
    )


def _acquisition(r, data, mix, points, s):
    """The reference's acquisition values at ``points`` (a float64 array),
    in ``s``'s precision."""
    pts = data.t(points, s)
    with ref.precision(s):
        if mix["acq_func"] == "pvrs":
            return ref.pvrs(data.t(r["theta"], s), data.X[s], data.y[s], data.jitter, data.nu,
                            pts, data.t(r["probes"], s))
        rows = np.random.RandomState(r["acq_seed"]).choice(
            len(r["chain"]), replace=False, size=r["acq_samples"])
        grid = data.t(r["grid"], s)
        return torch.cat(ref.expected_improvement(
            data.t(r["chain"][rows], s), data.X[s], data.y[s], data.y_mean, data.y_std,
            data.jitter, data.nu, grid, pts[len(grid):]))


def numbers(records, cfg, mix, side="program", device="cpu") -> dict:
    """The numbers of the checked iterations: ``lml_rel``, ``chain_lp_rel``
    and ``stuck_share`` (:mod:`portbench.checks`) and ``acq_rel``: the
    acquisition's values over the candidate grid the tell used against
    the reference's (PVRS at the program's Thompson probes; EI averaged
    over the chain rows its seed picks), and the reference's value at the
    point the tell returned against the program's best value; over the
    largest reference value."""
    if mix["acq_func"] not in ("pvrs", "ei"):
        raise ValueError(f"the reference has no acquisition {mix['acq_func']!r}")
    checks.modelled(cfg, MODELS)
    out = {"lml_rel": [], "acq_rel": [], "chain_lp_rel": [], "stuck_share": []}
    for r in records:
        data = checks.Data(r["X"], r["y"], cfg, device)
        grid = np.asarray(r["grid"], dtype=float)
        m = len(grid)
        full64 = _acquisition(r, data, mix, np.vstack([grid, r["answer"]]), "float64")
        ref64 = full64[:m].double().cpu().numpy()
        if side == "program":
            prog, answer_value = np.asarray(r["acq"], dtype=float), float(full64[m])
        else:
            prog = _acquisition(r, data, mix, grid, "tf32")[:m].double().cpu().numpy()
            answer_value = float(ref64[int(np.nanargmax(prog))])
        scale = float(np.max(np.abs(ref64)))
        out["lml_rel"].append(checks.lml_rel(r, data, side))
        out["acq_rel"].append(max(float(np.max(np.abs(prog - ref64))),
                                  abs(float(np.max(prog)) - answer_value)) / scale)
        for k, v in checks.chain_numbers(r, data, side).items():
            out[k].append(v)
    return {k: checks.worst(v) for k, v in out.items()}
