"""Repeated ``ask(n_points=batch)`` on the model a cold tell of the
configuration's ``n`` points fitted in set-up (then one discarded ask):
one Thompson draw per point over a fresh candidate grid. The checked
draws (drawn from the seed) keep their values through the draws' ``keep``
argument in every ask, so every ask does the same work.

With ``gp_kwargs.warp_inputs`` each chain row carries a Beta-CDF warp of
the inputs, the grid is drawn uniform in the consensus-warped space and
mapped back (K7), and each draw warps the training points and the grid by
its own row's warp (K6) before its gram and its values.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from .. import checks, core
from ..common import (Recorder, bowl, inside, note_k5, note_warps, optimizer, report_failure,
                      spans, wrapped)
from ..reference import gp as ref
from ..reference import warp as ref_warp

# what this loop's check models beyond checks.MODELLED: the input warp
MODELS = {"gp_kwargs": {"warp_inputs"}}


def run(run) -> dict:
    from bask_tpu_torch import Optimizer
    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    cfg, mix = run.cfg, run.mix
    d, n, batch = cfg["d"], cfg["n"], mix["batch"]
    data_rng = core.rng(run.seed, 0)
    X = data_rng.uniform(size=(n, d))
    y = bowl(X, data_rng, cfg["objective_noise"])
    run.mark("data")
    opt = optimizer(run, n, mix["cold_acq_func"], {"until_rhat": None})
    opt.tell(X.tolist(), y.tolist(), n_samples=mix["cold_acq_samples"],
             gp_samples=cfg["walkers"], gp_burnin=mix["burnin"])
    run.mark("cold tell")
    draws = sorted(int(j) for j in core.rng(run.seed, 2).choice(
        batch, size=mix["check_draws"], replace=False))
    rec = Recorder()
    failures, records, ask_s, grid_s = [], [], [], []

    def keep_draws(original, spec, rows, data, Xq, rand, n_warp, k=8, **kwargs):
        idx, values = original(spec, rows, data, Xq, rand, n_warp, k, keep=draws, **kwargs)
        if rec.active:
            rec.put(rows=rows[draws], grid=Xq, values=values,
                    rand={f: None if r is None else r[draws] for f, r in rand._asdict().items()})
        return idx

    def keep_uniforms(original, gp, Z):  # the warped grid's draw, before K7 maps it back
        if rec.active:
            rec.put(uniforms=Z)  # a fresh array the program does not change: no copy
        return original(gp, Z)

    def time_grid(original, *args, **kwargs):  # host work alone: no synchronize needed
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        grid_s.append(time.perf_counter() - t0)
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(pathwise, "pathwise_topk_hyper", keep_draws))
        stack.enter_context(wrapped(BayesGPR, "unwarp", keep_uniforms))
        note_k5(stack, run.tracer, n)
        note_warps(stack, run.tracer)
        spans(stack, run.tracer, [(Optimizer, "_candidate_grid", "grid"),
                                  (BayesGPR, "thompson_argmin_pathwise", "draws")])
        stack.enter_context(wrapped(Optimizer, "_candidate_grid", time_grid))
        opt.ask(n_points=batch)  # discarded
        run.mark("discarded ask")
        window = run.make_window()
        grid_s.clear()
        window.start()
        i = 0
        while window.open():
            rec.active = run.checked(i)
            t0 = time.perf_counter()
            try:
                points = np.asarray(opt.ask(n_points=batch), dtype=float)
                if points.shape != (batch, d) or not all(inside(p, d) for p in points):
                    raise ValueError("ask(n_points) gave points outside the unit cube")
            except Exception:
                report_failure(failures)
                rec.active = False
                rec.take()
            ask_s.append(time.perf_counter() - t0)
            if rec.active:
                records.append(dict(unit=i, answers=points, draws=draws, **rec.take()))
            rec.active = False
            i += 1
            window.unit_done()
        window.close()
    return dict(
        attempted=i, failed=len(failures), state=opt,
        records=dict(X=X, y=y, asks=records, chain=np.array(opt.gp.chain_, dtype=float)),
        metrics={"batch_ask_s": window.length / max(i - len(failures), 1)},
        info={"asks": i, "window_s": window.length, "checked_units": [r["unit"] for r in records],
              "checked_draws": draws, "ask_s": ask_s, "grid_s": grid_s},
    )


def numbers(records, cfg, mix, side="program", device="cpu") -> dict:
    """``draw_rel``: each checked pathwise draw's values over the whole
    grid against the reference's, and the reference's value at the point
    the ask returned for that draw against the program's least value over
    the grid points no earlier draw took; over the largest reference
    value. A warped draw's row splits as the program's does (kernel theta,
    then d log-alphas, then d log-betas), and the reference warps the
    training points and the grid by that row's warp in its own precision.

    Warped, also ``grid_rel``: the largest gap between the uniform each
    grid entry was drawn as and the reference's Beta CDF of the entry
    under the consensus warp (the warp part of the float64 geometric
    median of the program's chain). The control has no grid of its own:
    it reads the program's."""
    checks.modelled(cfg, MODELS)
    n_warp = cfg["d"] if cfg["gp_kwargs"].get("warp_inputs") else 0
    out, grid_gaps = [], []
    data = checks.Data(records["X"], records["y"], cfg, device)
    n = data.X["float64"].shape[0]
    if n_warp:
        median = ref.geometric_median(data.t(records["chain"]))
        consensus = median[-2 * n_warp : -n_warp], median[-n_warp:]
    for r in records["asks"]:
        grid = r["grid"].double().cpu().numpy()
        if n_warp:  # a grid that never went through the inverse warp has no uniforms
            grid_gaps.append(float((ref_warp.warp(data.t(grid), *consensus)
                                    - data.t(r["uniforms"])).abs().max())
                             if "uniforms" in r else math.nan)
        answers = data.t(r["answers"])
        taken = torch.cdist(answers, data.t(grid)).argmin(dim=1)
        for q, j in enumerate(r["draws"]):
            rand = {k: None if v is None else v[q].double().cpu().numpy()
                    for k, v in r["rand"].items()}
            row = r["rows"][q].double().cpu().numpy()

            def draw(points, s, rand=rand, row=row):
                with ref.precision(s):
                    theta, X, P = data.t(row, s), data.X[s], data.t(points, s)
                    if n_warp:
                        la, lb = theta[-2 * n_warp : -n_warp], theta[-n_warp:]
                        theta = theta[: -2 * n_warp]
                        X, P = ref_warp.warp(X, la, lb), ref_warp.warp(P, la, lb)
                    return ref.pathwise_draw(
                        theta, X, data.y[s], data.jitter, data.nu, P, data.t(rand["z"], s),
                        None if rand["u"] is None else data.t(rand["u"], s),
                        data.t(rand["phase"], s), data.t(rand["w"][:, 0], s),
                        data.t(rand["e"][:n, 0], s)).double()

            full64 = draw(np.vstack([grid, r["answers"][j]]), "float64")
            ref64, answer64 = full64[:-1], float(full64[-1])
            free = torch.ones_like(ref64, dtype=torch.bool)
            free[taken[:j]] = False
            if side == "program":
                prog, answer_value = r["values"][q].double().to(ref64.device), answer64
            else:
                prog = draw(grid, "tf32")
                pick = torch.where(free & torch.isfinite(prog), prog, math.inf).argmin()
                answer_value = float(ref64[pick])
            best = float(torch.where(free, prog, math.inf).min())
            out.append(max(float((prog - ref64).abs().max()), abs(best - answer_value))
                       / float(ref64.abs().max()))
    result = {"draw_rel": checks.worst(out)}
    if n_warp:
        result["grid_rel"] = checks.worst(grid_gaps)
    return result
