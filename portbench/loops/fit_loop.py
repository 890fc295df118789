"""Fresh fits back to back: each a new ``BayesGPR`` on ``n`` points drawn
from the seed and the fit's index, ML-II then one chain of ``steps``
steps (``burnin`` of them discarded). Set-up runs one discarded fit,
which captures the chain's graphs.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from .. import checks, core
from ..common import Recorder, bowl, keep_chain, make_kernel, report_failure, spans

# what this loop's check models beyond checks.MODELLED: nothing
MODELS = {}


def run(run) -> dict:
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    cfg, mix = run.cfg, run.mix
    d, n = cfg["d"], cfg["n"]
    rec = Recorder()
    failures, records = [], []

    def dataset(i):
        r = core.rng(run.seed, 3, i)
        X = r.uniform(size=(n, d))
        return X, bowl(X, r, cfg["objective_noise"])

    def one_fit(i):
        X, y = dataset(i)
        gp = BayesGPR(kernel=make_kernel(cfg["kernel"], d), random_state=core.seed32(run.seed, 6, i),
                      device=run.device, **cfg["gp_kwargs"])
        gp.fit(X, y, n_desired_samples=cfg["walkers"] * (mix["steps"] - mix["burnin"]),
               n_burnin=mix["burnin"], n_walkers_per_thread=cfg["walkers"], progress=False)
        return gp, X, y

    with contextlib.ExitStack() as stack:
        keep_chain(stack, rec, run.tracer)
        spans(stack, run.tracer, [(BayesGPR, "_ml2_optimize", "ml2")])
        one_fit(0)  # discarded
        run.mark("discarded fit")
        window = run.make_window()
        window.start()
        i = 0
        gp = None
        while window.open():
            rec.active = run.checked(i)
            try:
                gp, X, y = one_fit(i + 1)
                if not (np.isfinite(gp.theta).all()
                        and math.isfinite(gp.log_marginal_likelihood_value_)):
                    raise ValueError("the fit gave a non-finite consensus")
            except Exception:
                report_failure(failures)
                rec.active = False
                rec.take()
            if rec.active:
                records.append(dict(unit=i, X=X, y=y, lml=gp.log_marginal_likelihood_value_,
                                    chain=gp.chain_, **rec.take()))
            rec.active = False
            i += 1
            window.unit_done()
        window.close()
    return dict(
        attempted=i, failed=len(failures), records=records, state=gp,
        metrics={"fit_s": window.length / max(i - len(failures), 1)},
        info={"fits": i, "window_s": window.length, "checked_units": [r["unit"] for r in records]},
    )


def numbers(records, cfg, mix, side="program", device="cpu") -> dict:
    """``lml_rel``, ``chain_lp_rel`` and ``stuck_share`` of the checked
    fits (:mod:`portbench.checks`)."""
    checks.modelled(cfg, MODELS)
    out = {"lml_rel": [], "chain_lp_rel": [], "stuck_share": []}
    for r in records:
        data = checks.Data(r["X"], r["y"], cfg, device)
        out["lml_rel"].append(checks.lml_rel(r, data, side))
        for k, v in checks.chain_numbers(r, data, side).items():
            out[k].append(v)
    return {k: checks.worst(v) for k, v in out.items()}
