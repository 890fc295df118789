"""bask's sequential loop with ``gp_kwargs.warp_inputs``: :mod:`.seq_loop`'s
studies, set-up and window, on a model whose chain rows carry a Beta-CDF
warp of the inputs (kernel theta, then d log-alphas, then d log-betas).
Each half-step of the chain warps the training points by each walker's
own warp (K6) before its per-walker grams (K1); each tell draws its
candidate grid uniform in the consensus-warped space and maps it back
(K7), and PVRS warps the grid again and takes its probes in the warped
space.

Around :func:`.seq_loop.run` this loop keeps, in each checked unit, the
kernel theta and the consensus warp the acquisition used, and the
uniforms handed to ``BayesGPR.unwarp`` with the warp that mapped them
back; in a traced run it also notes the shapes with which the program
launched K1 (those captured into the chain's graphs included), K6 and K7.
"""

from __future__ import annotations

import contextlib

import numpy as np

from .. import checks
from ..common import note_warps, wrapped
from ..reference import warp_gp
from . import seq_loop

# what this loop's check models beyond checks.MODELLED: the input warp
MODELS = {"gp_kwargs": {"warp_inputs"}}


def _warp_of(gp):
    return np.array(gp.warp_alphas_, dtype=float), np.array(gp.warp_betas_, dtype=float)


def note_k1(stack, tracer):
    """In a traced run, note the shape of every K1 launch (the gram of
    per-walker X), those captured into the chain's graphs included."""
    if tracer is None:
        return
    from bask_tpu_torch.ops import gram

    def around(original, entry, multiple, spec, thetas, X, *args, **kwargs):
        if entry == "bask_gram_f32":
            tracer.note_launch("K1", B=int(thetas.shape[0]), n_pad=int(X.shape[-2]),
                               d=int(X.shape[-1]), per_walker=X.ndim == 3)
        return original(entry, multiple, spec, thetas, X, *args, **kwargs)
    stack.enter_context(wrapped(gram, "_launch", around))


def run(run) -> dict:
    from bask_tpu_torch import acquisition
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    if not run.cfg["gp_kwargs"].get("warp_inputs"):
        raise ValueError("the seq_warp loop runs warped studies: set gp_kwargs.warp_inputs")
    made = []  # the recorder seq_loop.run makes: these wrappers keep into its checked units

    def recorder(original):
        made.append(original())
        return made[-1]

    def keep_consensus(original, acq, X, gp, *args, **kwargs):
        if made and made[0].active:
            made[0].put(acq_theta=gp.theta, acq_warp=_warp_of(gp))
        return original(acq, X, gp, *args, **kwargs)

    def keep_uniforms(original, gp, Z):
        if made and made[0].active:  # a fresh array the program does not change: no copy
            made[0].put(uniforms=Z, grid_warp=_warp_of(gp))
        return original(gp, Z)

    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(seq_loop, "Recorder", recorder))
        stack.enter_context(wrapped(acquisition.PVRS, "__call__", keep_consensus))
        stack.enter_context(wrapped(BayesGPR, "unwarp", keep_uniforms))
        note_k1(stack, run.tracer)
        note_warps(stack, run.tracer)
        out = seq_loop.run(run)
    warps = [np.exp(np.concatenate(r["acq_warp"])) for r in out["records"] if "acq_warp" in r]
    if warps:  # the consensus warps' a and b, least and largest over the checked units
        out["info"]["warp_ab_range"] = [float(np.min(warps)), float(np.max(warps))]
    return out


class WarpedData(checks.Data):
    """:class:`checks.Data` of a warped model: the consensus LML and the
    log-posterior of a chain row are the warped reference's
    (:mod:`portbench.reference.warp_gp`)."""

    def consensus_lml(self, chain, side="float64"):
        with warp_gp.precision(side):
            return float(warp_gp.consensus_lml(self.t(chain, side), self.X[side], self.y[side],
                                               self.jitter, self.nu, self.d))

    def log_posterior(self, thetas, side="float64"):
        with warp_gp.precision(side):
            return warp_gp.log_posterior(self.t(thetas, side), self.X[side], self.y[side],
                                         self.jitter, self.nu, self.d)


def _pvrs(r, data, points, s):
    """The reference's PVRS at ``points`` (a float64 array), in ``s``'s
    precision: the kernel theta and the consensus warp the tell's
    acquisition used, at the program's probes."""
    la, lb = r["acq_warp"]
    with warp_gp.precision(s):
        return warp_gp.pvrs(data.t(r["acq_theta"], s), data.t(la, s), data.t(lb, s), data.X[s],
                            data.y[s], data.jitter, data.nu, data.t(points, s),
                            data.t(r["probes"], s))


def numbers(records, cfg, mix, side="program", device="cpu") -> dict:
    """The numbers of the checked iterations, each against the float64
    warped reference: ``lml_rel`` (the consensus LML at the geometric
    median of the kept chain, X warped by the median's own warp),
    ``chain_lp_rel`` (each walker's kernel prior, warp prior and LML at X
    warped by its own row, at the chain's end) and ``stuck_share``
    (:mod:`portbench.checks`); ``acq_rel``: PVRS over the tell's
    candidates at the program's probes, the reference warping X and the
    candidates by the consensus warp the program used, and the
    reference's value at the returned point against the program's best,
    over the largest reference value (as :mod:`.seq_loop`); ``grid_rel``:
    the largest gap between the uniform each grid entry was drawn as and
    the reference's Beta CDF, under the warp that mapped it back, of the
    entry the tell used: of its float32 cell, the entry and its two
    neighbours (:func:`warp_gp.unwarp_gap`; where a or b is well below 1,
    no float32 entry comes nearer). The control has no grid of its own: it
    reads the program's."""
    if mix["acq_func"] != "pvrs":
        raise ValueError(f"the warped reference has no acquisition {mix['acq_func']!r}")
    checks.modelled(cfg, MODELS)
    out = {"lml_rel": [], "acq_rel": [], "chain_lp_rel": [], "stuck_share": [], "grid_rel": []}
    for r in records:
        data = WarpedData(r["X"], r["y"], cfg, device)
        grid = np.asarray(r["grid"], dtype=float)
        m = len(grid)
        full64 = _pvrs(r, data, np.vstack([grid, r["answer"]]), "float64")
        ref64 = full64[:m].double().cpu().numpy()
        if side == "program":
            prog, answer_value = np.asarray(r["acq"], dtype=float), float(full64[m])
        else:
            prog = _pvrs(r, data, grid, "tf32").double().cpu().numpy()
            answer_value = float(ref64[int(np.nanargmax(prog))])
        scale = float(np.max(np.abs(ref64)))
        out["acq_rel"].append(max(float(np.max(np.abs(prog - ref64))),
                                  abs(float(np.max(prog)) - answer_value)) / scale)
        out["lml_rel"].append(checks.lml_rel(r, data, side))
        for k, v in checks.chain_numbers(r, data, side).items():
            out[k].append(v)
        if "uniforms" in r:
            la, lb = (data.t(w) for w in r["grid_warp"])
            gap = warp_gp.unwarp_gap(data.t(grid), data.t(r["uniforms"]), la, lb)
            out["grid_rel"].append(float(gap.max()))
        else:  # a grid that never went through the inverse warp has no uniforms
            out["grid_rel"].append(float("nan"))
    return {k: checks.worst(v) for k, v in out.items()}
