"""The correctness check's shared pieces: the numbers compared with the
plain reference (:mod:`portbench.reference`, float64) on what the timed
path produced, each the worst over the checked units of the window. Each
loop's ``numbers`` (``loops/<loop>.py``) gathers those of its cell.

``side="program"`` judges the program's outputs; ``side="tf32"`` puts the
reference itself in the program's place, computed in float32 with TF32
matmuls (the precision control, one step below the configuration's
float32), and judges that the same way. Every number is a share: 0 is
exact, and a NaN (a factorization that failed) fails its limit.

- ``lml_rel``: the consensus LML the program reports against the
  reference's LML at the reference's consensus, the geometric median of
  the program's kept chain; over max(1, |LML|).
- ``chain_lp_rel``: the log-posterior the program holds for each walker
  at the end of the unit's chain (the batched grams and factorizations of
  the chain's steps, most of them replayed from CUDA graphs) against the
  reference's prior plus LML at the same positions; over max(1, |it|).
- ``stuck_share``: the share of walkers whose position at the end of the
  unit's chain is the one it started from, in the half of the ensemble
  (the walkers that one half-update moves) where it is larger. The
  control runs no chain, so it reads the program's; the number is held
  against a chain whose steps, or the second half-update of each, return
  their state (both read 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import gp as ref
from .reference import priors

# what the reference models of the options a configuration hands the
# program, in every loop's check; a loop's ``MODELS`` names what its own
# check models beyond this
MODELLED = {"gp_kwargs": {"normalize_y"}, "optimizer_kwargs": {"n_points"},
            "kernel": {"amplitude", "amplitude_bounds", "lengthscale", "lengthscale_bounds", "nu",
                       "noise", "noise_bounds"}}
NU_MODELLED = (0.5, 1.5, 2.5)  # the Matern orders of ``reference.gp.matern``


def modelled(cfg: dict, models: dict = None):
    """Raise where the configuration hands the program an option that
    neither :data:`MODELLED` nor ``models`` (the loop's ``MODELS``: group
    -> option names) names: its answers would be judged against another
    model's. A Matern order outside :data:`NU_MODELLED` is refused unless
    ``models`` names ``kernel.nu``."""
    models = models or {}
    extra = {k: sorted(set(cfg.get(k, {})) - MODELLED.get(k, set()) - set(models.get(k, ())))
             for k in MODELLED.keys() | models.keys()}
    extra = {k: v for k, v in extra.items() if v}
    any_nu = "nu" in models.get("kernel", ())
    if extra or not (any_nu or cfg["kernel"]["nu"] in NU_MODELLED):
        raise ValueError(f"the reference does not model {extra or cfg['kernel']['nu']}: "
                         "a loop whose check models it has to judge this configuration")


def worst(values):
    values = [float(v) for v in values]
    if not values:
        return math.nan
    return math.nan if any(math.isnan(v) for v in values) else max(values)


class Data:
    """One unit's training data in the reference's dtype and the control's."""

    def __init__(self, X, y, cfg, device):
        y_n, self.y_mean, self.y_std = ref.normalize(y, cfg["gp_kwargs"].get("normalize_y", False))
        self.d = int(cfg["d"])
        self.nu, self.jitter = float(cfg["kernel"]["nu"]), float(cfg["reference_jitter"])
        self.X = {s: torch.tensor(X, dtype=ref.dtype_of(s), device=device)
                  for s in ("float64", "tf32")}
        self.y = {s: torch.tensor(y_n, dtype=ref.dtype_of(s), device=device)
                  for s in ("float64", "tf32")}

    def t(self, a, side="float64"):
        if torch.is_tensor(a):
            a = a.detach().double().cpu().numpy()
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=ref.dtype_of(side),
                               device=self.X["float64"].device)

    def consensus_lml(self, chain, side="float64"):
        """The LML at the geometric median of ``chain``, in ``side``'s
        precision."""
        with ref.precision(side):
            theta = ref.geometric_median(self.t(chain, side))
            return float(ref.lml(theta, self.X[side], self.y[side], self.jitter, self.nu))

    def log_posterior(self, thetas, side="float64"):
        """Prior plus LML of each row of ``thetas``, in ``side``'s precision."""
        t = self.t(thetas, side)
        with ref.precision(side):
            lml = [ref.lml(row, self.X[side], self.y[side], self.jitter, self.nu) for row in t]
            return priors.log_prior(t, self.d) + torch.stack(lml)


def lml_rel(r, data, side):
    best = data.consensus_lml(r["chain"])
    lml = r["lml"] if side == "program" else data.consensus_lml(r["chain"], "tf32")
    return abs(lml - best) / max(1.0, abs(best))


def chain_numbers(r, data, side) -> dict:
    """``chain_lp_rel`` and ``stuck_share`` of one unit's chain; a unit
    that ran no chain has no log-posterior to compare, and moved nothing."""
    if "chain_end" not in r:
        return {"chain_lp_rel": math.nan, "stuck_share": 1.0}
    end = r["chain_end"].cpu()
    best = data.log_posterior(end).double().cpu()
    lp = (r["chain_end_lp"].double().cpu() if side == "program"
          else data.log_posterior(end, "tf32").double().cpu())
    gap = ((lp - best).abs() / best.abs().clamp(min=1.0)).max()
    unmoved = (end == r["chain_start"].cpu()).all(dim=1).double()
    half = unmoved.shape[0] // 2
    stuck = max(unmoved[:half].mean(), unmoved[half:].mean())
    return {"chain_lp_rel": float(gap), "stuck_share": float(stuck)}
