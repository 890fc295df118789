"""Affine-invariant ensemble MCMC on the device (stretch, DE, snooker).

PyTorch counterpart of :mod:`bask_tpu.parallel.mcmc`. Each ensemble step
updates the two complementary halves in turn; the log-probability of a
whole half-ensemble is one batched call (one fused gram and one batched
factorization on the GP path). The JAX ``lax.scan`` becomes a Python
loop over steps, and the weighted ``lax.switch`` over moves becomes a
move index per step, drawn for the whole chain up front on the host, so
the loop never waits on a device-to-host copy. Accept/reject stays a
``torch.where`` on the device.

Every half-update takes its random numbers pre-drawn (``draw_*``), in the
layout in which the JAX package draws them, so a test can feed the
randoms JAX drew to both packages and compare the updates exactly.

Detailed balance: the stretch factor is z = ((a-1)u + 1)^2 / a, with
acceptance factor z^(D-1) * exp(lp(prop) - lp(curr)); DE proposals are
symmetric; snooker needs the (|x' - z| / |x - z|)^(D-1) Jacobian.
Proposals with a -inf or NaN log-ratio are rejected (NaN compares
False).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.progress import get_progress_bar

__all__ = [
    "EnsembleState",
    "init_ensemble",
    "draw_stretch",
    "draw_de",
    "draw_snooker",
    "stretch_half_update",
    "de_half_update",
    "snooker_half_update",
    "make_step_fn",
    "run_ensemble",
    "flatten_chain",
    "validate_walker_count",
]


class EnsembleState(NamedTuple):
    pos: torch.Tensor  # (W, D) walker positions
    log_prob: torch.Tensor  # (W,)
    accepted: torch.Tensor  # 0-d int64: total accepted moves


def init_ensemble(log_prob_fn: Callable, pos) -> EnsembleState:
    """``log_prob_fn`` maps a walker batch (W, D) -> (W,)."""
    return EnsembleState(
        pos=pos,
        log_prob=log_prob_fn(pos),
        accepted=torch.zeros((), dtype=torch.int64, device=pos.device),
    )


def _uniform(gen, h, like):
    return torch.rand(h, generator=gen, dtype=like.dtype, device=like.device)


def _randint(gen, hi, h, like):
    return torch.randint(0, hi, (h,), generator=gen, device=like.device)


def _accept(active, lp_active, prop, lp_prop, log_ratio, u_acc):
    accept = torch.log(u_acc) < log_ratio
    new_active = torch.where(accept[:, None], prop, active)
    new_lp = torch.where(accept, lp_prop, lp_active)
    return new_active, new_lp, accept.sum()


def draw_stretch(gen, h, c, like):
    """(partners, u, u_accept): the draws of one stretch half-update."""
    return (
        _randint(gen, c, h, like),
        _uniform(gen, h, like),
        _uniform(gen, h, like),
    )


def stretch_half_update(log_prob_fn, active, lp_active, other, draws, a):
    """Stretch-move update of ``active`` walkers against ``other``."""
    partners, u, u_acc = draws
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    anchor = other[partners]
    prop = anchor + z[:, None] * (active - anchor)
    lp_prop = log_prob_fn(prop)
    log_ratio = (active.shape[1] - 1.0) * torch.log(z) + lp_prop - lp_active
    return _accept(active, lp_active, prop, lp_prop, log_ratio, u_acc)


def draw_de(gen, h, c, like):
    """(j, k_raw, eps, u_accept): the draws of one DE half-update; the
    noise is standard normal (scaled by sigma in the update)."""
    j = _randint(gen, c, h, like)
    k = _randint(gen, c - 1, h, like)
    eps = torch.randn(
        h, like.shape[1], generator=gen, dtype=like.dtype, device=like.device
    )
    return j, k, eps, _uniform(gen, h, like)


def de_half_update(log_prob_fn, active, lp_active, other, draws, gamma, sigma):
    """Differential-evolution update (ter Braak 2006; emcee's DEMove):
    x' = x + gamma (x_j - x_k) + sigma N(0, I), j != k from ``other``."""
    j, k, eps, u_acc = draws
    k = k + (k >= j)  # distinct second index
    prop = active + gamma * (other[j] - other[k]) + sigma * eps
    lp_prop = log_prob_fn(prop)
    return _accept(active, lp_active, prop, lp_prop, lp_prop - lp_active, u_acc)


def draw_snooker(gen, h, c, like):
    """(iz, i1_raw, i2_raw, u_accept): the draws of one snooker update."""
    return (
        _randint(gen, c, h, like),
        _randint(gen, c - 1, h, like),
        _randint(gen, c - 2, h, like),
        _uniform(gen, h, like),
    )


def snooker_half_update(log_prob_fn, active, lp_active, other, draws, gamma_s):
    """Snooker update (ter Braak & Vrugt 2008; emcee's DESnookerMove):
    x' = x + gamma_s ((z1 - z2).u) u with u = (x - z)/|x - z|, for three
    distinct anchors z, z1, z2 of ``other``."""
    iz, i1, i2, u_acc = draws
    D = active.shape[1]
    i1 = i1 + (i1 >= iz)
    lo = torch.minimum(iz, i1)
    hi = torch.maximum(iz, i1)
    i2 = i2 + (i2 >= lo)
    i2 = i2 + (i2 >= hi)
    z, z1, z2 = other[iz], other[i1], other[i2]
    delta = active - z
    norm = torch.sqrt((delta * delta).sum(1))
    # x == z gives u = 0 and a NaN log-ratio below: rejected
    u = delta / torch.clamp(norm, min=1e-35)[:, None]
    proj = (u * (z1 - z2)).sum(1)
    prop = active + gamma_s * proj[:, None] * u
    lp_prop = log_prob_fn(prop)
    norm_prop = torch.sqrt(((prop - z) ** 2).sum(1))
    log_ratio = (
        (D - 1.0) * (torch.log(norm_prop) - torch.log(norm)) + lp_prop - lp_active
    )
    return _accept(active, lp_active, prop, lp_prop, log_ratio, u_acc)


_MOVE_NAMES = ("stretch", "de", "snooker")
_MOVE_PARAMS = {
    "stretch": ("a",),
    "de": ("gamma", "sigma", "jump"),
    "snooker": ("gammas",),
}
# distinct anchors each move draws from the complementary half
_MIN_WALKERS = {"stretch": 2, "de": 4, "snooker": 6}


def _parse_move(name):
    """``"de"`` -> ("de", {}); ``"de:jump=0.2,gamma=0.6"`` ->
    ("de", {"jump": 0.2, "gamma": 0.6}). Raises on unknown names and keys
    and on out-of-range values."""
    base, sep, rest = name.partition(":")
    if base not in _MOVE_NAMES:
        raise ValueError(f"unknown move {base!r} (expected one of {_MOVE_NAMES})")
    params = {}
    if sep:
        allowed = _MOVE_PARAMS[base]
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq or key not in allowed:
                raise ValueError(
                    f"move {base!r} takes parameters {allowed}; got {item!r}"
                )
            if key in params:
                raise ValueError(f"duplicate parameter {key!r} in {name!r}")
            v = float(val)
            if key == "jump":
                bad = not math.isfinite(v) or v < 0.0 or v > 1.0
            else:
                bad = not math.isfinite(v) or v <= 0.0
            if bad:
                raise ValueError(f"move parameter {key}={val!r} out of range")
            params[key] = v
    return base, params


def validate_walker_count(n_walkers, moves):
    """Raise when ``n_walkers`` cannot support ``moves`` (None = stretch)."""
    names = ("stretch",) if not moves else tuple(n for n, _ in moves)
    for name in names:
        base = name.partition(":")[0]
        need = _MIN_WALKERS.get(base, 2)
        if n_walkers < need:
            raise ValueError(
                f"move {base!r} needs at least {need} walkers; got "
                f"n_walkers={n_walkers}"
            )


def _normalize_moves(moves):
    """``(name, weight)`` pairs -> (names, normalized weights)."""
    if not moves:
        raise ValueError("moves must be a non-empty tuple of (name, weight)")
    names, weights = [], []
    for name, weight in moves:
        _parse_move(name)
        if weight < 0:
            raise ValueError(f"move weight must be >= 0, got {weight}")
        names.append(name)
        weights.append(float(weight))
    total = sum(weights)
    if total <= 0:
        raise ValueError("move weights must sum to a positive value")
    return tuple(names), tuple(w / total for w in weights)


def _move_step(log_prob_fn, name, a):
    """One full ensemble step of move ``name``: (state, gen) -> state."""
    base, p = _parse_move(name)

    def step(state, gen):
        pos, lp = state.pos, state.log_prob
        W, D = pos.shape
        half = W // 2
        if base == "stretch":
            a_eff = p.get("a", a)
            draw = draw_stretch

            def update(act, lpa, oth, dr):
                return stretch_half_update(log_prob_fn, act, lpa, oth, dr, a_eff)

        elif base == "de":
            gamma0 = p.get("gamma", 2.38 / (2.0 * D) ** 0.5)
            sigma = p.get("sigma", 1e-5)
            # the step-wide full-difference "mode jump" with prob. jump
            jump = _uniform(gen, (), pos) < p.get("jump", 0.1)
            gamma = torch.where(jump, 1.0, gamma0).to(pos.dtype)
            draw = draw_de

            def update(act, lpa, oth, dr):
                return de_half_update(log_prob_fn, act, lpa, oth, dr, gamma, sigma)

        else:
            gamma_s = p.get("gammas", 1.7)
            draw = draw_snooker

            def update(act, lpa, oth, dr):
                return snooker_half_update(log_prob_fn, act, lpa, oth, dr, gamma_s)

        first, second = pos[:half], pos[half:]
        lp1, lp2 = lp[:half], lp[half:]
        first, lp1, acc0 = update(
            first, lp1, second, draw(gen, half, W - half, pos)
        )
        second, lp2, acc1 = update(
            second, lp2, first, draw(gen, W - half, half, pos)
        )
        return EnsembleState(
            pos=torch.cat([first, second]),
            log_prob=torch.cat([lp1, lp2]),
            accepted=state.accepted + acc0 + acc1,
        )

    return step


def make_step_fn(log_prob_fn: Callable, a: float = 2.0, moves=None):
    """Per-step transition ``step(state, move_index, gen) -> state`` and
    the normalized move weights (``moves=None`` is pure stretch).

    ``moves`` is a tuple of ``(name, weight)`` with names in {"stretch",
    "de", "snooker"}, each optionally parameterized as
    ``"name:key=val,..."``. The caller draws ``move_index`` per step from
    the weights (a random-scan mixture of reversible kernels keeps the
    posterior stationary).
    """
    names, weights = (("stretch",), (1.0,)) if moves is None else _normalize_moves(moves)
    branches = [_move_step(log_prob_fn, n, a) for n in names]

    def step(state, move_index, gen):
        return branches[move_index](state, gen)

    return step, weights


_PROGRESS_CHUNK = 8  # steps per progress-bar tick, as the JAX package


def run_ensemble(
    log_prob_fn: Callable, pos0, seed: int, n_steps: int, a: float = 2.0, moves=None,
    progress: bool = False,
):
    """Run ``n_steps`` full ensemble steps from ``pos0``.

    ``log_prob_fn`` is batched: (W, D) -> (W,). ``seed`` seeds the
    device generator of the proposals and the host draw of the move per
    step. Returns ``(chain, final_state)`` with ``chain`` of shape
    (n_steps, W, D), one sample per walker per step (emcee's
    ``get_chain`` layout). ``progress`` ticks a progress bar
    (:func:`~bask_tpu_torch.utils.progress.get_progress_bar`) every 8
    steps, as queued (the device may still run them); the chain is the
    same either way.
    """
    validate_walker_count(pos0.shape[0], moves)
    step, weights = make_step_fn(log_prob_fn, a=a, moves=moves)
    move_idx = np.random.RandomState(seed).choice(len(weights), size=n_steps, p=weights)
    gen = torch.Generator(device=pos0.device)
    gen.manual_seed(int(seed))
    state = init_ensemble(log_prob_fn, pos0)
    pbar = get_progress_bar(progress, n_steps)
    chain = []
    for i in range(n_steps):
        state = step(state, int(move_idx[i]), gen)
        chain.append(state.pos)
        if (i + 1) % _PROGRESS_CHUNK == 0 or i + 1 == n_steps:
            pbar.update((i % _PROGRESS_CHUNK) + 1)
    pbar.close()
    return torch.stack(chain), state


def flatten_chain(chain, discard: int = 0, thin: int = 1):
    """(n_steps, W, D) -> (n_kept * W, D), step-major like emcee
    ``get_chain(discard=, thin=, flat=True)``: the kept steps are
    ``discard + thin - 1, discard + 2 thin - 1, ...``."""
    kept = chain[discard + thin - 1 :: thin]
    return kept.reshape(-1, chain.shape[-1])
