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
randoms JAX drew to both packages and compare the updates exactly. A step
draws all of its randoms first, in the order the halves use them, then
applies the move.

CUDA graphs of the step (:class:`ChainGraph`) take the part of JAX's
compiled scan body. ``run_ensemble(graph=...)`` captures each move of the
chain once per configuration in a graph and replays it per step: the
graph reads its data (training inputs and targets, jitter, mask, and
``n_real`` as a device scalar) from buffers that each run refills, so one
capture serves every tell inside a padding bucket. The captures live in a
module-level cache (:data:`_GRAPH_CACHE`), as JAX's jit cache is global:
a warm-up clone's chain (``utils.warmup``) and the real loop's share
them. The randoms are drawn outside the graph, by the chain's own
generator, into the graph's static buffers, so a replayed chain equals
the eager chain bit for bit.

Detailed balance: the stretch factor is z = ((a-1)u + 1)^2 / a, with
acceptance factor z^(D-1) * exp(lp(prop) - lp(curr)); DE proposals are
symmetric; snooker needs the (|x' - z| / |x - z|)^(D-1) Jacobian.
Proposals with a -inf or NaN log-ratio are rejected (NaN compares
False).
"""

from __future__ import annotations

import math
from collections import OrderedDict
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
    "ChainGraph",
    "CHAIN_GRAPHS",
    "graph_stats",
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


def _half_specs(base, h, c, D):
    """The randoms of one half-update of move ``base`` (``h`` walkers
    against ``c``), in the order the update reads them: ("i", shape, high)
    integers in [0, high), ("u", shape) uniforms, ("n", shape) normals."""
    if base == "stretch":  # partners, u, u_accept
        return [("i", (h,), c), ("u", (h,), None), ("u", (h,), None)]
    if base == "de":  # j, k_raw, eps, u_accept
        return [("i", (h,), c), ("i", (h,), c - 1), ("n", (h, D), None), ("u", (h,), None)]
    # snooker: iz, i1_raw, i2_raw, u_accept
    return [("i", (h,), c), ("i", (h,), c - 1), ("i", (h,), c - 2), ("u", (h,), None)]


def _step_specs(base, W, D):
    """The randoms of one full step at (W, D): DE's step-wide jump
    uniform, then the first half's, then the second half's."""
    half = W // 2
    jump = [("u", (), None)] if base == "de" else []
    return jump + _half_specs(base, half, W - half, D) + _half_specs(base, W - half, half, D)


def _draw(gen, specs, like, out=None):
    """The randoms of ``specs`` from ``gen`` on ``like``'s device (floats
    in its dtype), each written into a new tensor or into ``out``'s."""
    drawn = []
    for k, (kind, shape, high) in enumerate(specs):
        if out is None:
            t = torch.empty(shape, dtype=torch.int64 if kind == "i" else like.dtype,
                            device=like.device)
        else:
            t = out[k]
        if kind == "i":
            torch.randint(0, high, shape, generator=gen, out=t)
        elif kind == "u":
            torch.rand(shape, generator=gen, out=t)
        else:
            torch.randn(shape, generator=gen, out=t)
        drawn.append(t)
    return drawn


def _accept(active, lp_active, prop, lp_prop, log_ratio, u_acc):
    accept = torch.log(u_acc) < log_ratio
    new_active = torch.where(accept[:, None], prop, active)
    new_lp = torch.where(accept, lp_prop, lp_active)
    return new_active, new_lp, accept.sum()


def draw_stretch(gen, h, c, like):
    """(partners, u, u_accept): the draws of one stretch half-update."""
    return tuple(_draw(gen, _half_specs("stretch", h, c, like.shape[1]), like))


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
    return tuple(_draw(gen, _half_specs("de", h, c, like.shape[1]), like))


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
    return tuple(_draw(gen, _half_specs("snooker", h, c, like.shape[1]), like))


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
    """One full ensemble step of move ``name``, as (specs, apply):
    ``specs(W, D)`` lists the step's randoms (:func:`_step_specs`) and
    ``apply(pos, log_prob, draws)`` -> (pos, log_prob, accepted moves)
    updates the two halves in turn with them."""
    base, p = _parse_move(name)
    n_half = len(_half_specs(base, 1, 1, 1))

    def apply(pos, lp, draws):
        W, D = pos.shape
        half = W // 2
        if base == "stretch":
            a_eff = p.get("a", a)

            def update(act, lpa, oth, dr):
                return stretch_half_update(log_prob_fn, act, lpa, oth, dr, a_eff)

        elif base == "de":
            gamma0 = p.get("gamma", 2.38 / (2.0 * D) ** 0.5)
            sigma = p.get("sigma", 1e-5)
            # the step-wide full-difference "mode jump" with prob. jump
            jump, draws = draws[0] < p.get("jump", 0.1), draws[1:]
            gamma = torch.where(jump, 1.0, gamma0).to(pos.dtype)

            def update(act, lpa, oth, dr):
                return de_half_update(log_prob_fn, act, lpa, oth, dr, gamma, sigma)

        else:
            gamma_s = p.get("gammas", 1.7)

            def update(act, lpa, oth, dr):
                return snooker_half_update(log_prob_fn, act, lpa, oth, dr, gamma_s)

        first, lp1, acc0 = update(pos[:half], lp[:half], pos[half:], draws[:n_half])
        second, lp2, acc1 = update(pos[half:], lp[half:], first, draws[n_half:])
        return torch.cat([first, second]), torch.cat([lp1, lp2]), acc0 + acc1

    return (lambda W, D: _step_specs(base, W, D)), apply


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
        specs, apply = branches[move_index]
        pos = state.pos
        new_pos, new_lp, acc = apply(pos, state.log_prob, _draw(gen, specs(*pos.shape), pos))
        return EnsembleState(pos=new_pos, log_prob=new_lp, accepted=state.accepted + acc)

    return step, weights


_PROGRESS_CHUNK = 8  # steps per progress-bar tick, as the JAX package

# "off" runs every chain eagerly, graph or not (an A/B switch for timing)
CHAIN_GRAPHS = "on"
# graphs captured and replayed in this process (a capture is per
# configuration and move; a replay is one step)
graph_stats = {"captures": 0, "replays": 0}
_GRAPH_CACHE_MAX = 8  # configurations kept; the oldest is freed first
_WARM_STEPS = 3  # eager steps on the capture stream before a capture


class ChainGraph(NamedTuple):
    """A log-probability that :func:`run_ensemble` may capture in CUDA
    graphs.

    ``inputs`` are the tensors it reads (for the GP: X, y, the jitter, the
    mask, ``n_real`` as a 1-element int32 tensor), ``inputs[0]`` the
    (n_pad, d) training inputs; ``build(buffers)`` returns the batched
    log-probability over buffers shaped like them; ``key`` (hashable)
    names everything else its captured work depends on (the fused spec,
    the priors, the warp)."""

    key: tuple
    inputs: tuple
    build: Callable


_GRAPH_CACHE: "OrderedDict[tuple, _ChainEntry]" = OrderedDict()
_CAPTURE_STREAMS: dict = {}


def _entry_key(graph: ChainGraph, W: int, D: int, dtype, device) -> tuple:
    """The cache key of a configuration: everything that changes the work
    a step's graph captured, besides the move (:func:`_branch_key`)."""
    from ..ops import gram

    n_pad_d = tuple(graph.inputs[0].shape[-2:])
    return (
        str(device), dtype, int(W), int(D),
        tuple((tuple(t.shape), t.dtype) for t in graph.inputs),
        graph.key,
        gram.LOWER_GRAM, gram._K4_ROUTE.get(n_pad_d),
        torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
    )


def _branch_key(name: str, a: float) -> tuple:
    """A move of the mixture with its parameters (``a``: stretch's default)."""
    return (name, float(a))


def _launch_counters():
    """The kernel wrappers' launch counts, which a replay adds to."""
    from ..ops import chol_base, gram

    return (gram.fused_masked_gram_batch, gram.fused_masked_gram_lower_batch,
            gram.fused_masked_gram_wb_batch, chol_base.chol_inv_base)


class _Branch(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    specs: list  # the step's randoms, drawn into ``draws`` before a replay
    draws: list
    launches: tuple  # each counter's launches per replay


class _ChainEntry:
    """One configuration's buffers and its moves' graphs (one memory pool)."""

    def __init__(self, graph: ChainGraph, W: int, D: int, dtype, device):
        self.inputs = tuple(torch.empty_like(t) for t in graph.inputs)
        self.log_prob = graph.build(self.inputs)
        self.pos = torch.empty((W, D), dtype=dtype, device=device)
        self.lp = torch.empty((W,), dtype=dtype, device=device)
        self.accepted = torch.zeros((), dtype=torch.int64, device=device)
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.branches: dict = {}

    def capture(self, name: str, a: float) -> _Branch:
        """The step of move ``name`` in a graph (:func:`_capture_step`),
        with its draw buffers and its launches per replay. The step leaves
        its result in the state buffers, so replays chain."""
        specs_of, apply = _move_step(self.log_prob, name, a)
        specs = specs_of(*self.pos.shape)
        draws = _draw(torch.Generator(device=self.pos.device).manual_seed(0), specs, self.pos)
        warm_gen = torch.Generator(device=self.pos.device).manual_seed(1)

        def body():
            pos, lp, acc = apply(self.pos, self.lp, draws)
            self.pos.copy_(pos)
            self.lp.copy_(lp)
            self.accepted.add_(acc)

        def warm():  # throwaway randoms; the state buffers change
            _draw(warm_gen, specs, self.pos, out=draws)
            body()

        counters = _launch_counters()
        try:
            graph, launches = _capture_step(body, warm, self.pool, self.pos.device, counters)
        except Exception as e:
            raise RuntimeError(
                f"the chain step of move {name!r} could not be captured in a CUDA "
                f"graph ({type(e).__name__}: {e}); a prior or kernel that syncs with "
                "the host cannot run in a graph (mcmc.CHAIN_GRAPHS = 'off' runs "
                "every chain eagerly)"
            ) from e
        graph_stats["captures"] += 1
        return _Branch(graph, specs, draws, launches)


def _capture_step(body, warm, pool, device, counters):
    """Run ``warm`` ``_WARM_STEPS`` times on the device's capture stream
    (the first uses of cuBLAS handles and their workspace, K4's tensor-map
    encoder and the allocator's blocks happen there, not in the capture),
    then capture ``body`` on that stream into a new graph of ``pool``.
    Returns the graph and the launches each counter saw in the capture
    (its replays add them). The counters are put back as they were before
    the warm-up: the capture launches nothing, and the warm-up steps are
    the capture's cost, not steps of the chain."""
    if device.type != "cuda":
        raise ValueError(f"a graphed chain runs on a CUDA device; got {device}")
    start = [f.launches for f in counters]
    stream = _CAPTURE_STREAMS.setdefault(device, torch.cuda.Stream(device))
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(_WARM_STEPS):
            warm()
    torch.cuda.current_stream(device).wait_stream(stream)
    before = [f.launches for f in counters]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            body()
    finally:
        launches = tuple(f.launches - b for f, b in zip(counters, before))
        for f, n in zip(counters, start):
            f.launches = n
    return graph, launches


def _chain_entry(graph: ChainGraph, W: int, D: int, dtype, device) -> _ChainEntry:
    key = _entry_key(graph, W, D, dtype, device)
    entry = _GRAPH_CACHE.get(key)
    if entry is None:
        entry = _GRAPH_CACHE[key] = _ChainEntry(graph, W, D, dtype, device)
        while len(_GRAPH_CACHE) > _GRAPH_CACHE_MAX:
            _GRAPH_CACHE.popitem(last=False)
    _GRAPH_CACHE.move_to_end(key)
    return entry


def _run_graphed(graph, log_prob_fn, pos0, gen, names, a, move_idx, pbar):
    """:func:`run_ensemble`'s loop on replayed graphs: the same randoms
    from ``gen`` in the same order, the same operations per step."""
    W, D = pos0.shape
    device = pos0.device
    entry = _chain_entry(graph, W, D, pos0.dtype, device)
    for buf, src in zip(entry.inputs, graph.inputs):
        buf.copy_(src)
    lp0 = log_prob_fn(pos0)
    keys = [_branch_key(n, a) for n in names]
    for m in sorted(set(move_idx.tolist())):
        if keys[m] not in entry.branches:
            entry.pos.copy_(pos0)
            entry.lp.copy_(lp0)
            entry.branches[keys[m]] = entry.capture(names[m], a)
    entry.pos.copy_(pos0)
    entry.lp.copy_(lp0)
    entry.accepted.zero_()
    counters = _launch_counters()
    n_steps = len(move_idx)
    chain = torch.empty((n_steps, W, D), dtype=pos0.dtype, device=device)
    for i in range(n_steps):
        br = entry.branches[keys[move_idx[i]]]
        _draw(gen, br.specs, entry.pos, out=br.draws)
        br.graph.replay()
        chain[i].copy_(entry.pos)
        for f, n in zip(counters, br.launches):
            f.launches += n
        if (i + 1) % _PROGRESS_CHUNK == 0 or i + 1 == n_steps:
            pbar.update((i % _PROGRESS_CHUNK) + 1)
    graph_stats["replays"] += n_steps
    pbar.close()
    return chain, EnsembleState(
        pos=entry.pos.clone(), log_prob=entry.lp.clone(), accepted=entry.accepted.clone()
    )


def run_ensemble(
    log_prob_fn: Callable, pos0, seed: int, n_steps: int, a: float = 2.0, moves=None,
    progress: bool = False, graph: ChainGraph | None = None,
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

    ``graph`` (a :class:`ChainGraph` of the same log-probability, CUDA
    tensors) replays each step from a CUDA graph of its move, captured on
    the configuration's first run; the chain is the eager one bit for bit.
    A step that cannot be captured or replayed raises. With
    :data:`CHAIN_GRAPHS` ``"off"`` the graph is ignored.
    """
    validate_walker_count(pos0.shape[0], moves)
    names, weights = (("stretch",), (1.0,)) if moves is None else _normalize_moves(moves)
    move_idx = np.random.RandomState(seed).choice(len(weights), size=n_steps, p=weights)
    gen = torch.Generator(device=pos0.device)
    gen.manual_seed(int(seed))
    pbar = get_progress_bar(progress, n_steps)
    if graph is not None and CHAIN_GRAPHS == "on":
        return _run_graphed(graph, log_prob_fn, pos0, gen, names, a, move_idx, pbar)
    step, _ = make_step_fn(log_prob_fn, a=a, moves=moves)
    state = init_ensemble(log_prob_fn, pos0)
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
