"""What every loop of ``portbench/loops/`` shares: the run's parameters,
the recorders, the wrappers, the objective, the kernel and the options a
configuration hands to the program.

A loop takes a :class:`Run` and returns a dict: ``attempted`` and
``failed`` units, ``metrics`` (the end-to-end values it measures),
``records`` (what its check judges), ``state`` (the program's objects,
dropped before the check runs) and ``info`` (printed on an earlier line).

The windows drive public entry points of ``bask_tpu_torch`` only. Two
kinds of pass-through wrappers sit on internal entries: recorders, in
every run, that keep a checked unit's intermediate outputs (the chain's
start and end, the candidate grid with the acquisition's values and its
probes, the draws' inputs and the values of the checked draws, a warped
grid's uniforms), and, in a traced run only, spans with a device
synchronize at both edges and notes of the shapes with which the program
launched the kernels whose rooflines are read.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import core


@dataclass
class Run:
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: object
    tracer: object = None  # core.Tracer in a traced run
    sample_share: float = None  # overrides the mix's share of checked units
    window: object = field(default=None, init=False)
    marks: list = field(default_factory=list, init=False)

    def mark(self, name: str):
        """The end of a part of set-up (printed with ``setup_s`` split)."""
        self.marks.append((name, time.perf_counter()))

    def make_window(self):
        from bask_tpu_torch.parallel import mcmc

        self.window = core.Window(self.seconds, self.mix.get("trace_units", 0) if self.tracer
                                  else 0, self.tracer,
                                  lambda: {"graph_captures": mcmc.graph_stats["captures"]})
        return self.window

    def checked(self, unit: int) -> bool:
        """Whether the correctness check judges this unit of the window:
        drawn from the seed, the same units for every run of a seed."""
        share = self.mix["sample_share"] if self.sample_share is None else self.sample_share
        return unit == 0 or bool(core.rng(self.seed, 9, unit).uniform() < share)


class Recorder:
    """What the wrapped entries produced during a checked unit."""

    def __init__(self):
        self.active = False
        self.kept = {}

    def put(self, **values):
        self.kept.update(values)

    def take(self) -> dict:
        kept, self.kept = self.kept, {}
        return kept


@contextlib.contextmanager
def wrapped(owner, attr, around):
    """``owner.attr`` replaced by ``around(original, *args, **kwargs)`` for
    the block."""
    original = getattr(owner, attr)

    def wrapper(*args, **kwargs):
        return around(original, *args, **kwargs)

    setattr(owner, attr, wrapper)
    try:
        yield
    finally:
        setattr(owner, attr, original)


def spans(stack, tracer, entries):
    """Spans named ``span.<name>`` around each (owner, attr, name) entry,
    in a traced run."""
    if tracer is None:
        return
    for owner, attr, name in entries:
        def around(original, *args, _name=f"span.{name}", **kwargs):
            with tracer.span(_name):
                return original(*args, **kwargs)
        stack.enter_context(wrapped(owner, attr, around))


def keep_chain(stack, rec, tracer):
    """Keep each checked unit's chain: its start, its end and the
    log-probabilities the program holds at the end (the last
    ``run_ensemble`` call of the unit). In a traced run, also count the
    steps each call runs and time it as ``span.chain``."""
    from bask_tpu_torch.models import bayesgpr

    def around(original, log_prob, pos0, seed, n_steps, *args, **kwargs):
        start = pos0.detach().clone() if rec.active else None
        if tracer is None:
            out = original(log_prob, pos0, seed, n_steps, *args, **kwargs)
        else:
            tracer.count("chain_steps", int(n_steps))
            with tracer.span("span.chain"):
                out = original(log_prob, pos0, seed, n_steps, *args, **kwargs)
        if rec.active:
            final = out[1]
            rec.put(chain_start=start, chain_end=final.pos.detach().clone(),
                    chain_end_lp=final.log_prob.detach().clone())
        return out
    stack.enter_context(wrapped(bayesgpr, "run_ensemble", around))


def note_k4(stack, tracer):
    """In a traced run, note the shape of every K4 launch (the gram of
    shared X), those captured into the chain's graphs included."""
    if tracer is None:
        return
    from bask_tpu_torch.ops import gram

    def around(original, entry, multiple, spec, thetas, X, *args, **kwargs):
        if entry == "bask_gram_wb_f32":
            tracer.note_launch("K4", B=int(thetas.shape[0]), n_pad=int(X.shape[-2]),
                               d=int(X.shape[-1]))
        return original(entry, multiple, spec, thetas, X, *args, **kwargs)
    stack.enter_context(wrapped(gram, "_launch", around))


def note_k5(stack, tracer, n_real: int):
    """In a traced run, note the shape of every K5 call (the pathwise
    draws' values): ``query`` where it adds the kernel term over the
    ``n_real`` training points, as the draws at the candidates do."""
    if tracer is None:
        return
    from bask_tpu_torch.models import pathwise

    def around(original, nu, Xq, omega, phase, W, coef, X=None, *args, **kwargs):
        if Xq.is_cuda:
            tracer.note_launch("K5", B=int(omega.shape[0]) if omega.ndim == 3 else 1,
                               m=int(Xq.shape[-2]), M=int(omega.shape[-2]),
                               d=int(omega.shape[-1]), R=int(W.shape[-1]),
                               n=int(n_real) if X is not None else 0,
                               n_pad=int(X.shape[-2]) if X is not None else 0,
                               query=X is not None)
        return original(nu, Xq, omega, phase, W, coef, X, *args, **kwargs)
    stack.enter_context(wrapped(pathwise, "pathwise_values", around))


def note_warps(stack, tracer):
    """In a traced run, note the shape of every K6 launch (the input warp:
    B warps of n rows of d columns, X shared or one per warp) and K7
    launch (its inverse: n rows to a bracket of 2^-``n_iter``), at the
    entries that launch them on the card."""
    if tracer is None:
        return
    import torch

    from bask_tpu_torch.ops import warp_values

    def k6(original, X, log_alphas, log_betas, with_pdf=False):
        batch = torch.broadcast_shapes(X.shape[:-2], log_alphas.shape[:-1])
        tracer.note_launch("K6", B=int(torch.Size(batch).numel()), n=int(X.shape[-2]),
                           d=int(X.shape[-1]), shared=X.ndim == 2, pdf=bool(with_pdf),
                           itemsize=X.element_size())
        return original(X, log_alphas, log_betas, with_pdf)

    def k7(original, Z, log_alphas, log_betas, n_iter=60):
        tracer.note_launch("K7", n=int(Z.shape[-2]), d=int(Z.shape[-1]), n_iter=int(n_iter),
                           itemsize=Z.element_size())
        return original(Z, log_alphas, log_betas, n_iter)
    stack.enter_context(wrapped(warp_values, "_launch_warp", k6))
    stack.enter_context(wrapped(warp_values, "_launch_unwarp", k7))


def bowl(X, rng, noise):
    """The objective of every mix: a bowl centred in the unit cube, with
    Gaussian noise of standard deviation ``noise`` drawn from ``rng``."""
    X = np.atleast_2d(np.asarray(X, dtype=float))
    return np.sum((X - 0.5) ** 2, axis=1) + noise * rng.randn(X.shape[0])


def make_kernel(kcfg: dict, d: int):
    """``ConstantKernel * Matern(nu, ARD)``, ``+ WhiteKernel`` where the
    configuration gives a noise level."""
    from bask_tpu_torch.ops import kernels as bk

    kernel = bk.ConstantKernel(kcfg["amplitude"], tuple(kcfg["amplitude_bounds"])) * bk.Matern(
        (kcfg["lengthscale"],) * d, tuple(kcfg["lengthscale_bounds"]), nu=kcfg["nu"])
    if "noise" in kcfg:
        kernel = kernel + bk.WhiteKernel(kcfg["noise"], tuple(kcfg["noise_bounds"]))
    return kernel


def optimizer(run: Run, n_initial_points: int, acq_func: str, sample_kwargs: dict):
    """An ``Optimizer`` over [0, 1]^d with the configuration's kernel, and
    its ``gp_kwargs`` and ``optimizer_kwargs`` handed through unchanged."""
    from bask_tpu_torch import Optimizer

    cfg = run.cfg
    return Optimizer(
        dimensions=[(0.0, 1.0)] * cfg["d"], n_initial_points=n_initial_points,
        gp_kernel=make_kernel(cfg["kernel"], cfg["d"]), gp_kwargs=dict(cfg["gp_kwargs"]),
        acq_func=acq_func, random_state=core.seed32(run.seed, 1), device=run.device,
        gp_sample_kwargs={"n_walkers_per_thread": cfg["walkers"], **sample_kwargs},
        **cfg["optimizer_kwargs"],
    )


def inside(x, d) -> bool:
    x = np.asarray(x, dtype=float)
    return x.shape == (d,) and bool(np.isfinite(x).all()) and bool(((x >= 0) & (x <= 1)).all())


def report_failure(failures: list):
    if not failures:
        traceback.print_exc(file=sys.stderr)
    failures.append(1)
