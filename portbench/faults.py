"""Faults planted in the program under a run, to show that ``correct``
comes out false where its timed path is broken. The benchmark's own runs
plant none: the tests plant them on the CPU, and ``control.py --fault``
reads the numbers under one at a cell's own size on the card."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def chain_half_stuck():
    """The second half-update of every chain step returns its state: half
    of the walkers never move (the captured graphs take the fault in)."""
    from bask_tpu_torch.parallel import mcmc

    original, calls = mcmc._accept, [0]

    def accept(active, lp_active, *args):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return active, lp_active, torch.zeros((), dtype=torch.int64, device=active.device)
        return original(active, lp_active, *args)

    mcmc._accept = accept
    try:
        yield
    finally:
        mcmc._accept = original


@contextlib.contextmanager
def draw_consensus_warp():
    """Each pathwise draw of an ask warps the training points and the grid
    by the consensus warp, not by its own chain row's."""
    from bask_tpu_torch.models import warping
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    split, ask = warping.split_warp_params, BayesGPR.thompson_argmin_pathwise
    consensus = []

    def shared_split(x, n_dims):
        theta, la, lb = split(x, n_dims)
        if consensus:
            la_c, lb_c = consensus[-1]
            la, lb = la_c.to(la).expand_as(la), lb_c.to(lb).expand_as(lb)
        return theta, la, lb

    def draws(self, *args, **kwargs):
        consensus.append(self._warp_params())
        try:
            return ask(self, *args, **kwargs)
        finally:
            consensus.pop()

    warping.split_warp_params, BayesGPR.thompson_argmin_pathwise = shared_split, draws
    try:
        yield
    finally:
        warping.split_warp_params, BayesGPR.thompson_argmin_pathwise = split, ask


@contextlib.contextmanager
def grid_not_unwarped():
    """The warped candidate grid is handed on as drawn, uniform in the
    warped space: its inverse warp returns its input."""
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    unwarp = BayesGPR.unwarp
    BayesGPR.unwarp = lambda self, X: X
    try:
        yield
    finally:
        BayesGPR.unwarp = unwarp


FAULTS = {"chain_half_stuck": chain_half_stuck, "draw_consensus_warp": draw_consensus_warp,
          "grid_not_unwarped": grid_not_unwarped}
