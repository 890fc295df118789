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


FAULTS = {"chain_half_stuck": chain_half_stuck}
