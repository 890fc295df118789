"""Distribution helpers evaluated on the device.

PyTorch counterpart of the part of :mod:`bask_tpu.utils.stats` that input
warping needs: the normal log-density of its default warp prior.
"""

from __future__ import annotations

import math

import torch

__all__ = ["norm_logpdf"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def norm_logpdf(x, loc=0.0, scale=1.0):
    """log N(x; loc, scale^2), elementwise; ``scale`` a float or tensor.
    A float scale stays on the host: copying it to the card would make
    the host wait for the device on every call."""
    z = (x - loc) / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z * z - _LOG_SQRT_2PI - log_scale
