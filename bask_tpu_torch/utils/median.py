"""Geometric median (Weiszfeld with the Vardi-Zhang correction).

PyTorch counterpart of :mod:`bask_tpu.utils.median`. The JAX package
runs a ``while_loop`` until the step drops below ``eps``; here every
iteration is branchless on the device and a converged iterate is frozen
with ``torch.where``, so the result equals the early-stopping loop. The
host looks at the stop flag only every ``_CHECK_EVERY`` iterations, to
keep device-to-host syncs out of the loop body.

On a CUDA tensor a block of ``_CHECK_EVERY`` iterations is ~1,050 tiny
operations, so the loop costs its launches. The second call with the same
key (shape, strides, dtype, device, ``eps``, the float32 matmul settings)
captures one block in a CUDA graph over static buffers
(``span.gp.median_capture``), and that call and every later one replay it
(``span.gp.median_replay``) in the same loop, between the same stop
checks: the same operations on the same shapes, so the same result bit
for bit. CPU tensors always run eagerly. The capture, the rule that waits
for a key's second call and the cache are :mod:`bask_tpu_torch.utils.graphs`'s
(:data:`~bask_tpu_torch.utils.graphs.MEDIAN`).
"""

from __future__ import annotations

import math

import torch

from . import graphs, trace

__all__ = ["geometric_median"]

_CHECK_EVERY = 25


def _iteration(X, y, delta, eps: float):
    """One Weiszfeld step from ``y``; a step that starts below ``eps``
    (``delta``, the last step's length) leaves ``y`` and ``delta`` as
    they are."""
    n = X.shape[0]
    d = torch.linalg.vector_norm(X - y[None, :], dim=1)
    nonzero = d > 0.0
    dinv = torch.where(nonzero, 1.0 / torch.where(nonzero, d, 1.0), 0.0)
    dinv_sum = dinv.sum()
    T = (dinv @ X) / dinv_sum
    num_zeros = n - nonzero.sum()
    R = (T - y) * dinv_sum
    r = torch.linalg.vector_norm(R)
    rinv = torch.where(r > 0, num_zeros / torch.where(r > 0, r, 1.0), 0.0)
    y_vz = (
        torch.clamp(1.0 - rinv, min=0.0) * T
        + torch.clamp(rinv, max=1.0) * y
    )
    y1 = torch.where(num_zeros == 0, T, y_vz)
    y1 = torch.where(num_zeros == n, y, y1)
    active = delta >= eps
    delta = torch.where(active, torch.linalg.vector_norm(y1 - y), delta)
    y = torch.where(active, y1, y)
    return y, delta


def _eager_block(X, y, delta, eps: float):
    """``_CHECK_EVERY`` iterations, launched one by one."""
    for _ in range(_CHECK_EVERY):
        y, delta = _iteration(X, y, delta, eps)
    return y, delta


def _moving(delta, eps: float) -> bool:
    """The stop check: one readback."""
    with trace.wait():
        return bool(delta >= eps)


def _weiszfeld(X, eps: float, max_iter: int, block):
    """The loop, from the mean: blocks of ``_CHECK_EVERY`` iterations
    (``block(X, y, delta, eps)``, eager or replayed) with a stop check
    before each but the first, then the iterations past the last whole
    block, eagerly, after one more check. At most ``max_iter``
    iterations."""
    y = X.mean(dim=0)
    delta = torch.full((), math.inf, dtype=X.dtype, device=X.device)
    blocks, rest = divmod(max_iter, _CHECK_EVERY)
    for b in range(blocks):
        if b and not _moving(delta, eps):
            return y
        y, delta = block(X, y, delta, eps)
    if rest and blocks and not _moving(delta, eps):
        return y
    for _ in range(rest):
        y, delta = _iteration(X, y, delta, eps)
    return y


class _Block:
    """``_eager_block`` captured in a CUDA graph that reads ``X`` and
    advances ``y`` and ``delta`` in place, so replays chain."""

    def __init__(self, X, eps: float):
        self.X = torch.empty_strided(X.shape, X.stride(), dtype=X.dtype, device=X.device)
        self.y = torch.empty(X.shape[1:], dtype=X.dtype, device=X.device)
        self.delta = torch.empty((), dtype=X.dtype, device=X.device)
        # the warm-up's steps run on real values
        self.X.copy_(X)
        self.y.copy_(X.mean(dim=0))
        self.delta.fill_(math.inf)

        def body():
            y, delta = _eager_block(self.X, self.y, self.delta, eps)
            self.y.copy_(y)
            self.delta.copy_(delta)

        with trace.span("span.gp.median_capture"):
            self.graph = graphs.capture(body, body, X.device)

    def __call__(self, X, y, delta, eps: float):
        """One replayed block: a call's first block loads ``X``, ``y`` and
        ``delta`` into the graph's buffers; later blocks chain in them."""
        if y is not self.y:
            self.X.copy_(X)
            self.y.copy_(y)
            self.delta.copy_(delta)
        with trace.span("span.gp.median_replay"):
            self.graph.replay()
        return self.y, self.delta


def _key(X, eps: float) -> tuple:
    """Everything a block's graph fixes at capture besides its values."""
    return (tuple(X.shape), X.stride(), X.dtype, str(X.device), float(eps),
            *graphs.matmul_mode())


def _graphed(X, eps: float, max_iter: int):
    """The median through its key's graph: eager on the key's first call,
    captured on the second, replayed after."""
    block = graphs.MEDIAN.entry(_key(X, eps), lambda: _Block(X, float(eps)))
    if block is None:
        return _eager(X, eps, max_iter)
    y = _weiszfeld(X, eps, max_iter, block)
    # a result the eager tail did not replace is the graph's own buffer
    return y.clone() if y is block.y else y


def _eager(X, eps: float, max_iter: int):
    return _weiszfeld(X, eps, max_iter, _eager_block)


def geometric_median(X, eps: float = 1e-5, max_iter: int = 200):
    """Point minimizing the sum of Euclidean distances to the rows of X:
    (n, d) -> (d,)."""
    if X.is_cuda and max_iter >= _CHECK_EVERY:
        return _graphed(X, eps, max_iter)
    return _eager(X, eps, max_iter)
