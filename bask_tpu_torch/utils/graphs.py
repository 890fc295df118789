"""CUDA graphs of the port: capture, keys, caches and launch counts.

The chain's step (:mod:`bask_tpu_torch.parallel.mcmc`, a graph per
configuration and move) is captured on a configuration's first run
(:data:`CHAIN`). The geometric median's block of Weiszfeld iterations
(:mod:`bask_tpu_torch.utils.median`) is captured on a key's second call
(:data:`MEDIAN`): a key's first call runs eagerly, so one-off shapes never
pay a capture, and ``utils.warmup`` calls the median a second time. A
graph keeps the routes and matmul settings of its capture, so a key holds
them (``ops.linalg.route_key``, :func:`matmul_mode`). A capture launches
nothing; each replay adds to the kernel wrappers' ``.launches`` (set up by
:func:`counted`) the launches the capture counted.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

__all__ = ["counted", "capture", "Captured", "Cache", "matmul_mode", "CHAIN", "MEDIAN"]

MAX_ENTRIES = 8  # keys a cache keeps; the least recently used is freed first
WARM_RUNS = 3  # eager runs on the capture stream before a capture
COUNTED: list = []  # the wrappers whose launches a replay adds to
_STREAMS: dict = {}  # device -> its capture stream


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper that counts its launches in ``fn.launches``."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


class Captured(NamedTuple):
    """A graph and the ``(wrapper, launches)`` each of its replays adds."""

    graph: "torch.cuda.CUDAGraph"
    launches: tuple

    def replay(self):
        self.graph.replay()
        for f, n in self.launches:
            f.launches += n


def capture(body: Callable, warm: Callable, device, pool=None) -> Captured:
    """Run ``warm`` :data:`WARM_RUNS` times on the device's capture stream
    (the first uses of cuBLAS handles and their workspace, K4's tensor-map
    encoder and the allocator's blocks happen there, not in the capture),
    then capture ``body`` on that stream into a new graph of ``pool`` (a
    fresh pool where None). The launches each counted wrapper saw in the
    capture are what a replay adds; every counter is put back as it was
    before the warm-up (the capture launches nothing, and the warm-up runs
    are the capture's cost). Raises ``ValueError`` off CUDA."""
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph is captured on a CUDA device; got {device}")
    counters = tuple(COUNTED)
    start = [f.launches for f in counters]
    stream = _STREAMS.setdefault(device, torch.cuda.Stream(device))
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(WARM_RUNS):
            warm()
    torch.cuda.current_stream(device).wait_stream(stream)
    before = [f.launches for f in counters]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            body()
    finally:
        launches = tuple((f, f.launches - b) for f, b in zip(counters, before)
                         if f.launches != b)
        for f, n in zip(counters, start):
            f.launches = n
    return Captured(graph, launches)


def matmul_mode() -> tuple:
    """The float32 matmul settings (cuBLAS's math mode is fixed at capture)."""
    return torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32


class Cache(OrderedDict):
    """Up to :data:`MAX_ENTRIES` keys and their captured work, the least
    recently used freed first; with ``first_call=False`` a key's first call
    is remembered (its entry None) and its second captures."""

    def __init__(self, first_call: bool):
        super().__init__()
        self.first_call = first_call

    def entry(self, key, make: Callable):
        """``key``'s entry, ``make()`` where the key is captured now."""
        if key not in self:
            self[key] = make() if self.first_call else None
            while len(self) > MAX_ENTRIES:
                self.popitem(last=False)
            return self[key]
        self.move_to_end(key)
        if self[key] is None:
            self[key] = make()
        return self[key]


CHAIN = Cache(first_call=True)  # the chain's configurations
MEDIAN = Cache(first_call=False)  # the median's blocks
