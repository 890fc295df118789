"""Spans and counters inside the program, on the host's clock; off by
default.

``enable()`` turns tracing on for the process. Each ``span(name)`` then
records its name, its host start and end (``time.perf_counter_ns``), the
span it opened in and the id of the request it belongs to: a span opened
outside any other (``span.opt.tell``, ``span.opt.ask``, or ``span.gp.fit``
outside a tell) takes the next id, and every span opened inside it
inherits that id. On exit a span adds to its name's totals: the count,
its seconds, its self seconds (its time less its children's) and its
waited seconds (the ``span.wait`` spans beneath it; all of a wait's own
time). ``wait()`` is the span around one call that blocks the host on
the card (a readback; an upload from host memory, which first waits for
the stream; an operation that reads back a flag of its own, as eigh
does): the count of ``span.wait`` is the count of waits. The last
:data:`RING` records are kept for ``snapshot(records=True)``.

While a ``torch.profiler`` session records, each span and wait also
opens a ``torch.profiler.record_function`` of its name, with tracing on or
off, so the program's spans sit on the profiler's timeline, on the device
operations' clock, wherever a profile is taken. No span or wait
synchronizes the card or reads anything back: the program's time is read
as the program runs.

Off and outside a profiler session, ``span()`` and ``wait()`` return one
shared no-op object: no clock is read, no range is opened and nothing is
allocated.

Names are ``span.<layer>.<phase>`` (:data:`NAMES`). The chain and the
median open their capture and replay spans around :mod:`.graphs`, which
keeps the kernels' ``.launches`` counts; ``parallel.mcmc.graph_stats``
counts the chain's graphs.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch

__all__ = ["NAMES", "RING", "enable", "disable", "enabled", "reset", "snapshot", "span",
           "wait"]

# every span the program opens
NAMES = (
    "span.opt.tell", "span.opt.ask", "span.opt.refit", "span.opt.acquisition", "span.opt.grid",
    "span.gp.fit", "span.gp.ml2", "span.gp.objective", "span.gp.stage", "span.gp.consensus",
    "span.gp.warp", "span.gp.unwarp", "span.gp.median_capture", "span.gp.median_replay",
    "span.mcmc.run", "span.mcmc.init", "span.mcmc.capture", "span.mcmc.replays",
    "span.acq.fused", "span.acq.probes", "span.wait",
)
WAIT = "span.wait"
RING = 4096  # records kept for snapshot(records=True)

_on = False
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans
_totals = {}  # name -> [count, ns, self ns, waited ns]
_ring = deque(maxlen=RING)
_next_id = 0


class _Noop:
    """The span of tracing off outside a profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end_at(self, t_ns):
        pass


NOOP = _Noop()


class _Range:
    """The span of tracing off inside a profiler session: its range on the
    profiler's timeline, and nothing else."""

    __slots__ = ("_rf",)

    def __init__(self, name):
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False

    def end_at(self, t_ns):
        pass


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "start", "end", "parent", "id", "children", "waited", "_rf")

    def __init__(self, name, start):
        self.name, self.start, self.end = name, start, None
        self.children = self.waited = 0
        self._rf = None

    def end_at(self, t_ns: int):
        """End the span at the reading ``t_ns`` (``time.perf_counter_ns``)
        instead of at its exit, so that a caller's own readings and the
        span's are the same."""
        self.end = t_ns

    def __enter__(self):
        global _next_id
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.parent is None:
            with _lock:
                _next_id += 1
                self.id = _next_id
        else:
            self.id = self.parent.id
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.start is None:
            self.start = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.end is None:
            self.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _stack().pop()
        took = self.end - self.start
        waited = took if self.name == WAIT else self.waited
        parent = self.parent
        if parent is not None:
            parent.children += took
            parent.waited += waited
        with _lock:
            total = _totals.get(self.name)
            if total is None:
                total = _totals[self.name] = [0, 0, 0, 0]
            total[0] += 1
            total[1] += took
            total[2] += took - self.children
            total[3] += waited
            _ring.append((self.name, self.start, self.end,
                          None if parent is None else parent.name, self.id))
        return False


def enable():
    """Turn tracing on for the process."""
    global _on
    _on = True


def disable():
    """Turn tracing off; spans open now still record when they close."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Forget the totals and records (ids keep counting)."""
    with _lock:
        _totals.clear()
        _ring.clear()


def span(name: str, start_ns: int | None = None):
    """A context for the block, named ``name`` (one of :data:`NAMES`);
    ``start_ns`` (a ``time.perf_counter_ns`` reading) starts it at a
    reading the caller took. Off, the profiler's range alone, or the
    shared no-op outside a profiler session."""
    if _on:
        return _Span(name, start_ns)
    if torch.autograd._profiler_enabled():
        return _Range(name)
    return NOOP


def wait():
    """The span around one call that blocks the host on the card
    (``span.wait``)."""
    if _on:
        return _Span(WAIT, None)
    if torch.autograd._profiler_enabled():
        return _Range(WAIT)
    return NOOP


def snapshot(records: bool = False) -> dict:
    """What tracing holds now: ``spans`` (name -> count, seconds,
    self_seconds, wait_seconds), ``names`` (the program's own span names,
    :data:`NAMES`), and with ``records`` the last records (name, start_ns,
    end_ns, parent, id), oldest first."""
    with _lock:
        spans = {name: {"count": c, "seconds": ns / 1e9, "self_seconds": self_ns / 1e9,
                        "wait_seconds": waited / 1e9}
                 for name, (c, ns, self_ns, waited) in _totals.items()}
        out = {"names": list(NAMES), "spans": spans}
        if records:
            out["records"] = [dict(name=n, start_ns=s, end_ns=e, parent=p, id=i)
                              for n, s, e, p, i in _ring]
    return out
