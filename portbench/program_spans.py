"""The program's own spans on the profiler's timeline, as the per-layer
readers of a traced run find them.

``bask_tpu_torch.utils.trace`` opens a profiler range for each of the
program's spans (``span.<layer>.<phase>``) while a profiler session
records, so the profiled stretch of a ``--trace 1`` run holds them among
its host ranges named ``span.`` (:attr:`core.Trace.host_spans`, beside the
harness's one-part names). A program without that module has no spans:
:func:`of` is then None, and a reader gives no reading. The readers count
ranges: the profiler's cost per range moves no count, where it would
move any time read from the ranges. "Per unit" is over the stretch's
units (the mix's ``trace_units``).
"""

from __future__ import annotations


def of(trace):
    """The program's spans in ``trace`` (a :class:`core.Trace`), or None
    where the program has no tracing module."""
    try:
        from bask_tpu_torch.utils import trace as program
    except ImportError:
        return None
    return Spans(trace, set(program.NAMES))


class Spans:
    """The program's ranges of a profiled stretch (``ranges``: (name,
    start_us, end_us))."""

    def __init__(self, trace, names):
        self.ranges = [r for r in trace.host_spans if r[0] in names]
        if not self.ranges:
            raise RuntimeError("the profiled stretch holds none of the program's spans")
        self.units = min(trace.units, trace.mix.get("trace_units", trace.units))

    def named(self, name: str) -> list:
        """The ranges of ``name``; raises where it never opened."""
        out = [r for r in self.ranges if r[0] == name]
        if not out:
            raise RuntimeError(f"the program's {name} never opened in the profiled stretch")
        return out

    def count_per_unit(self, name: str) -> float:
        return len(self.named(name)) / self.units
