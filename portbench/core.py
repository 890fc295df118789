"""The harness's shared pieces: names resolved to files, seeds, the
measured window, spans and the reading of a profiler trace.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic mix, ``configs/<config>.json`` holds the
sizes and the options handed to the program, ``traffic/<mix>.json`` the
loop's parameters and the name of the loop that runs them
(``loops/<loop>.py``, with its ``run`` and the ``numbers`` its check
compares), ``limits/<cell>.json`` the limit of each of those numbers, and
``metrics/<metric>.py`` the reader of each per-layer metric. A new cell,
configuration, mix, loop or metric is a new file.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import re
import resource
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the top-level modules no run may load: the JAX package, its reference
# library and its benchmarks, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bask_tpu", "bask", "benchmarks")


def forbidden_loaded(modules) -> list:
    """The forbidden top-level names among ``modules`` (module names),
    each compared whole: ``bask_tpu_torch`` is not ``bask_tpu``."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN_MODULES))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return load_json(root / entry["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def loop(name: str):
    """The module ``loops/<name>.py``: ``run(Run) -> dict`` and
    ``numbers(records, cfg, mix, side, device) -> dict``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"no loop may be named {name!r}")
    return importlib.import_module(f"portbench.loops.{name}")


def metric_reader(name: str):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, kind: str, cell_name: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it, and those without a ``workloads`` key that move (or
    are) an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def seed32(seed: int, *path: int) -> int:
    """A 32-bit seed for the part of a run named by ``path`` (whole
    numbers >= 0), drawn from the run's ``seed`` (any whole number)."""
    entropy = [int(seed) % 2**64, *map(int, path)]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def rng(seed: int, *path: int) -> np.random.RandomState:
    """A NumPy generator for the part of a run named by ``path``."""
    return np.random.RandomState(seed32(seed, *path))


def _host_reading() -> dict:
    """The process's CPU seconds, page faults and context switches, and
    the machine's stolen CPU seconds (``/proc/stat``, where there is one):
    the window's share of them tells a slow host from slow work."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": ru.ru_utime, "system_s": ru.ru_stime, "minor_faults": ru.ru_minflt,
           "voluntary_switches": ru.ru_nvcsw, "involuntary_switches": ru.ru_nivcsw,
           "gc_collections_gen2": gc.get_stats()[2]["collections"]}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        out["machine_steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


class Window:
    """The measured window: opens with :meth:`start`, and stays open for
    units started before ``seconds`` had passed, so it closes at the
    first unit boundary after them. With a ``tracer`` the first
    ``trace_units`` units run under the device profiler. ``counters()``
    (a dict of counts) is read at both ends: ``counted`` is what the
    window added (the chain graphs captured in it, say)."""

    def __init__(self, seconds: float, trace_units: int = 0, tracer=None, counters=None):
        self.seconds = float(seconds)
        self.trace_units = int(trace_units)
        self.tracer = tracer
        self.counters = counters or (lambda: {})
        self.units = 0
        self.t0 = self.t1 = None
        self.counted, self.host = {}, {}

    def start(self):
        """Open the window. Set-up's objects are collected, then frozen out
        of the collector's reach, so that a full collection inside the
        window walks only what the window made."""
        if self.tracer is not None:
            self.tracer.reset()
        gc.collect()
        gc.freeze()
        self._before = self.counters()
        self._host = _host_reading()
        self.t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.in_window = True
            if self.trace_units:
                self.tracer.start_profile()

    def open(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds

    def unit_done(self):
        self.units += 1
        if self.tracer is not None and self.units == self.trace_units:
            self.tracer.stop_profile()

    def close(self):
        self.t1 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.stop_profile()
            self.tracer.in_window = False
        after = self.counters()
        self.counted = {k: after[k] - self._before[k] for k in after}
        host = _host_reading()
        self.host = {k: host[k] - self._host[k] for k in host}

    @property
    def length(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Spans around calls into the program's layers, each ended by a
    device synchronize at both edges, and one profiler session over the
    window's first units. Only a run with ``--trace 1`` makes one."""

    def __init__(self, torch):
        self.torch = torch
        self.spans = {}  # name -> [seconds, count]
        self.counts = {}
        self.prof = None
        self.profiled = None  # the closed profiler session
        self._depth = {}
        self.launches = []  # what note_launch saw, set-up's too
        self.in_window = False

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block; a span nested in one of its own name (a method
        that calls itself) counts once, as the outermost."""
        depth = self._depth.get(name, 0)
        self._depth[name] = depth + 1
        if depth:
            try:
                yield
            finally:
                self._depth[name] = depth
            return
        sync = self.torch.cuda.synchronize if self.torch.cuda.is_available() else (lambda: None)
        sync()
        t0 = time.perf_counter()
        try:
            with self.torch.profiler.record_function(name):
                yield
                sync()
        finally:
            total = self.spans.setdefault(name, [0.0, 0])
            total[0] += time.perf_counter() - t0
            total[1] += 1
            self._depth[name] = depth

    def reset(self):
        """Forget the spans and counts of set-up: the window's own start."""
        self.spans, self.counts = {}, {}

    def count(self, name: str, n: int = 1):
        self.counts[name] = self.counts.get(name, 0) + n

    def note_launch(self, kernel: str, **shape):
        """A kernel's launch as the program made it, with its shape: taken
        while a CUDA graph was being captured (its replays repeat it), in
        the window, in the profiled stretch."""
        capturing = self.torch.cuda.is_available() and self.torch.cuda.is_current_stream_capturing()
        self.launches.append(dict(kernel=kernel, captured=bool(capturing),
                                  window=self.in_window, profiled=self.prof is not None,
                                  **shape))

    def start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._stretch = self.torch.profiler.record_function("portbench.stretch")
        self._stretch.__enter__()

    def stop_profile(self):
        if self.prof is None:
            return
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._stretch.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.profiled, self.prof = self.prof, None

    def profiled_events(self):
        """(events, stretch start, stretch end) of the session, read once
        the window has closed: reading the events takes seconds."""
        events = list(self.profiled.events())
        stretch = [e for e in events if e.name == "portbench.stretch"]
        return events, stretch[0].time_range.start, stretch[0].time_range.end


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What a traced run read, handed to every per-layer metric reader:
    ``spans`` (name -> (seconds, count)), ``counts``, ``launches`` (what
    :meth:`Tracer.note_launch` saw), ``units`` of the window, the device
    operations of the profiled stretch (``device_ops``:
    (name, start_us, end_us)), its length (``window_s``) and the union of
    its device intervals (``busy_s``), the cell's configuration and mix."""

    def __init__(self, tracer: Tracer, units: int, cfg: dict, mix: dict):
        self.spans = {k: tuple(v) for k, v in tracer.spans.items()}
        self.counts = dict(tracer.counts)
        self.launches = list(tracer.launches)
        self.units = units
        self.cfg, self.mix = cfg, mix
        self.device_ops, self.host_spans = [], []
        self.window_s = self.busy_s = None
        self._busy = []
        if tracer.profiled is None:
            return
        events, lo, hi = tracer.profiled_events()
        for e in events:
            start, end = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if end <= start:
                continue
            if e.name.startswith(("span.", "portbench.")):
                # the spans' own ranges (on the host, and mirrored on the
                # device's timeline, where they are no device work)
                if e.device_type.name != "CUDA" and e.name.startswith("span."):
                    self.host_spans.append((e.name, start, end))
            elif e.device_type.name == "CUDA":
                self.device_ops.append((e.name, start, end))
        self._busy = _union((a, b) for _, a, b in self.device_ops)
        self.window_s = (hi - lo) / 1e6
        self.busy_s = sum(b - a for a, b in self._busy) / 1e6
        self._lo, self._hi = lo, hi

    def span_seconds(self, name: str):
        seconds, count = self.spans.get(name, (0.0, 0))
        return seconds if count else None

    def kernel_us(self, key: str) -> list:
        """Device microseconds of each profiled operation whose name holds
        ``key``, in the order they started."""
        return [b - a for name, a, b in sorted(self.device_ops, key=lambda op: op[1])
                if key in name]

    def launched(self, kernel: str, **flags) -> list:
        """The noted launches of ``kernel`` whose flags (``captured``,
        ``window``, ``profiled``) have the given values."""
        return [x for x in self.launches if x["kernel"] == kernel
                and all(x[k] == v for k, v in flags.items())]

    def require(self, *keys: str):
        """Raise unless the profiled stretch ran a kernel of each name: a
        share read from a trace that missed the cell's kernels is no
        reading."""
        missing = [k for k in keys if not self.kernel_us(k)]
        if missing:
            raise RuntimeError(f"the profiler recorded no {missing} in the traced stretch")

    def idle_pct(self):
        if not self.window_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        """The ten device operations that took most time (by name), and the
        ten longest idle gaps, each named by the innermost span open over
        its middle."""
        by_name = {}
        for name, a, b in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        edges = [self._lo] + [x for ab in self._busy for x in ab] + [self._hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = 0.5 * (a + b)
            inside = [(e - s, n) for n, s, e in self.host_spans if s <= mid <= e]
            label = min(inside)[1] if inside else "outside any span"
            named.append([label, (b - a) / 1e6])
        return {"device_ops": [[n[:120], s] for n, s in top], "idle_gaps": named}
