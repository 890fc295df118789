"""The share of the profiled consensuses whose geometric median replayed
its CUDA graph without capturing one: ``span.gp.consensus`` ranges that
hold a ``span.gp.median_replay`` and no ``span.gp.median_capture``, over
all of them. 1.0 where every warm tell's median replays; a median that
runs eagerly or captures again (a key seen anew) lowers it. Nothing to
read where the program opens no replay: a program that runs the median
eagerly."""

from portbench import program_spans


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def read(trace):
    spans = program_spans.of(trace)
    if spans is None:
        return None
    of = {n: [r for r in spans.ranges if r[0] == n] for n in (
        "span.gp.consensus", "span.gp.median_replay", "span.gp.median_capture")}
    consensuses, replays, captures = of.values()
    if not replays or not consensuses:
        return None
    clean = sum(1 for c in consensuses
                if any(_inside(r, c) for r in replays) and not any(_inside(r, c) for r in captures))
    return clean / len(consensuses)
