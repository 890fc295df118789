"""The program's calls that block the host on the card, per iteration
(readbacks, uploads, eigh): its ``span.wait`` ranges, over the profiled
iterations."""

from portbench import program_spans


def read(trace):
    spans = program_spans.of(trace)
    return None if spans is None else spans.count_per_unit("span.wait")
