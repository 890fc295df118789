"""The program's eager warps per iteration: its ``span.gp.warp`` (a
consensus warp of the training points or the candidates) and
``span.gp.unwarp`` (the candidate grid's inverse warp and its readback)
ranges, over the profiled iterations. Nothing to read where the program
opens no such span: an unwarped cell, or a program without them."""

from portbench import program_spans

NAMES = ("span.gp.warp", "span.gp.unwarp")


def read(trace):
    spans = program_spans.of(trace)
    if spans is None:
        return None
    count = sum(1 for r in spans.ranges if r[0] in NAMES)
    return count / spans.units if count else None
