"""Host ms a traced frame enqueuing the resolve (the span `las.resolve`): B3,
in HQS B4 and the divide, the colour lookup."""

from benchmark import program

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.span_ms(rec, "las.resolve")
