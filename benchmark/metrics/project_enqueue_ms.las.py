"""Host ms a traced frame enqueuing the 10-10-10 unpack and projection of every
256-batch chunk (the spans `las.project`)."""

from benchmark import program

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.span_ms(rec, "las.project")
