"""Host ms a traced frame enqueuing the live chunks' decode and projection
(the spans `tpc.chunk`, B1 or B5 and B2 each)."""

from benchmark import program

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.span_ms(rec, "tpc.chunk")
