"""Host ms a traced frame waiting for the live-chunk list (the span
`tpc.live_wait`: the device cull and LOD, then one small read)."""

from benchmark import program

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.span_ms(rec, "tpc.live_wait")
