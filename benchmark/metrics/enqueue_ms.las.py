"""Host ms a frame in `loop_las`'s render before the synchronise (host cull
and levels, one packed upload, the projections' torch ops enqueued)."""

from benchmark import readers

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return readers.enqueue_ms(rec)
