"""Host ms a traced frame in `loop_las`'s `frame_args` (the span `las.frame_args`):
the host f64 cull and precision levels, the packing, the upload."""

from benchmark import program

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.span_ms(rec, "las.frame_args")
