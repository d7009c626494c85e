"""Host ms a traced frame in `huffman_tpu`'s `frame_args` (the span
`tpc.frame_args`): host f64 LOD, `batch_translations`, the packed upload."""

from benchmark import program

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.span_ms(rec, "tpc.frame_args")
