"""Host ms a frame in `huffman_tpu`'s render before the synchronise (cull and
LOD set-up, the per-chunk launches, the live-chunk read)."""

from benchmark import readers

UNIT = "ms"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return readers.enqueue_ms(rec)
