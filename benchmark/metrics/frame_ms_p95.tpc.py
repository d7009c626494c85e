"""95th percentile of the frames' wall time in the `.tpc` cells, where the
host paces the frames and the tail swings with it."""

from benchmark import readers

UNIT = "ms"
LAYER = "renderer loop, tail"
MOVES = "points_per_s.tpc"


def read(rec):
    return readers.frame_ms_p95(rec)
