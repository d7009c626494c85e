"""95th percentile of the wall time of every frame of the window, `.las` cells."""

from benchmark import readers

UNIT = "ms"


def read(rec):
    return readers.frame_ms_p95(rec)
