"""95th percentile of the wall time of every frame of the window, in every
cell: a frame from before `update` to after the card has finished it."""

from benchmark import readers

UNIT = "ms"


def read(rec):
    return readers.frame_ms_p95(rec)
