"""Share of an untraced frame's wall time in which the card runs nothing."""

from benchmark import readers

UNIT = "share"
LAYER = "device"
MOVES = "points_per_s"


def read(rec):
    return readers.idle_share(rec)
