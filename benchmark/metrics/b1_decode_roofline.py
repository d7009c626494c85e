"""B1 (`csrc/decode_fixed.cuh`): percent of its memory roofline a frame."""

from benchmark import readers

UNIT = "%"
LAYER = "kernels: B1 decode"
MOVES = "points_per_s"


def read(rec):
    return readers.roofline(rec, "pcr_decode_fixed")
