"""B3 in the flat layout (`csrc/raster.cu`): percent of its memory roofline a
frame."""

from benchmark import readers

UNIT = "%"
LAYER = "kernels: B3 resolve"
MOVES = "points_per_s"


def read(rec):
    return readers.roofline(rec, "pcr_u64_min_flat")
