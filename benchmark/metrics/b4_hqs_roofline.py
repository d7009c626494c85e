"""B4 in the chain layout (`csrc/hqs.cu`): percent of its memory roofline a
frame."""

from benchmark import readers

UNIT = "%"
LAYER = "kernels: B4 HQS sums"
MOVES = "points_per_s"


def read(rec):
    return readers.roofline(rec, "pcr_hqs_sums")
