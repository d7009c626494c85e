"""B2 (`csrc/project.cu`): percent of its memory roofline a frame."""

from benchmark import readers

UNIT = "%"
LAYER = "kernels: B2 projection"
MOVES = "points_per_s"


def read(rec):
    return readers.roofline(rec, "pcr_project")
