"""Share of the 10-10-10 planes the projection unpacks that the visible
batches' precision levels read (the counters `las.planes_needed` and
`las.batches`): 3 planes at level 0, 2 at 1, 1 at 2-4, over 3 a batch."""

from benchmark import program

UNIT = "share"
LAYER = "torch ops"
MOVES = "points_per_s.las"


def read(rec):
    return program.unpack_use(rec)
