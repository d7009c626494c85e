"""Live chunks a traced frame (the counter `tpc.live_chunks`): the chunks with
a visible batch, each one decode and one projection launch."""

from benchmark import program

UNIT = "chunks"
LAYER = "renderer loop, host enqueue"
MOVES = "points_per_s"


def read(rec):
    return program.per_frame(rec, "tpc.live_chunks")
