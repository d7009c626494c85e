"""Device ms a frame outside the port's own kernels: cull, LOD, slicing,
unswizzle, colour lookup."""

from benchmark import readers

UNIT = "ms"
LAYER = "torch ops"
MOVES = "points_per_s"


def read(rec):
    return readers.torch_ops_ms(rec)
