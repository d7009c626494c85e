"""Device ms a frame outside the port's own kernels: the 10-10-10 unpack and
the projection (`loop_las_parts`, `raster.project_points`), the lookup."""

from benchmark import readers

UNIT = "ms"
LAYER = "torch ops"
MOVES = "points_per_s.las"


def read(rec):
    return readers.torch_ops_ms(rec)
