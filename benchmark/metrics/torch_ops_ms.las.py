"""Device ms a frame outside the port's own kernels: the plane fills, the
colour lookup (`resolve_indexed`), in HQS the divide (`resolve_hqs`), and
the packed upload of the boxes, levels and transform."""

from benchmark import readers

UNIT = "ms"
LAYER = "torch ops"
MOVES = "points_per_s"


def read(rec):
    return readers.torch_ops_ms(rec)
