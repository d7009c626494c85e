"""Visible points of the window's frames a second, the `.tpc` cells (paced by
the host's enqueue)."""

from benchmark import readers

UNIT = "Gpoints/s"


def read(rec):
    return readers.points_per_s(rec)
