"""Visible points of the window's frames a second, in every cell: each
frame's points are counted by the cell's format's own reference
(`Reference.visible_points`), so a cell of a new format brings its count
with its reference."""

from benchmark import readers

UNIT = "Gpoints/s"


def read(rec):
    return readers.points_per_s(rec)
