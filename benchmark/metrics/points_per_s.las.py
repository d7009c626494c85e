"""Visible points of the window's frames a second, the `.las` cells (paced by
the card)."""

from benchmark import readers

UNIT = "Gpoints/s"


def read(rec):
    return readers.points_per_s(rec)
