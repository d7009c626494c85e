"""Seconds `wait_loaded` takes to make the `.las` scene resident
(`ComputeLasData`)."""

UNIT = "s"
LAYER = "load"
MOVES = "setup_s"


def read(rec):
    return rec["load_s"]
