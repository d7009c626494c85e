"""Seconds `wait_loaded` takes to make the `.tpc` scene resident
(`NativeLasData`)."""

UNIT = "s"
LAYER = "load"
MOVES = "setup_s"


def read(rec):
    return rec["load_s"]
