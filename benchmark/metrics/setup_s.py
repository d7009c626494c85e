"""Set-up seconds, process start to the first measured frame: imports, the
kernels' build or load, the scene made, written and loaded, the warm-up."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
