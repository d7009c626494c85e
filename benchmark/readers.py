"""The arithmetic the metric readers share, over a run's record.

`rec` holds `setup_s`, `load_s` and `window` (the untraced window:
`seconds`, `frames`, per frame `frame_s`, `enqueue_s` and the visible
`points` the benchmark's own LOD and cull rule counts), and in a traced
run `trace` (`trace.reduce` of the profiled window, with `bytes`, each
port kernel's least bytes a frame).  A reader returns None where its run
has nothing to read.
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import share


def points_per_s(rec) -> float:
    """Visible points of every frame completed in the window over its
    seconds, in billions."""
    w = rec["window"]
    return float(sum(w["points"])) / w["seconds"] / 1e9


def frame_ms_p95(rec) -> float:
    return float(np.percentile(rec["window"]["frame_s"], 95)) * 1e3


def enqueue_ms(rec) -> float:
    """Host ms a frame from `render`'s start to its return, before the
    synchronise."""
    return float(np.mean(rec["window"]["enqueue_s"])) * 1e3


def idle_share(rec):
    """1 - the device's busy seconds a traced frame over the wall seconds
    an untraced frame takes (the profiler slows the host, not the card)."""
    t = rec.get("trace")
    if not t or not t["frames"] or not t["device_s"]:
        return None
    w = rec["window"]
    return 1.0 - (t["busy_s"] / t["frames"]) / (w["seconds"] / w["frames"])


def torch_ops_ms(rec):
    """Device ms a frame in kernels, copies and sets launched outside the
    port's own `pcr_*` kernel ranges."""
    t = rec.get("trace")
    if not t or not t["frames"] or not t["device_s"]:
        return None
    return (t["device_s"] - sum(t["own_s"].values())) / t["frames"] * 1e3


def roofline(rec, symbol: str):
    """Percent of its memory roofline that the kernel `symbol` reaches in a
    frame: its least bytes at the peak over its device seconds."""
    t = rec.get("trace")
    if not t or t["own_s"].get(symbol, 0.0) <= 0 or symbol not in t.get("bytes", {}):
        return None
    return share(t["bytes"][symbol], t["own_s"][symbol] / t["frames"])
