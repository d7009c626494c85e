"""The port's own spans and counters (`pcrhpg24_tpu_torch/engine/timing`),
read by the per-layer metrics that name a stage inside the frame.

While a `torch.profiler` collects, the port adds up each named span's host
seconds and count and each counter's total.  In a run that is the traced
window alone: nothing else in it runs under the profiler.  The first
reader takes the totals from the port (which clears them) and keeps them
in the record as `program`, for the others.  A port without them gives
None, as does a run whose totals do not hold its traced frames, one
`renderer.frame` span each.
"""

from __future__ import annotations


def _take():
    """The port's totals, cleared there, or None where it keeps none."""
    try:
        from pcrhpg24_tpu_torch.engine import timing
    except ImportError:
        return None
    take = getattr(timing, "take_counters", None)
    return take() if take is not None else None


def totals(rec):
    """The port's totals over the traced window, or None."""
    t = rec.get("trace")
    if not t or not t.get("frames"):
        return None
    if "program" not in rec:
        rec["program"] = _take()
    tot = rec["program"]
    if tot is None or tot["spans"].get("renderer.frame", (0.0, 0))[1] != t["frames"]:
        return None
    return tot


def span_ms(rec, name: str):
    """Host ms a traced frame inside the span `name`."""
    tot = totals(rec)
    if tot is None or name not in tot["spans"]:
        return None
    return tot["spans"][name][0] / rec["trace"]["frames"] * 1e3


def per_frame(rec, name: str):
    """The counter `name` over the traced frames, a frame."""
    tot = totals(rec)
    if tot is None or name not in tot["counters"]:
        return None
    return tot["counters"][name] / rec["trace"]["frames"]

