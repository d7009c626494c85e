"""`las_project_roofline` on hand-made records: a known reading, and None
where the kernel's range or the port's counters are missing."""

from __future__ import annotations

import pytest

from benchmark import program
from benchmark.roofline import HBM_BYTES_PER_S
from benchmark.spec import load_module

FRAMES = 4


def record(own_s=None, **totals):
    rec = dict(setup_s=30.0, load_s=4.0,
               window=dict(seconds=2.0, frames=4, frame_s=[0.4, 0.5, 0.5, 0.6],
                           enqueue_s=[0.1, 0.2, 0.1, 0.2], points=[10**9] * 4),
               trace=dict(frames=FRAMES, busy_s=1.0, window_s=3.0, device_s=1.5,
                          own_s={"pcr_u64_min_flat": 0.5} if own_s is None else own_s,
                          bytes={}, breakdown=dict(device_ops=[], idle_gaps=[])))
    rec["program"] = dict(
        counters=totals.get("counters", {"las.batches": 40 * FRAMES,
                                         "las.planes_needed": 44 * FRAMES}),
        spans={"renderer.frame": (0.1, FRAMES), "las.project": (0.01, FRAMES)})
    return rec


def read(rec):
    return load_module("metrics", "las_project_roofline").read(rec)


def test_reading():
    # 40 batches' entries and 44 plane words a point of a batch, a frame
    frame_bytes = 65536 * (12 * 40 + 4 * 44)
    seconds = frame_bytes / HBM_BYTES_PER_S / 0.8  # at 80% of the peak
    rec = record(own_s={"pcr_las_project": seconds * FRAMES, "pcr_u64_min_flat": 0.5})
    assert read(rec) == pytest.approx(80.0)


@pytest.mark.parametrize("missing", ["range", "batches", "planes", "totals", "trace"])
def test_none_without_what_it_reads(missing, monkeypatch):
    own = {"pcr_las_project": 0.01}
    counters = {"las.batches": 160, "las.planes_needed": 176}
    if missing == "range":
        own = {"pcr_u64_min_flat": 0.5}
    elif missing in ("batches", "planes"):
        del counters["las." + ("batches" if missing == "batches" else "planes_needed")]
    rec = record(own_s=own, counters=counters)
    if missing == "totals":  # a port that keeps none
        del rec["program"]
        monkeypatch.setattr(program, "_take", lambda: None)
    elif missing == "trace":
        del rec["trace"]
    assert read(rec) is None
