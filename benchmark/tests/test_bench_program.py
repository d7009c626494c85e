"""The readers of the port's own spans and counters (`benchmark/program.py`):
on hand-made records, beside the readers that were there before, and in a
traced run of a `.las` cell on the CPU."""

from __future__ import annotations

import copy
from pathlib import Path

import pytest

from benchmark import program
from benchmark.roofline import share
from benchmark.spec import load_module
from benchmark.tests.conftest import run_cpu

METRICS = Path(__file__).resolve().parents[1] / "metrics"
# reader -> what it reads from the port's totals, a frame
NEW = {
    "frame_args_ms.las": ("spans", "las.frame_args"),
    "project_enqueue_ms.las": ("spans", "las.project"),
    "resolve_enqueue_ms.las": ("spans", "las.resolve"),
    "frame_args_ms.tpc": ("spans", "tpc.frame_args"),
    "live_wait_ms.tpc": ("spans", "tpc.live_wait"),
    "chunk_enqueue_ms.tpc": ("spans", "tpc.chunk"),
    "live_chunks.tpc": ("counters", "tpc.live_chunks"),
}
LAS = [n for n in NEW if n.endswith(".las")]


def totals(frames: int = 4) -> dict:
    return dict(
        counters={"las.batches": 40, "las.planes_needed": 48, "tpc.live_chunks": 12},
        spans={"renderer.frame": (0.1, frames), "las.frame_args": (0.004, frames),
               "las.project": (0.02, 3 * frames), "las.resolve": (0.002, frames),
               "tpc.frame_args": (0.008, frames), "tpc.live_wait": (0.001, frames),
               "tpc.chunk": (0.006, 12), "pcr_u64_min_flat": (0.0002, frames)})


def record(frames: int = 4, **program_totals):
    rec = dict(setup_s=30.0, load_s=4.0,
               window=dict(seconds=2.0, frames=4, frame_s=[0.4, 0.5, 0.5, 0.6],
                           enqueue_s=[0.1, 0.2, 0.1, 0.2], points=[10**9] * 4),
               trace=dict(frames=frames, busy_s=1.0, window_s=3.0, device_s=1.5,
                          own_s=dict(pcr_u64_min_flat=0.5, pcr_hqs_sums_flat=0.2),
                          bytes=dict(pcr_u64_min_flat=10**9, pcr_hqs_sums_flat=10**9),
                          breakdown=dict(device_ops=[], idle_gaps=[])))
    rec.update(program_totals)
    return rec


def read(name: str, rec):
    return load_module("metrics", name).read(rec)


def test_readers_on_a_record():
    rec = record(program=totals())
    want = {"frame_args_ms.las": 1.0, "project_enqueue_ms.las": 5.0,
            "resolve_enqueue_ms.las": 0.5,
            "frame_args_ms.tpc": 2.0, "live_wait_ms.tpc": 0.25,
            "chunk_enqueue_ms.tpc": 1.5, "live_chunks.tpc": 3.0}
    assert {n: read(n, rec) for n in NEW} == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_give_none_where_nothing_is_there(name, monkeypatch):
    kind, key = NEW[name]
    missing = totals()
    del missing[kind][key]
    assert read(name, record(program=missing)) is None
    assert read(name, record(frames=5, program=totals())) is None  # another window's
    assert read(name, record(program=None)) is None  # a port that keeps none
    no_trace = record(program=totals())
    del no_trace["trace"]
    assert read(name, no_trace) is None
    # a port without the switch: nothing to take
    monkeypatch.setattr(program, "_take", lambda: None)
    assert read(name, record()) is None


def test_las_project_roofline_reads_the_counters():
    """`las_project_roofline`'s bytes a frame are read from the counters
    `las.batches` and `las.planes_needed`: 12 B a point of each projected
    batch and 4 B a point of each plane word the levels read."""
    def at(batches: int, planes: int):
        tot = totals()
        tot["counters"].update({"las.batches": batches, "las.planes_needed": planes})
        rec = record(program=tot)
        rec["trace"]["own_s"]["pcr_las_project"] = 0.004
        return read("las_project_roofline", rec)

    frame_s = 0.004 / 4
    assert at(40, 48) == pytest.approx(share(65536 * (12 * 10 + 4 * 12), frame_s))
    assert at(80, 48) == pytest.approx(share(65536 * (12 * 20 + 4 * 12), frame_s))
    assert at(40, 96) == pytest.approx(share(65536 * (12 * 10 + 4 * 24), frame_s))


def test_first_reader_takes_the_totals_once(monkeypatch):
    taken = []
    monkeypatch.setattr(program, "_take", lambda: taken.append(1) or totals())
    rec = record()
    assert [read(n, rec) is not None for n in NEW] == [True] * len(NEW)
    assert taken == [1] and rec["program"] == totals()


@pytest.mark.parametrize("path", sorted(p for p in METRICS.glob("*.py") if p.stem not in NEW),
                         ids=lambda p: p.stem)
def test_readers_before_read_the_same(path):
    """Every reader that was there before reads the same with the port's
    totals in the record as without them."""
    rec = record()
    rec["program"] = None
    with_totals = record(program=totals())
    assert read(path.stem, copy.deepcopy(rec)) == read(path.stem, with_totals)


def test_traced_cpu_run_reports_them(tiny, capsys):
    from pcrhpg24_tpu_torch.engine import timing

    timing.take_counters()
    res = run_cpu(tiny, "las.orbit", trace=1, capsys=capsys)
    got = {n: res["metrics"][n]["value"] for n in LAS}
    assert all(v > 0 for v in got.values())
    assert {res["metrics"][n]["unit"] for n in LAS} == {"ms"}
    assert timing.take_counters() == dict(counters={}, spans={})  # taken by the readers
