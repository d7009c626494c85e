"""The port's tracing switch (`engine/timing.py`) on the CPU.

Off (no profiler collecting), `span`, `Timings.span` and `Kernel.launch`
enter no `torch.profiler.record_function` and `count` records nothing.
On, a `loop_las` frame and a `huffman_tpu` frame emit their stage spans
inside `renderer.frame`, once a frame or (`tpc.chunk`) once a live
chunk, and their counters equal a NumPy recount; a frame rendered with
tracing on is bit-identical to one rendered with it off.  The scenes are small: a chunk is cut to one
batch (`loop_las.CHUNK_PTS`, `huffman_tpu.CHUNK`), so three batches make
three chunks.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pcrhpg24_tpu_torch.constants import POINTS_PER_WORKGROUP
from pcrhpg24_tpu_torch.engine import timing
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.las_resources import ComputeLasData
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.formats.las import write_las
from pcrhpg24_tpu_torch.kernels import build
from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
from pcrhpg24_tpu_torch.render.camera import batches_in_frustum, frustum_planes
from pcrhpg24_tpu_torch.render.methods import huffman_tpu, loop_las
from pcrhpg24_tpu_torch.tools.profile_frame import frame_idle, program_spans
from pcrhpg24_tpu_torch.utils.synthetic import cloud_to_grid, terrain_cloud
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 96, 54
BATCHES = 3
VIEWS = {
    "orbit": Setting(yaw=0.5, pitch=-0.9, radius=1500.0, target=(300.0, 300.0, 50.0)),
    # top-down close-ups: the `.las` levels (1, 1, 1) with the last batch
    # culled, and one `.tpc` chunk not live; the `.las` levels (0, 1, 1)
    # with two batches culled
    "top": Setting(yaw=2.4, pitch=-1.5, radius=30.0, target=(100.0, 550.0, 50.0)),
    "corner": Setting(yaw=2.4, pitch=-1.5, radius=30.0, target=(50.0, 50.0, 50.0)),
}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """One batch a chunk; no totals left from another test; globals restored."""
    monkeypatch.setattr(loop_las, "CHUNK_PTS", POINTS_PER_WORKGROUP)
    monkeypatch.setattr(huffman_tpu, "CHUNK", 1)
    saved = Debug.lod
    timing.take_counters()
    yield
    timing.take_counters()
    Debug.lod = saved
    Runtime.clear()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A 3-batch scene as `.las` (x-sorted) and as `.tpc` -> loaded resources."""
    d = tmp_path_factory.mktemp("ttracing")
    las, tpc = str(d / "s.las"), str(d / "s.tpc")
    xyz, rgb = terrain_cloud(BATCHES * POINTS_PER_WORKGROUP, seed=21, extent=600.0)
    order = np.argsort(xyz[:, 0], kind="stable")
    grid = cloud_to_grid(xyz[order])
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb[order])
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    res = dict(las=ComputeLasData.create(las, "cpu").wait_loaded(),
               tpc=NativeLasData.create(tpc, "cpu").wait_loaded())
    yield res
    for r in res.values():
        r.unload()


def _frame(scenes, kind: str, view: str, traced: bool):
    """One frame of `loop_las` or `huffman_tpu` through `Renderer.loop`
    -> (renderer, method, image, host ranges (name, start, end))."""
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    if kind == "las":
        m = loop_las.ComputeLoopLas(r, scenes["las"])
    else:
        Debug.lod = 0.1
        m = huffman_tpu.HuffmanTpu(r, scenes["tpc"])
    Runtime.resource = m.las  # loaded by the fixture: no switch
    if not traced:
        return r, m, r.loop(m.update, m.render, frames=1), []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        img = r.loop(m.update, m.render, frames=1)
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    return r, m, img, ranges


def test_off_enters_no_range_and_counts_nothing(monkeypatch):
    entered = []

    class Counted:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    calls = []

    def pcr_fake(*args):  # a C entry point: ctypes sets its types
        calls.append(args)
        return 0

    lib = SimpleNamespace(pcr_fake=pcr_fake)
    kernel = build.Kernel("pcr_fake", [build.I], library=lambda: lib, registry={})
    assert not timing.tracing()
    assert timing.span("las.project") is timing.span("tpc.chunk")
    assert isinstance(timing.span("las.project"), nullcontext)
    with timing.span("las.project"):
        timing.count("las.batches", 3)
    Renderer(8, 8, "cpu").loop(lambda r: None, lambda r: None, frames=2)
    kernel.launch(1)
    assert entered == [] and len(calls) == 1 and kernel.launches == 1
    assert timing.take_counters() == dict(counters={}, spans={})
    # the same calls under a profiler enter a range each, and are counted
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span("las.project"):
            timing.count("las.batches", 3)
        kernel.launch(1)
    assert entered == ["las.project", "pcr_fake"] and kernel.launches == 2
    tot = timing.take_counters()
    assert tot["counters"] == {"las.batches": 3}
    assert {k: n for k, (_s, n) in tot["spans"].items()} == {"las.project": 1, "pcr_fake": 1}
    assert timing.take_counters() == dict(counters={}, spans={})


def _nested(ranges, name, frame):
    """The ranges named `name` lie inside the frame range."""
    got = [(s, e) for n, s, e in ranges if n == name]
    assert all(frame[1] <= s and e <= frame[2] for s, e in got), name
    return len(got)


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("kind", ["las", "tpc"])
def test_frame_spans_and_counters(scenes, kind, view):
    r, m, _img, ranges = _frame(scenes, kind, view, traced=True)
    frames = [x for x in ranges if x[0] == "renderer.frame"]
    assert len(frames) == 1
    for name in ("renderer.update", "renderer.render"):
        assert _nested(ranges, name, frames[0]) == 1
    tot = timing.take_counters()
    spans, counters = tot["spans"], tot["counters"]
    assert spans["renderer.frame"][1] == 1
    if kind == "las":
        assert _nested(ranges, "las.frame_args", frames[0]) == 1
        assert _nested(ranges, "las.project", frames[0]) == 1  # one a frame
        assert _nested(ranges, "las.resolve", frames[0]) == 1
        cam = r.camera
        view_m, proj = cam.view(), cam.proj()
        las = scenes["las"]
        B = las.num_batches_loaded
        bmin, bmax = las.bbox_min[:B], las.bbox_max[:B]
        vis = batches_in_frustum(frustum_planes(proj @ view_m), bmin, bmax)
        level = loop_las.precision_levels(view_m, proj, bmin, bmax, W, H)
        planes = np.select([level == 0, level == 1], [3, 2], 1)
        assert counters == {"las.batches": B, "las.planes_needed": int(planes[vis].sum())}
    else:
        live = len(huffman_tpu.frame_streams(**m.frame_args(r))[0])
        assert 0 < live <= BATCHES
        assert _nested(ranges, "tpc.frame_args", frames[0]) == 1
        assert _nested(ranges, "tpc.live_wait", frames[0]) == 1
        assert _nested(ranges, "tpc.chunk", frames[0]) == live
        assert counters == {"tpc.live_chunks": live}
    # the program's totals count what the profiler saw
    assert {k: n for k, (_s, n) in spans.items() if not k.startswith("pcr_")} == {
        k: n for k, (_t, _o, n) in program_spans(ranges).items()}


@pytest.mark.parametrize("kind", ["las", "tpc"])
def test_traced_frame_is_bit_identical(scenes, kind):
    _r, _m, off, _ = _frame(scenes, kind, "orbit", traced=False)
    _r, _m, on, ranges = _frame(scenes, kind, "orbit", traced=True)
    assert ranges and torch.equal(off, on)


def test_program_spans_self_time():
    ranges = [("renderer.frame", 0, 10), ("renderer.render", 2, 9), ("las.project", 3, 5),
              ("aten::add", 3, 4), ("las.project", 5, 6), ("las.resolve", 7, 8.5),
              ("pcr_u64_min_flat", 7.5, 8), ("bench.render", 1, 9.5)]
    assert program_spans(ranges) == {
        "renderer.frame": [10, 3, 1], "renderer.render": [7, 2.5, 1],
        "las.project": [3, 3, 2], "las.resolve": [1.5, 1.5, 1]}


def test_frame_idle_splits_lead_starved_tail():
    frames = [(0, 10), (10, 20), (20, 25)]
    device = [(2, 4), (3, 5), (7, 8),  # frame 0: lead 2, starved 2, tail 2, busy 4
              (11, 19),  # frame 1: lead 1, tail 1
              (19.5, 21)]  # straddles frames 1 and 2; frame 2 has none: all lead
    got = frame_idle(frames, device)
    assert got == dict(lead=2 + 1 + 5, starved=2, tail=2 + 1, busy=4 + 8, outside=1)
    assert frame_idle([], [(0, 1)])["outside"] == 1
