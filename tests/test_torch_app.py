"""The port's app flags and viewer vs the JAX reference, on the CPU.

On test_torch_frame's two-batch `.tpc` v2 scene at the app's LOD floor
(0.1), each new flag of `python -m pcrhpg24_tpu_torch.app --device cpu`
writes the PNG (and depth file) that the reference's app pipeline
writes for the same frame: the reference's `render_frame_native`
compiled per op (XLA O0: XLA-CPU otherwise contracts multiply-adds into
FMAs), its `draw_bounding_boxes` (O0) of the loaded batches, its
`edl_shade`, `image_to_rgb8` + `write_png_bytes` and its renderer's
`save_depth_exr`.  The method's depth plane of that frame equals the
reference's, and it draws the boxes of the loaded batches only
(ROADMAP C6).  `--list-methods` prints the reference's lines,
`--trace` writes a Chrome trace, `--serve` waits for the load and hands
the methods to the viewer, and the viewer serves its page, `/info`,
`/timings` and `/frame` PNGs equal to the reference viewer's encoding of
the same frames (`tests/test_app.py:65`).
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.engine.renderer import Renderer as RefRenderer
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.render import overlay as ref_overlay
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu.utils.png import write_png_bytes
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.engine import viewer as viewer_mod
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import HuffmanTpu, render_frame_native
from pcrhpg24_tpu_torch.engine.viewer import ViewerServer
from pcrhpg24_tpu_torch.u32 import to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180
O0 = {"xla_backend_optimization_level": 0}
VIEW = Setting(yaw=0.5, pitch=-0.9, radius=1500.0, target=(450.0, 450.0, 50.0))
FLAGS = ("lod", "colorize_chunks", "colorize_overdraw", "edl", "show_num_points",
         "frustum_culling_enabled", "show_bounding_box")


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = {f: getattr(Debug, f) for f in FLAGS}
    yield
    for f, v in saved.items():
        setattr(Debug, f, v)
    Runtime.clear()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("tapp")
    las, tpc = str(d / "s.las"), str(d / "s.tpc")
    xyz, rgb = terrain_cloud(2 * 65536, seed=7, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    return tpc, RefData.create(tpc).wait_loaded()


def _argv(tpc, *flags):
    return ["--scene", tpc, "--method", "huffman_tpu", "--device", "cpu",
            "--width", str(W), "--height", str(H), "--lod", "0.1",
            "--yaw", str(VIEW.yaw), "--pitch", str(VIEW.pitch),
            "--radius", str(VIEW.radius), "--target", *map(str, VIEW.target), *flags]


_FRAMES = {}


def _ref_frame(ref, args, mode):
    """The reference's frame (fb_d, fb_p, image) in `mode` on the port's
    frame arguments, compiled per op; one per (mode, cull)."""
    key = (mode, args["cull"], args["frame_params"].numpy().tobytes())
    if key not in _FRAMES:
        dyn = dict(dev=ref.dev, frame_params=jnp.asarray(args["frame_params"].numpy()),
                   scale=jnp.asarray(args["scale"].numpy()),
                   offset_rel=jnp.zeros(3, jnp.float32), tb=jnp.asarray(args["tb"].numpy()))
        static = dict(width=W, height=H, mode=mode, nchunks=args["nchunks"],
                      use_pallas=False, cull=args["cull"], points=args["points"],
                      need_depth=True, fmt="fixed")
        _FRAMES[key] = ref_frame.lower(**dyn, **static).compile(compiler_options=O0)(**dyn)
    return _FRAMES[key]


def _ref_image(ref, args, mode, boxes=False, edl=False):
    """The reference app's image of the frame: boxes of the loaded
    batches, then EDL -> (image, fb_d)."""
    fb_d, _fb_p, img = _ref_frame(ref, args, mode)
    if boxes:
        B = ref.num_batches_loaded
        a = (img, ref.dev["bbox_min"][:B], ref.dev["bbox_max"][:B],
             jnp.asarray(args["frame_params"][24:40].numpy().reshape(4, 4)))
        img = ref_overlay.draw_bounding_boxes.lower(
            *a, width=W, height=H).compile(compiler_options=O0)(*a)
    if edl:
        img = ref_raster.edl_shade(img, fb_d.reshape(-1), W, H, Debug.edl_strength)
    return img, fb_d


CASES = {  # flags -> (mode, boxes, edl, depth file)
    "depth_npy": ((), "color", False, False, "d.npy"),
    "edl_boxes_exr": (("--edl", "--show-bounding-box"), "color", True, True, "d.exr"),
    "chunks_no_culling": (("--colorize-chunks", "--no-frustum-culling"),
                          "colorize_chunks", False, False, None),
    "num_points": (("--show-num-points",), "show_num_points", False, False, None),
    "overdraw": (("--colorize-overdraw",), "colorize_overdraw", False, False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_app_flags_write_the_reference_png_and_depth(scene, tmp_path, case):
    tpc, ref = scene
    flags, mode, boxes, edl, depth = CASES[case]
    png = tmp_path / "port.png"
    argv = _argv(tpc, *flags, "--screenshot", str(png))
    if depth:
        argv += ["--depth", str(tmp_path / f"port_{depth}")]
    rr = app.run(argv)
    m = Runtime.selected
    args = m.frame_args(rr)
    assert args["cull"] == ("--no-frustum-culling" not in flags)
    img, fb_d = _ref_image(ref, args, mode, boxes, edl)
    rgb = np.asarray(ref_raster.image_to_rgb8(img))
    np.testing.assert_array_equal(to_u32(rr.last_image), np.asarray(img))
    assert png.read_bytes() == write_png_bytes(rgb)
    assert (np.asarray(img) != 0x00443322).sum() > 500
    if depth:
        want = RefRenderer(W, H)
        want.last_fb = (fb_d, None)
        want.save_depth_exr(str(tmp_path / f"ref_{depth}"))
        assert ((tmp_path / f"port_{depth}").read_bytes()
                == (tmp_path / f"ref_{depth}").read_bytes())
    else:
        assert rr.capture_depth is False
    m.las.unload()


def _method(tpc):
    """`huffman_tpu` on the scene at the app's view and LOD, loaded."""
    Debug.lod = 0.1
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEW)
    r.controls_update()
    m = HuffmanTpu(r, NativeLasData.create(tpc, "cpu"))
    app.wait_loaded(m, r)
    return r, m


def test_depth_plane_equals_reference_per_op(scene):
    tpc, ref = scene
    r, m = _method(tpc)
    r.capture_depth = True
    args = m.frame_args(r)
    assert m.frame_mode(r) == dict(mode="color", need_depth=True)
    got = render_frame_native(**args, **m.frame_mode(r))
    want = _ref_frame(ref, args, "color")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (np.asarray(want[0]) != 0xFFFFFFFF).sum() > 500
    m.las.unload()


def test_boxes_of_loaded_batches_only(scene, monkeypatch):
    """ROADMAP C6: the reference's `huffman_tpu` draws every row of
    `bbox_min` (`huffman_tpu.py:427-432`), the padded and unloaded rows
    too, which are zeros: a box at the scene's minimum corner.  The port
    draws the loaded rows (2 of the 64): its image is the reference's
    frame with the reference's boxes of those rows."""
    from pcrhpg24_tpu_torch.render.methods import huffman_mem_iter

    tpc, ref = scene
    Debug.show_bounding_box = True
    rows = []
    draw = huffman_mem_iter.draw_bounding_boxes

    def counted(img, bmin, bmax, *a):
        rows.append((bmin.shape[0], bmax.shape[0]))
        return draw(img, bmin, bmax, *a)

    monkeypatch.setattr(huffman_mem_iter, "draw_bounding_boxes", counted)
    r, m = _method(tpc)
    r.loop(m.update, m.render, frames=1)
    assert rows == [(2, 2)] and m.las.dev["bbox_min"].shape[0] == 64
    assert r.last_fb[0] is None  # no depth plane asked for: none unswizzled
    want, _fb_d = _ref_image(ref, m.frame_args(r), "color", boxes=True)
    np.testing.assert_array_equal(to_u32(r.last_image), np.asarray(want))
    m.las.unload()


def test_list_methods(scene, capsys):
    tpc, _ref = scene
    rr = app.run(["--scene", tpc, "--device", "cpu", "--list-methods"])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{m.name:24s} [{m.group}] {m.description}" for m in Runtime.methods]
    assert [line.split()[0] for line in out] == ["huffman_tpu", "huffman_tpu_hqs"]
    assert rr.frame_count == 0


def test_trace_writes_a_chrome_trace(scene, tmp_path):
    tpc, _ref = scene
    rr = app.run(["--scene", tpc, "--device", "cpu", "--width", "64", "--height", "36",
                  "--frames", "1", "--trace", str(tmp_path / "tr")])
    assert rr.frame_count == 2  # one warm frame, one traced
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    Runtime.selected.las.unload()


def test_serve_waits_for_the_load(scene, monkeypatch):
    tpc, _ref = scene
    seen = []
    monkeypatch.setattr(viewer_mod.ViewerServer, "serve_forever", lambda self: seen.append(self))
    app.run(["--scene", tpc, "--device", "cpu", "--serve", "0"])
    (srv,) = seen
    assert [m.name for m in srv.methods] == ["huffman_tpu", "huffman_tpu_hqs"]
    assert srv.methods[0].las.num_batches_loaded == 2 and srv.port == 0
    srv.methods[0].las.unload()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60)


def test_viewer_serves_the_reference_frames(scene):
    tpc, ref = scene
    Debug.lod = 0.1
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEW)
    r.controls_update()
    methods = app.build_methods(r, tpc)
    app.wait_loaded(methods[0], r)
    srv = ViewerServer(r, methods, 0)
    port = srv.bind()
    assert port > 0
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert b"pcrhpg24-tpu viewer" in _get(port, "/").read()
        info = json.loads(_get(port, "/info").read())
        assert info["methods"] == ["huffman_tpu", "huffman_tpu_hqs"]

        def fetch(mode):
            url = (f"/frame?yaw={VIEW.yaw}&pitch={VIEW.pitch}&radius={VIEW.radius}"
                   f"&method=0&mode={mode}")
            for _ in range(3):  # the page's x-stale convergence
                resp = _get(port, url)
                body = resp.read()
                if resp.headers.get("x-stale") != "1":
                    assert resp.headers.get("x-method") == "huffman_tpu"
                    return body
            raise AssertionError("stale frames never converged")

        args = methods[0].frame_args(r)
        for mode, ref_mode in (("", "color"), ("overdraw", "colorize_overdraw")):
            img, _fb_d = _ref_image(ref, args, ref_mode)
            want = write_png_bytes(np.asarray(ref_raster.image_to_rgb8(img)), level=1)
            assert fetch(mode) == want
        assert not Debug.colorize_overdraw  # restored after the frame
        rows = json.loads(_get(port, "/timings").read())["rows"]
        assert {row["label"] for row in rows} >= {"frame", "render"}
    finally:
        srv.shutdown()
        t.join(timeout=10)
        methods[0].las.unload()
    assert not t.is_alive()
