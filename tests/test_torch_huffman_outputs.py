"""`huffman_mem_iter`'s debug modes, bounding boxes, depth plane and EDL
vs the JAX reference's method, on the CPU.

On the `.huffman` scene of `tests/test_torch_huffman.py` (150,000
terrain points, three batches) the port's method, rendered through
`Renderer.loop` with the port's `Debug` flags, gives the image and
(fb_d, fb_p) planes of the reference's `HuffmanMemIter.render` with the
reference's flags, its `render_chunk` and `draw_bounding_boxes` compiled
per op (XLA O0: XLA-CPU otherwise contracts multiply-adds into FMAs):
`colorize_chunks` (B2's batch-payload mode with the batch index),
with the loaded batches' boxes and EDL over it, and `show_num_points`
(the LOD count, in a LOD bucket below 64).  `colorize_overdraw` renders
the colour frame, as the reference's method does (the colour frame is
held to the reference in `tests/test_torch_huffman.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.engine.debug import Debug as RefDebug
from pcrhpg24_tpu.engine.renderer import Renderer as RefRenderer
from pcrhpg24_tpu.engine.resource import HuffmanLasData as RefData
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las
from pcrhpg24_tpu.render import overlay as ref_overlay
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods import huffman_mem_iter as ref_mem_iter
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.engine.resource import HuffmanLasData
from pcrhpg24_tpu_torch.render.methods.huffman_mem_iter import HuffmanMemIter
from pcrhpg24_tpu_torch.u32 import to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 256, 144
O0 = {"xla_backend_optimization_level": 0}
VIEWS = {  # test_torch_huffman.py's views
    "orbit": Setting(yaw=0.7, pitch=-0.7, radius=800.0, target=(450.0, 450.0, 100.0)),
    "far": Setting(yaw=-1.1, pitch=-0.5, radius=2500.0, target=(450.0, 450.0, 40.0)),
}
FLAGS = ("lod", "colorize_chunks", "show_num_points", "colorize_overdraw",
         "show_bounding_box", "edl")
CASES = {  # name -> (view, lod, flags set)
    "chunks_boxes_edl": ("orbit", 1.0, ("colorize_chunks", "show_bounding_box", "edl")),
    "num_points": ("far", 0.1, ("show_num_points",)),
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(the port's and the reference's loaded `HuffmanLasData`)."""
    d = tmp_path_factory.mktemp("thuffout")
    las, huf = str(d / "s.las"), str(d / "s.huffman")
    xyz, rgb = terrain_cloud(150_000, seed=21, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las(las, huf, sort=True, verbose=False)
    return HuffmanLasData.create(huf, "cpu").wait_loaded(), RefData.create(huf).wait_loaded()


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = {f: getattr(Debug, f) for f in FLAGS}
    yield
    for f, v in saved.items():
        setattr(Debug, f, v)
    Runtime.clear()


def _per_op_render_chunk(dev, start, t, lod, scale, off, width, height, mode, fb_d, fb_p, tb):
    """The reference's `render_chunk`, compiled per op."""
    comp = _REAL_RENDER_CHUNK.lower(dev, start, t, lod, scale, off, width, height, mode,
                                    fb_d, fb_p, tb).compile(compiler_options=O0)
    return comp(dev, start, t, lod, scale, off, fb_d, fb_p, tb)


def _per_op_boxes(img, bmin, bmax, t, width, height):
    """The reference's `draw_bounding_boxes`, compiled per op."""
    return _REAL_BOXES.lower(
        img, bmin, bmax, t, width=width, height=height).compile(
        compiler_options=O0)(img, bmin, bmax, t)


_REAL_RENDER_CHUNK = ref_mem_iter.render_chunk
_REAL_BOXES = ref_overlay.draw_bounding_boxes


@pytest.mark.parametrize("case", sorted(CASES))
def test_mem_iter_outputs_equal_reference(scene, monkeypatch, case):
    las, ref = scene
    view, lod, flags = CASES[case]
    for dbg in (Debug, RefDebug):
        for f in FLAGS[1:]:
            monkeypatch.setattr(dbg, f, f in flags)
        monkeypatch.setattr(dbg, "lod", lod)
    monkeypatch.setattr(ref_mem_iter, "render_chunk", _per_op_render_chunk)
    monkeypatch.setattr(ref_overlay, "draw_bounding_boxes", _per_op_boxes)

    rr = RefRenderer(W, H)
    rr.apply_setting(VIEWS[view])
    rr.controls_update()
    want = np.asarray(ref_mem_iter.HuffmanMemIter(rr, ref).render(rr))
    want_d, want_p = (np.asarray(x) for x in rr.last_fb)

    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    m = HuffmanMemIter(r, las)
    r.loop(m.update, m.render, frames=1)
    np.testing.assert_array_equal(to_u32(r.last_fb[0]), want_d)
    np.testing.assert_array_equal(to_u32(r.last_fb[1]), want_p)
    if "edl" in flags:  # the reference's renderer shades its loop's image
        want = np.asarray(ref_raster.edl_shade(jnp.asarray(want), jnp.asarray(want_d),
                                               W, H, RefDebug.edl_strength))
    np.testing.assert_array_equal(to_u32(r.last_image), want)
    assert (want != 0x00443322).sum() > 500
    if case == "num_points":
        assert m.frame_args(r)["points"] < 64
        assert (np.unique(want_p[want_p != 0xFFFFFFFF]) < 64).all()
    if case == "chunks_boxes_edl":
        assert set(np.unique(want_p)) == {0, 1, 2, 0xFFFFFFFF}


def test_overdraw_renders_colour(scene, monkeypatch):
    las, _ref = scene
    imgs = []
    for overdraw in (False, True):
        monkeypatch.setattr(Debug, "colorize_overdraw", overdraw)
        r = Renderer(W, H, "cpu")
        r.apply_setting(VIEWS["orbit"])
        m = HuffmanMemIter(r, las)
        r.loop(m.update, m.render, frames=1)
        assert m.frame_mode(r) == dict(mode="color")
        imgs.append((to_u32(r.last_image), *(to_u32(x) for x in r.last_fb)))
    for a, b in zip(*imgs):
        np.testing.assert_array_equal(a, b)
