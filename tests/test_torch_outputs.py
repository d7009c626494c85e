"""The flagship frame's other outputs vs the JAX reference, on the CPU:
the depth plane, the three debug modes, B2's batch-payload mode, EDL,
bounding boxes and the depth files.

* `huffman_tpu`'s frame on the exact power-of-two frame of
  `tests/test_torch_frame.py` (every f32 op exact, so the reference's own
  XLA frame with its FMAs must agree), with `need_depth=True` and each
  mode: fb_d, fb_p (the counts in overdraw mode) and the image equal the
  reference's `render_frame_native(use_pallas=False)` bit for bit, for
  the `.tpc` v2 scene and a v1 (tbatch) copy of it, which decodes to the
  same points; the LOD bucket is 32, so `show_num_points` shows the
  clamped counts.  (The depth plane of a real view, and the boxes of
  the loaded batches only, are held in `tests/test_torch_app.py`.)
* `project_plain` in batch-payload mode gives the reference's
  `render_chunk_native` streams (XLA O0) for `colorize_chunks` and
  `show_num_points`.
* `edl_shade` on crafted planes (flat, a step edge, empty pixels and
  neighbours, the border, rough depths, `tests/test_raster.py:103`'s
  cases) against the reference's, and its `exp` (`xla_exp`) against
  XLA-CPU's at O0 on seeded arguments and the edges.
* `draw_bounding_boxes` on boxes in view, behind the camera, crossing
  the frustum and degenerate, against the reference's (O0).
* `Renderer.save_depth_exr` writes the reference renderer's `.exr` and
  `.npy` bytes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.engine.renderer import Renderer as RefRenderer
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render import camera as ref_cam
from pcrhpg24_tpu.render import overlay as ref_overlay
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods.huffman_tpu import render_chunk_native as ref_chunk
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu.utils.exr import read_exr_z as ref_read_exr
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch.convert import dev_from_numpy
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_plain
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import render_frame_native
from pcrhpg24_tpu_torch.render.overlay import draw_bounding_boxes, edge_steps
from pcrhpg24_tpu_torch.render.project import project_plain
from pcrhpg24_tpu_torch.render.raster import edl_shade, xla_exp
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from pcrhpg24_tpu_torch.utils.exr import read_exr_z
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180
O0 = {"xla_backend_optimization_level": 0}
MODES = ("color", "colorize_chunks", "show_num_points", "colorize_overdraw")
PTS = 32  # the pow2 frame's LOD bucket
ORBIT = Setting(yaw=0.5, pitch=-0.9, radius=1500.0, target=(450.0, 450.0, 50.0))
EMPTY32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """test_torch_frame's two-batch scene as `.tpc` v2 and v1; the
    reference's v2 resource and its `dev` as numpy."""
    d = tmp_path_factory.mktemp("toutputs")
    las, v2, v1 = str(d / "s.las"), str(d / "s.tpc"), str(d / "s_v1.tpc")
    xyz, rgb = terrain_cloud(2 * 65536, seed=7, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, v2, sort=True, verbose=False)
    preprocess_las_tpc(las, v1, sort=True, verbose=False, codec="huffman")
    ref = RefData.create(v2).wait_loaded()
    return dict(v2=v2, v1=v1, ref=ref, ref_dev={k: np.asarray(v) for k, v in ref.dev.items()})


def _camera(setting):
    r = Renderer(W, H, "cpu")
    r.apply_setting(setting)
    r.controls_update()
    return r


def _pow2_inputs(Bp: int):
    """The exact power-of-two frame: every f32 op of the projection exact."""
    cam = _camera(ORBIT).camera
    fp = np.zeros(40, np.float32)
    fp[0:16] = cam.view().astype(np.float32).reshape(-1)
    fp[16:22] = cam.proj_params().astype(np.float32)
    fp[22] = 0.1  # the app's LOD floor: LOD counts below 64
    fp[23] = 2.0
    t = np.zeros((4, 4), np.float32)
    t[0, 0] = t[1, 1] = t[3, 2] = 2.0 ** -19
    fp[24:40] = t.reshape(-1)
    tb = np.zeros((Bp, 4), np.float32)
    tb[:, 3] = 2.0
    return fp, tb


_POW2 = {}


def _ref_pow2(ref, mode):
    """The reference's v2 frame on the power-of-two frame (one per mode)."""
    if mode not in _POW2:
        fp, tb = _pow2_inputs(ref.dev["anchor"].shape[0])
        out = ref_frame(ref.dev, jnp.asarray(fp), jnp.ones(3, jnp.float32),
                        jnp.zeros(3, jnp.float32), width=W, height=H, mode=mode, nchunks=1,
                        use_pallas=False, cull=True, points=PTS, need_depth=True,
                        fmt="fixed", tb=jnp.asarray(tb))
        _POW2[mode] = tuple(None if x is None else np.asarray(x) for x in out)
    return _POW2[mode]


def _same(got, want):
    """Port output (int32 tensor or None) == reference output (u32 or None)."""
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(to_u32(got).reshape(want.shape), want)


@pytest.mark.parametrize("fmt", ["v2", "v1"])
@pytest.mark.parametrize("mode", MODES)
def test_pow2_frame_outputs_equal_reference(scene, mode, fmt):
    """fb_d, fb_p and the image of every mode; the v1 scene decodes to the
    v2 scene's points, so its frames equal the reference's v2 frames."""
    want = _ref_pow2(scene["ref"], mode)
    las = NativeLasData.create(scene[fmt], "cpu").wait_loaded()
    fp, tb = _pow2_inputs(las.dev["anchor"].shape[0])
    got = render_frame_native(
        las.dev, torch.from_numpy(fp), torch.from_numpy(tb), torch.ones(3), W, H,
        nchunks=1, cull=True, points=PTS, fmt="fixed" if fmt == "v2" else "tbatch",
        mode=mode, need_depth=True)
    for g, w in zip(got, want):
        _same(g, w)
    img = want[2]
    assert (img != 0x00443322).sum() > 500
    if mode == "show_num_points":  # counts clamped to the bucket: grey 127
        assert (img == 0x007F7F7F).any()
    if mode == "colorize_overdraw":
        assert want[1].max() > 1  # pixels with more than one point


@pytest.mark.parametrize("mode", ["colorize_chunks", "show_num_points"])
def test_project_payload_equals_reference_streams(scene, mode):
    """B2's plain version in batch-payload mode, without collapse, gives
    the reference's `render_chunk_native` streams on a real camera (per
    op), LOD counts 40 and 64 (the payload of `show_num_points`)."""
    ref = scene["ref"]
    dev = dev_from_numpy(scene["ref_dev"], "cpu")
    cam = _camera(ORBIT).camera
    wvp = cam.proj() @ cam.view()
    t = wvp.astype(np.float32)
    scale = np.asarray(ref.scale, np.float32)
    tb = ref_cam.batch_translations(wvp, ref.anchor_i[:2], ref.scale, ref.offset, ref.las_min)
    lod = np.array([40, 64], np.int32)
    chunk = jax.jit(functools.partial(
        ref_chunk, width=W, height=H, mode=mode, use_pallas=False, points=64,
        fmt="fixed", nbatches=2))
    rdyn = (ref.dev, 0, jnp.asarray(t), jnp.asarray(lod), jnp.asarray(scale),
            jnp.zeros(3, jnp.float32))
    want = chunk.lower(*rdyn, tb=jnp.asarray(tb)).compile(compiler_options=O0)(
        *rdyn, tb=jnp.asarray(tb))
    coords = decode_fixed_plain(*(dev[k][:2] for k in ("widths", "streams", "ptrs", "starts")))
    frame12 = torch.from_numpy(np.concatenate([t[0, :3], t[1, :3], t[3, :3], scale]))
    lod_t = torch.from_numpy(lod)
    payload = torch.arange(2, dtype=torch.int32) if mode == "colorize_chunks" else lod_t
    got = project_plain(coords, dev["colors_k"][:2], dev["anchor"][:2],
                        torch.from_numpy(np.asarray(tb, np.float32)), lod_t, frame12, W, H,
                        collapse=False, payload=payload)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g).reshape(-1), np.asarray(w))
    size = ref_raster.swizzle_dims(W, H)[2]
    assert (np.asarray(want[0]) < size).sum() > 10_000


def _edl_case(kind, rng):
    """-> (img (H,W) u32, depth bits (H*W,) u32) of a crafted plane."""
    img = rng.integers(0, 2**24, (H, W)).astype(np.uint32)
    d = np.full((H, W), 10.0, np.float32)
    if kind == "flat":
        img[:] = 0x00808080
    elif kind == "step":  # tests/test_raster.py:103's edge, one background pixel
        img[:] = 0x00808080
        d[:, W // 2:] = 40.0
    elif kind == "rough":
        d = (100 + np.cumsum(rng.normal(0, 5, (H, W)), axis=1)).astype(np.float32)
    elif kind == "border":  # depths rising to every edge
        yy, xx = np.mgrid[0:H, 0:W]
        d = (1 + np.minimum(np.minimum(xx, W - 1 - xx), np.minimum(yy, H - 1 - yy))
             ).astype(np.float32)
    bits = d.view(np.uint32).copy()
    if kind == "step":
        bits[0, 0] = EMPTY32
        img[0, 0] = 0x00443322
    if kind in ("empty", "rough"):  # empty pixels, and pixels beside them
        bits[rng.random((H, W)) < 0.3] = EMPTY32
        img[bits == EMPTY32] = 0x00443322
    if kind == "empty":
        bits[:, :3] = EMPTY32
        img[:, :3] = 0xFF443322  # empty pixels keep the whole word
    return img, bits.reshape(-1)


EXP_EDGES = np.array([0.0, -0.0, -87.33, -87.8, -88.0, -104.0, 88.8, -np.inf,
                      -1e-45, -(2.0 ** -126), -87.336544, -0.5, 0.5], np.float32)


def test_xla_exp_equals_jnp_exp_per_op():
    """EDL's `exp` (ROADMAP C7): `xla_exp` equals XLA-CPU's f32 `jnp.exp`
    compiled at O0 bit for bit, on 1M seeded arguments over EDL's range
    [-104, 0] (their f32 bit patterns drawn uniformly, so every binade
    counts) and on the edges: zeros, the flush to zero below 2**-126, the
    clamps at -87.8 and 88.8 (inf), -inf and tiny arguments."""
    rng = np.random.default_rng(77)
    lo, hi = np.float32(-0.0).view(np.uint32), np.float32(-104.0).view(np.uint32)
    x = rng.integers(lo, hi, 1 << 20, endpoint=True).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, EXP_EDGES])
    got, want = _exp_pair(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (want == 0).sum() > 1000 and np.isinf(want).sum() == 1  # both ends reached


def _exp_pair(x):
    """(`xla_exp`, `jnp.exp` at O0) of the f32 array `x`, as numpy."""
    want = np.asarray(jax.jit(jnp.exp).lower(x).compile(compiler_options=O0)(x))
    return xla_exp(torch.from_numpy(x)).numpy(), want


def scan_exp(step: int = 1 << 24) -> tuple[int, int]:
    """Every f32 bit pattern, in chunks of `step`, through `_exp_pair`
    -> (arguments compared, those that differ; NaNs are left out).
    Minutes on a CPU: `python -m tests.test_torch_outputs`."""
    compared = differ = 0
    for lo, hi in ((0, 0x7F800000), (0x80000000, 0xFF800000)):  # +0..+inf, -0..-inf
        for s in range(lo, hi + 1, step):
            x = np.arange(s, min(s + step, hi + 1), dtype=np.uint64).astype(np.uint32)
            got, want = _exp_pair(x.view(np.float32))
            compared += x.size
            differ += int((got.view(np.uint32) != want.view(np.uint32)).sum())
    return compared, differ


@pytest.mark.parametrize("kind", ["flat", "step", "empty", "border", "rough"])
def test_edl_shade_equals_reference(kind):
    """Bit-exact against the reference's EDL."""
    img, bits = _edl_case(kind, np.random.default_rng(len(kind)))
    want = np.asarray(ref_raster.edl_shade(jnp.asarray(img), jnp.asarray(bits), W, H, 0.0005))
    got = to_u32(edl_shade(from_u32(img), from_u32(bits), W, H, 0.0005))
    np.testing.assert_array_equal(got, want)
    if kind == "flat":
        np.testing.assert_array_equal(got, img)
    if kind == "step":
        assert got[0, 0] == 0x00443322  # background kept
        assert (got[2, W // 2] & 0xFF) < 0x80  # the far side darkens
        assert got[2, W // 2 - 1] == 0x00808080 and got[2, W // 2 + 2] == 0x00808080
    if kind == "rough":
        assert (got != img).mean() > 0.3


def test_edge_steps_equal_jnp_linspace():
    want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, 64))())
    np.testing.assert_array_equal(edge_steps().view(np.uint32), want.view(np.uint32))


def _boxes(kind, rng):
    """Boxes in the render frame of the 900 m scene."""
    if kind == "in_view":
        lo = rng.uniform(100, 700, (20, 3)).astype(np.float32)
        lo[:, 2] = rng.uniform(0, 100, 20)
        return lo, lo + rng.uniform(5, 150, (20, 3)).astype(np.float32)
    cam = _camera(ORBIT).camera
    eye = np.asarray(cam.world, np.float64)[:3, 3]
    if kind == "behind":  # wholly behind the camera: every sample has w < 0
        away = eye + (eye - np.array([450.0, 450.0, 50.0])) * 0.5
        return (away - 20).astype(np.float32)[None], (away + 20).astype(np.float32)[None]
    if kind == "crossing":  # from behind the eye to the far side, and wider than the view
        return (np.array([[-3000.0, -3000.0, -10.0], [400.0, 400.0, 0.0]], np.float32),
                np.array([[4000.0, 4000.0, 60.0], [eye[0] + 300, eye[1] + 300, eye[2] + 50]],
                         np.float32))
    # degenerate: a point, a flat box, a line and the zero rows of unloaded batches
    lo = np.array([[450, 450, 50], [300, 300, 20], [600, 200, 10], [0, 0, 0], [0, 0, 0]],
                  np.float32)
    hi = np.array([[450, 450, 50], [500, 420, 20], [600, 200, 90], [0, 0, 0], [0, 0, 0]],
                  np.float32)
    return lo, hi


@pytest.mark.parametrize("kind", ["in_view", "behind", "crossing", "degenerate"])
def test_draw_bounding_boxes_equals_reference(kind):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 2**24, (H, W)).astype(np.uint32)
    bmin, bmax = _boxes(kind, rng)
    cam = _camera(ORBIT).camera
    t = (cam.proj() @ cam.view()).astype(np.float32)
    args = (jnp.asarray(img), jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(t))
    want = np.asarray(ref_overlay.draw_bounding_boxes.lower(
        *args, width=W, height=H).compile(compiler_options=O0)(*args))
    got = to_u32(draw_bounding_boxes(from_u32(img), torch.from_numpy(bmin),
                                     torch.from_numpy(bmax), torch.from_numpy(t), W, H))
    np.testing.assert_array_equal(got, want)
    drawn = int((want != img).sum())
    if kind == "behind":
        assert drawn == 0
    else:
        assert drawn > 0


def test_save_depth_equals_reference_renderer(tmp_path):
    rng = np.random.default_rng(9)
    d = rng.uniform(1, 900, (H * W,)).astype(np.float32).view(np.uint32).copy()
    d[rng.random(H * W) < 0.2] = EMPTY32
    ref = RefRenderer(W, H)
    ref.last_fb = (jnp.asarray(d), None)
    port = Renderer(W, H, "cpu")
    port.last_fb = (from_u32(d), None)
    for ext in (".exr", ".npy"):
        ref.save_depth_exr(str(tmp_path / f"ref{ext}"))
        port.save_depth_exr(str(tmp_path / f"port{ext}"))
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"ref{ext}").read_bytes()
    back = read_exr_z(str(tmp_path / "port.exr"))
    np.testing.assert_array_equal(back, ref_read_exr(str(tmp_path / "ref.exr")))
    np.testing.assert_array_equal(back, np.load(tmp_path / "port.npy"))
    port.last_fb = (None, None)
    with pytest.raises(RuntimeError, match="capture_depth"):
        port.save_depth_exr(str(tmp_path / "none.npy"))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print("xla_exp vs jnp.exp at O0: %d f32 arguments compared, %d differ" % scan_exp())
