"""The port's flagship frame vs the JAX reference, on the CPU.

* `frame_setup_device` gives the same per-batch LOD counts (`lod_n`) as
  the reference's, run op by op, on random boxes and several views.
* After `wait_loaded`, the port's `NativeLasData.dev` equals the
  reference's (`convert.dev_to_numpy`).
* The whole slice (decode -> project -> u64-min resolve -> unswizzle ->
  resolve) is bit-exact against the reference composed per op
  (`decode_fixed_xla` -> `project_batches(interpret=True)` at XLA O0 ->
  `scatter_u64_min` -> `unswizzle_plane` -> `resolve`) for real views,
  and against `render_frame_native(use_pallas=False)` on the exact
  power-of-two frame.
* `python -m pcrhpg24_tpu_torch.app --screenshot` writes a PNG
  byte-equal to the composed reference image's, for the v2 scene and
  for a v1 (tbatch) copy of it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render import camera as ref_cam
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu.render.native_decode_xla import decode_fixed_xla
from pcrhpg24_tpu.render.pallas_project import project_batches
from pcrhpg24_tpu.utils.png import write_png_bytes
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.convert import dev_from_numpy, dev_to_numpy
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.render.camera import frame_setup_device
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import (
    HuffmanTpu,
    render_frame_native,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180
# bench.py's three views, scaled to the 900 m test scene
VIEWS = {
    "orbit": Setting(yaw=0.5, pitch=-0.9, radius=1500.0, target=(450.0, 450.0, 50.0)),
    "closeup": Setting(yaw=2.4, pitch=-0.25, radius=120.0, target=(450.0, 450.0, 60.0)),
    "oblique": Setting(yaw=-1.1, pitch=-0.08, radius=700.0, target=(450.0, 450.0, 40.0)),
}


def per_op(jitted, *args, **static):
    """Run a jitted reference function with every f32 op rounded on its
    own (no FMA contraction): LLVM backend at optimisation level 0."""
    return jitted.lower(*args, **static).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(autouse=True)
def _restore_globals():
    lod = Debug.lod
    yield
    Debug.lod = lod
    Runtime.clear()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two-batch `.tpc` (the reference's `_tiny_tpc` scene), loaded by the
    reference; `ref.dev` as numpy."""
    d = tmp_path_factory.mktemp("tframe")
    las, tpc = str(d / "s.las"), str(d / "s.tpc")
    xyz, rgb = terrain_cloud(2 * 65536, seed=7, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    ref = RefData.create(tpc).wait_loaded()
    return tpc, ref, {k: np.asarray(v) for k, v in ref.dev.items()}


def _camera(setting):
    r = Renderer(W, H, "cpu")
    r.apply_setting(setting)
    r.controls_update()
    return r


@pytest.mark.parametrize("view", ["orbit", "closeup", "oblique", "inside"])
def test_frame_setup_lod_equal(view):
    """Random boxes around and inside the frustum, LOD floor 0.1."""
    rng = np.random.default_rng(len(view))
    lo = rng.uniform(0, 900, (512, 3)).astype(np.float32)
    lo[:, 2] = rng.uniform(0, 150, 512)
    bmin = lo
    bmax = (lo + rng.uniform(1, 80, (512, 3))).astype(np.float32)
    setting = VIEWS.get(view, Setting(yaw=0.3, pitch=-0.1, radius=5.0,
                                      target=(450.0, 450.0, 80.0)))
    cam = _camera(setting).camera
    view_m = cam.view().astype(np.float32)
    pp = cam.proj_params().astype(np.float32)
    want = np.asarray(ref_cam.frame_setup_device(
        jnp.asarray(view_m), jnp.asarray(pp), jnp.asarray(bmin), jnp.asarray(bmax),
        jnp.int32(500), W, H, jnp.float32(0.1), True))
    got = frame_setup_device(
        torch.from_numpy(view_m), torch.from_numpy(pp), torch.from_numpy(bmin),
        torch.from_numpy(bmax), torch.tensor(500, dtype=torch.int32), W, H,
        torch.tensor(0.1, dtype=torch.float32), True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any()


def test_native_resource_dev_equal(scene):
    tpc, ref, ref_dev = scene
    las = NativeLasData.create(tpc, "cpu").wait_loaded()
    got = dev_to_numpy(las.dev)
    # the colours are held once, in B2's layout (`colors_k`, compared here
    # with the reference's): no path of the port reads the flat rows
    assert got.keys() == ref_dev.keys() - {"colors"}
    for k, v in ref_dev.items():
        if k == "colors":
            continue
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(las.anchor_i, ref.anchor_i)
    np.testing.assert_array_equal(las.bbox_min, ref.bbox_min)
    np.testing.assert_array_equal(las.bbox_max, ref.bbox_max)
    # and back: the converter round-trips the reference's state
    back = dev_to_numpy(dev_from_numpy(ref_dev, "cpu"))
    for k, v in ref_dev.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_batch_wider_than_buffer_raises(scene):
    """The v2 stream buffer is sized from the header, which bounds every
    batch; a batch wider than the buffer stops the load with an error
    instead of being cut or lost (ROADMAP C2)."""
    tpc, _ref, _ref_dev = scene
    las = NativeLasData.create(tpc, "cpu")
    las.maxt = 1  # narrower than any batch of the scene
    with pytest.raises(ValueError):
        las.wait_loaded()
    las.unload()


def _reference_image(ref, ref_dev, setting, lod=1.0):
    """The reference frame composed per op, on the loaded batches."""
    cam = _camera(setting).camera
    B = ref.num_batches_loaded
    view_m = cam.view().astype(np.float32)
    pp = cam.proj_params().astype(np.float32)
    lod_n = ref_cam.frame_setup_device(
        jnp.asarray(view_m), jnp.asarray(pp), jnp.asarray(ref_dev["bbox_min"]),
        jnp.asarray(ref_dev["bbox_max"]), jnp.int32(B), W, H,
        jnp.float32(lod), True)
    lod_n = np.asarray(lod_n)[:B]
    points = max(16, -(-int(lod_n.max()) // 16) * 16)
    lod_n = np.minimum(lod_n, points)
    coords = decode_fixed_xla(*(jnp.asarray(ref_dev[k][:B]) for k in
                                ("widths", "streams", "ptrs", "starts")),
                              points=points)
    wvp = cam.proj() @ cam.view()
    t = wvp.astype(np.float32)
    frame12 = np.concatenate([t[0, :3], t[1, :3], t[3, :3],
                              np.asarray(ref.scale, np.float32)])
    tb = ref_cam.batch_translations(wvp, ref.anchor_i[:B], ref.scale,
                                    ref.offset, ref.las_min)
    pid, dep, pay = per_op(
        project_batches, coords, jnp.asarray(ref_dev["colors_k"][:B]),
        jnp.asarray(ref_dev["anchor"][:B]), jnp.asarray(tb), jnp.asarray(lod_n),
        jnp.asarray(frame12), width=W, height=H, points=points, interpret=True)
    size = ref_raster.swizzle_dims(W, H)[2]
    _fd, fb_p = ref_raster.scatter_u64_min(
        pid.reshape(-1).astype(jnp.int32), dep.reshape(-1), pay.reshape(-1), size)
    img = ref_raster.resolve(ref_raster.unswizzle_plane(fb_p, W, H), W, H)
    return np.asarray(img)


@pytest.mark.parametrize("view,lod", [("orbit", 1.0), ("closeup", 1.0),
                                      ("oblique", 1.0), ("oblique", 0.1)])
def test_slice_bit_exact_vs_composed_reference(scene, view, lod):
    tpc, ref, ref_dev = scene
    want = _reference_image(ref, ref_dev, VIEWS[view], lod)
    Debug.lod = lod
    r = _camera(VIEWS[view])
    las = NativeLasData.create(tpc, "cpu")
    method = HuffmanTpu(r, las)
    method.update(r)
    las.wait_loaded()
    las.dev = dev_from_numpy(ref_dev, "cpu")  # identical state for both
    _fb_d, _fb_p, img = render_frame_native(**method.frame_args(r))
    got = img.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (want != 0x00443322).sum() > 500


def test_slice_bit_exact_vs_render_frame_native_pow2(scene):
    """Exact power-of-two frame: every f32 op exact, so the reference's
    own XLA frame (with its FMAs, sort and scatter resolve) must agree."""
    tpc, ref, ref_dev = scene
    Bp = ref_dev["anchor"].shape[0]
    cam = _camera(VIEWS["orbit"]).camera
    fp = np.zeros(40, np.float32)
    fp[0:16] = cam.view().astype(np.float32).reshape(-1)
    fp[16:22] = cam.proj_params().astype(np.float32)
    fp[22] = 1.0  # LOD floor 1: every loaded batch decodes all 64 points
    fp[23] = float(ref.num_batches_loaded)
    t = np.zeros((4, 4), np.float32)
    t[0, 0] = t[1, 1] = t[3, 2] = 2.0 ** -19
    fp[24:40] = t.reshape(-1)
    tb = np.zeros((Bp, 4), np.float32)
    tb[:, 3] = 2.0
    ones = np.ones(3, np.float32)
    _d, _p, want = ref_frame(
        ref.dev, jnp.asarray(fp), jnp.asarray(ones), jnp.zeros(3, jnp.float32),
        width=W, height=H, mode="color", nchunks=1, use_pallas=False,
        cull=False, points=64, need_depth=False, fmt="fixed", tb=jnp.asarray(tb))
    _fb_d, _fb_p, img = render_frame_native(
        dev_from_numpy(ref_dev, "cpu"), torch.from_numpy(fp),
        torch.from_numpy(tb), torch.from_numpy(ones), W, H, nchunks=1,
        cull=False, points=64)
    want = np.asarray(want)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), want)
    assert (want != 0x00443322).sum() > 500


def test_app_png_equals_reference(scene, tmp_path):
    tpc, ref, ref_dev = scene
    s = VIEWS["orbit"]
    out = tmp_path / "port.png"
    assert app.main([
        "--scene", tpc, "--method", "huffman_tpu", "--device", "cpu",
        "--width", str(W), "--height", str(H), "--lod", "1.0",
        "--yaw", str(s.yaw), "--pitch", str(s.pitch), "--radius", str(s.radius),
        "--target", *map(str, s.target), "--screenshot", str(out),
    ]) == 0
    want = _reference_image(ref, ref_dev, s)
    rgb = np.asarray(ref_raster.image_to_rgb8(jnp.asarray(want)))
    assert out.read_bytes() == write_png_bytes(rgb)


def test_tbatch_scene_png_equals_reference(scene, tmp_path):
    """A `.tpc` v1 (tbatch) copy of the scene decodes to the same
    points, so the app's PNG (B5 -> B2 -> B3 on the CPU) equals the
    composed reference image of the v2 scene byte for byte."""
    tpc, ref, ref_dev = scene
    v1 = tpc[:-4] + "_v1.tpc"
    preprocess_las_tpc(tpc[:-4] + ".las", v1, sort=True, verbose=False,
                       codec="huffman")
    assert NativeLasData.create(v1, "cpu").version == 1
    s = VIEWS["oblique"]
    out = tmp_path / "port_v1.png"
    assert app.main([
        "--scene", v1, "--method", "huffman_tpu", "--device", "cpu",
        "--width", str(W), "--height", str(H), "--lod", "1.0",
        "--yaw", str(s.yaw), "--pitch", str(s.pitch), "--radius", str(s.radius),
        "--target", *map(str, s.target), "--screenshot", str(out),
    ]) == 0
    want = _reference_image(ref, ref_dev, s)
    rgb = np.asarray(ref_raster.image_to_rgb8(jnp.asarray(want)))
    assert out.read_bytes() == write_png_bytes(rgb)
