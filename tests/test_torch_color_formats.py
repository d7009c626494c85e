"""Raw and BC7 colours on the port's `.tpc` frames vs the JAX reference,
on the CPU.

The scene is the reference's own (`tests/test_color_formats.py`): a
65,536-point `terrain_cloud` (seed 21, 600 m) at 320x180, written as
`.tpc` v2 in each colour format.

* `codec/bc7.py`: `encode_bc7` (vectorised) writes the reference's words
  on random, flat, two-colour and palette-tie blocks; `decode_bc7` reads
  them as the reference's does.
* `render/bc1_layout.py`: the BC7 and raw payloads on their kernel
  layouts equal `bc1_layout.{bc7,raw}_payload_native` at points 16, 32,
  48 and 64, and on the crafted BC7 blocks of B2's gate
  (`crafted.bc7_rows`).
* `project_plain(color_fmt=...)` (B2's plain version) gives the streams
  of `render_chunk_native(use_pallas=False, color_fmt=...)` compiled per
  op (XLA O0), colour mode (the within-chain collapse; the reference's
  XLA stage has no chain-head ladder) and HQS mode.
* The port's preprocessor writes the reference's bytes in each format;
  raw or BC7 with the v1 codec, or an unknown format, raise `ValueError`
  in both.
* `NativeLasData` holds each format's colours once, in its kernel layout.
* Through `app.run`, the colour, HQS, EDL and `--colorize-chunks`
  frames of the raw and BC7 scenes equal the reference's
  `render_frame_native` / `hqs_frame_native` (O0) of the same frame, and
  every raw winner carries one of the scene's input colours exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.codec import bc7 as ref_bc7
from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.formats.las import read_points, write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc as ref_preprocess_tpc
from pcrhpg24_tpu.render import bc1_layout as ref_layout
from pcrhpg24_tpu.render import camera as ref_cam
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods.huffman_tpu import render_chunk_native as ref_chunk
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import hqs_blend_native, hqs_prepass_native
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.codec import bc7
from pcrhpg24_tpu_torch.convert import dev_from_numpy
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.formats.native_file import COLOR_WORDS
from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
from pcrhpg24_tpu_torch.render.bc1_layout import (
    COLOR_K_SHAPE,
    PAYLOAD,
    bc7_payload,
    colors_kernel_layout,
)
from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_plain
from pcrhpg24_tpu_torch.render.project import project_plain
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180
BG = 0x00443322
O0 = {"xla_backend_optimization_level": 0}
VIEW = Setting(yaw=0.5, pitch=-0.9, radius=700.0, target=(300.0, 300.0, 40.0))
FLAGS = ("lod", "colorize_chunks", "edl")


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = {f: getattr(Debug, f) for f in FLAGS}
    yield
    for f, v in saved.items():
        setattr(Debug, f, v)
    Runtime.clear()


def _rgb(rng, n):
    c = rng.integers(0, 256, (n, 3)).astype(np.uint32)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16)


def _blocks(kind: str) -> np.ndarray:
    """(n,) u32 colours, 16 to a block, of one kind."""
    rng = np.random.default_rng(3)
    grey = np.arange(256, dtype=np.uint32) * 0x010101
    if kind == "random":
        return _rgb(rng, 4096 * 16)
    if kind == "flat":  # norm == 0: every point is the block's one colour
        return np.repeat(_rgb(rng, 256), 16)
    if kind == "two_colour":
        pair = _rgb(rng, 512).reshape(256, 2)
        return pair[np.arange(256)[:, None], rng.integers(0, 2, (256, 16))].reshape(-1)
    if kind == "palette_ties":  # greys between palette steps: argmin takes the first
        steps = np.array([0, 255] + [8, 9, 25, 26, 42, 43, 127, 128, 129, 238, 239, 246,
                                     247, 250], np.int64)
        return grey[np.stack([rng.permutation(steps) for _ in range(256)]).reshape(-1)]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "flat", "two_colour", "palette_ties"])
def test_bc7_codec_equals_reference(kind):
    colors = _blocks(kind)
    want = ref_bc7.encode_bc7(colors)
    got = bc7.encode_bc7(colors)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    ids = np.arange(len(colors))
    dec = bc7.decode_bc7(got, ids)
    np.testing.assert_array_equal(dec, ref_bc7.decode_bc7(want, ids))
    if kind == "flat":  # a flat block decodes to its colour
        assert np.abs((dec.astype(np.int64) & 255) - (colors.astype(np.int64) & 255)).max() <= 1


@pytest.mark.parametrize("points", [16, 32, 48, 64])
@pytest.mark.parametrize("fmt", ["bc7", "raw"])
def test_payload_equals_reference(fmt, points):
    rng = np.random.default_rng(points)
    colors = np.stack([_rgb(rng, 65536) for _ in range(2)])
    if fmt == "bc7":
        rows = np.stack([bc7.encode_bc7(c) for c in colors])
        want = ref_layout.bc7_payload_native(jnp.asarray(rows), None, points=points)
    else:
        rows = colors | (rng.integers(0, 256, colors.shape).astype(np.uint32) << 24)
        want = ref_layout.raw_payload_native(jnp.asarray(rows), None, points=points)
    assert rows.shape[1] == COLOR_WORDS[fmt] == np.prod(COLOR_K_SHAPE[fmt])
    k = from_u32(colors_kernel_layout(rows, fmt))
    got = PAYLOAD[fmt](k, points)
    assert got.shape == (2, points, 8, 128)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_crafted_bc7_payload_equals_reference():
    """`crafted.bc7_rows` (every p-bit pattern, endpoints 0 and 127, indices
    0 and 15, every anchor field) through the plain payload and the
    reference's, and the words `crafted.colors_k` lays out for B2."""
    rows = crafted.bc7_rows(2, seed=5)
    want = ref_layout.bc7_payload_native(jnp.asarray(rows), None, points=64)
    k = crafted.colors_k(2, "bc7", seed=5)
    np.testing.assert_array_equal(k, colors_kernel_layout(rows, "bc7"))
    got = bc7_payload(from_u32(k), 64)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    lo = rows[:, 0::4].astype(np.uint64) | (rows[:, 1::4].astype(np.uint64) << np.uint64(32))
    hi = rows[:, 2::4].astype(np.uint64) | (rows[:, 3::4].astype(np.uint64) << np.uint64(32))
    p = (lo >> np.uint64(63)) * np.uint64(2) + (hi & np.uint64(1))
    assert set(p.reshape(-1).tolist()) == {0, 1, 2, 3}
    assert set(((hi >> np.uint64(1)) & np.uint64(7)).reshape(-1).tolist()) == set(range(8))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The LAS, each format's `.tpc` v2 written by the port, and the
    reference's resource of each."""
    d = tmp_path_factory.mktemp("tcolorfmt")
    xyz, rgb = terrain_cloud(65536, seed=21, extent=600.0)
    grid = cloud_to_grid(xyz)
    las = str(d / "s.las")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    tpc, ref = {}, {}
    for fmt in ("raw", "bc7", "bc1"):
        tpc[fmt] = str(d / f"s_{fmt}.tpc")
        preprocess_las_tpc(las, tpc[fmt], sort=True, verbose=False, color_fmt=fmt)
        ref[fmt] = RefData.create(tpc[fmt]).wait_loaded()
    return dict(dir=d, las=las, tpc=tpc, ref=ref)


@pytest.mark.parametrize("fmt", ["raw", "bc7", "bc1"])
def test_tpc_bytes_equal_reference(scene, fmt):
    path = str(scene["dir"] / f"ref_{fmt}.tpc")
    ref_preprocess_tpc(scene["las"], path, sort=True, verbose=False, color_fmt=fmt)
    with open(path, "rb") as f, open(scene["tpc"][fmt], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("fmt,codec", [("raw", "huffman"), ("bc7", "huffman"),
                                       ("bc4", "fixed")])
def test_refused_formats_raise(scene, tmp_path, fmt, codec):
    for pre in (preprocess_las_tpc, ref_preprocess_tpc):
        with pytest.raises(ValueError):
            pre(scene["las"], str(tmp_path / "x.tpc"), verbose=False, codec=codec,
                color_fmt=fmt)


@pytest.mark.parametrize("fmt", ["raw", "bc7"])
def test_resource_holds_the_kernel_layout_once(scene, fmt):
    las = NativeLasData.create(scene["tpc"][fmt], "cpu").wait_loaded()
    ref = scene["ref"][fmt]
    assert las.color_fmt == ref.color_fmt == fmt
    assert set(las.dev) == set(ref.dev) - {"colors"} | {"colors_k"}
    for k, v in ref.dev.items():
        if k != "colors":
            np.testing.assert_array_equal(las.dev[k].numpy().view(np.asarray(v).dtype),
                                          np.asarray(v), err_msg=k)
    want = colors_kernel_layout(np.asarray(ref.dev["colors"]), fmt)
    np.testing.assert_array_equal(to_u32(las.dev["colors_k"]), want)
    assert las.dev["colors_k"].shape == (64, *COLOR_K_SHAPE[fmt])


@pytest.mark.parametrize("mode", ["color", "hqs"])
@pytest.mark.parametrize("fmt", ["raw", "bc7"])
def test_project_streams_equal_reference(scene, fmt, mode):
    """B2's plain version in each format against the reference's XLA
    stage (per op) on a real camera: colour mode with the within-chain
    collapse alone, as the reference's XLA stage has it; HQS raw."""
    ref = scene["ref"][fmt]
    dev = dev_from_numpy({k: np.asarray(v) for k, v in ref.dev.items()}, "cpu")
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEW)
    r.controls_update()
    wvp = r.camera.proj() @ r.camera.view()
    t = wvp.astype(np.float32)
    scale = np.asarray(ref.scale, np.float32)
    tb = ref_cam.batch_translations(wvp, ref.anchor_i[:1], ref.scale, ref.offset, ref.las_min)
    lod = np.array([53], np.int32)
    chunk = jax.jit(functools.partial(
        ref_chunk, width=W, height=H, mode=mode, use_pallas=False, points=64,
        fmt="fixed", nbatches=1, color_fmt=fmt))
    rdyn = (ref.dev, 0, jnp.asarray(t), jnp.asarray(lod), jnp.asarray(scale),
            jnp.zeros(3, jnp.float32))
    want = chunk.lower(*rdyn, tb=jnp.asarray(tb)).compile(compiler_options=O0)(
        *rdyn, tb=jnp.asarray(tb))
    coords = decode_fixed_plain(*(dev[k][:1] for k in ("widths", "streams", "ptrs", "starts")))
    colors_k = from_u32(colors_kernel_layout(np.asarray(ref.dev["colors"])[:1], fmt))
    frame12 = torch.from_numpy(np.concatenate([t[0, :3], t[1, :3], t[3, :3], scale]))
    got = project_plain(coords, colors_k, dev["anchor"][:1],
                        torch.from_numpy(np.asarray(tb, np.float32)), torch.from_numpy(lod),
                        frame12, W, H, collapse=mode == "color", chain_collapse=False,
                        color_fmt=fmt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g).reshape(-1), np.asarray(w))
    size = ref_raster.swizzle_dims(W, H)[2]
    assert (np.asarray(want[0]) < size).sum() > 5_000


_FRAMES = {}


def _o0(fn, dyn, static):
    """`fn` compiled per op, called once per (function, arguments)."""
    key = (fn.__name__, tuple(sorted(static.items())),
           np.asarray(dyn["frame_params"]).tobytes())
    if key not in _FRAMES:
        _FRAMES[key] = fn.lower(**dyn, **static).compile(compiler_options=O0)(**dyn)
    return _FRAMES[key]


def _ref_outputs(ref, args, kind):
    """The reference's frame on the port's frame arguments (per op):
    colour modes -> (fb_d, fb_p, image); "hqs" -> (fb_depth, acc_n, image)."""
    dyn = dict(dev=ref.dev, frame_params=jnp.asarray(args["frame_params"].numpy()),
               scale=jnp.asarray(args["scale"].numpy()),
               offset_rel=jnp.zeros(3, jnp.float32), tb=jnp.asarray(args["tb"].numpy()))
    common = dict(width=W, height=H, nchunks=args["nchunks"], use_pallas=False,
                  cull=args["cull"], points=args["points"], fmt="fixed",
                  color_fmt=args["color_fmt"])
    if kind != "hqs":
        return _o0(ref_frame, dyn, dict(common, mode=kind, need_depth=True))
    fb_depth, _streams = _o0(hqs_prepass_native, dyn, common)
    acc_n, img = _o0(hqs_blend_native, dict(dyn, fb_depth=fb_depth, streams=None), common)
    return ref_raster.unswizzle_plane(fb_depth, W, H), acc_n, img


CASES = {  # case -> (method, flags, the reference's frame kind)
    "colour": ("huffman_tpu", (), "color"),
    "hqs": ("huffman_tpu_hqs", (), "hqs"),
    "edl": ("huffman_tpu", ("--edl",), "color"),
    "chunks": ("huffman_tpu", ("--colorize-chunks",), "colorize_chunks"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fmt", ["raw", "bc7"])
def test_app_frames_equal_reference(scene, fmt, case):
    method, flags, kind = CASES[case]
    rr = app.run(["--scene", scene["tpc"][fmt], "--method", method, "--device", "cpu",
                  "--width", str(W), "--height", str(H), "--lod", "1.0",
                  "--yaw", str(VIEW.yaw), "--pitch", str(VIEW.pitch),
                  "--radius", str(VIEW.radius), "--target", *map(str, VIEW.target), *flags])
    m = Runtime.selected
    assert m.name == method and m.las.color_fmt == fmt
    args = m.frame_args(rr)
    assert args["color_fmt"] == fmt
    ref = scene["ref"][fmt]
    first, second, img = _ref_outputs(ref, args, kind)
    if case == "edl":
        img = ref_raster.edl_shade(img, first.reshape(-1), W, H, Debug.edl_strength)
    img = np.asarray(img)
    np.testing.assert_array_equal(to_u32(rr.last_image), img)
    got_first, got_second = rr.last_fb
    np.testing.assert_array_equal(to_u32(got_second), np.asarray(second).reshape(-1))
    if got_first is not None:
        np.testing.assert_array_equal(to_u32(got_first), np.asarray(first).reshape(-1))
    assert (img != BG).mean() > 0.05
    if fmt == "raw" and case == "colour":  # every winner is an input point's colour
        pts = read_points(scene["las"], 0, 65536)
        allowed = set((np.asarray(pts.color, np.uint32) & 0xFFFFFF).tolist()) | {BG}
        assert set(np.unique(img).tolist()) <= allowed
    m.las.unload()
