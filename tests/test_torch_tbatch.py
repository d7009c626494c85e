"""Port B5 (tbatch decode) and the `.tpc` v1 colour frame vs the JAX
reference, on the CPU.

* `decode_native_plain` gives the coordinates of the TPU kernel
  (`pallas_decode.decode_native_batches`, interpret mode) and of the
  NumPy protocol mirror (`codec.native.decode_native_batch`) bit for
  bit, on `tests/test_pallas_decode.py`'s two clouds, at 64 and 32
  points, and on the crafted corners of `tools/crafted.py` (12-bit
  codes, bucket 32, 2**24 jumps, all-zero chains, a 24.6k-word group
  stream) at 64, 40 and 16; the port's `pack_native_batches` equals the
  reference's.
* `code_table_plain`, the (L, bucket) table B5 builds per block, gives
  the ladder's L and bucket for all 4096 windows on those code tables.
* After `wait_loaded` on a v1 scene, the port's `NativeLasData.dev`
  equals the reference's, plus `colors_k` (B2's colour layout).
* The v1 colour frame (B5 -> B2 -> B3) is bit-exact against the
  reference's `render_frame_native(fmt="tbatch", use_pallas=False)`,
  which projects v1 with XLA ops, compiled per op; so is the v1 HQS
  frame against `hqs_frame_native(fmt="tbatch", use_pallas=False)`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.codec.morton import morton_order
from pcrhpg24_tpu.codec.native import decode_native_batch, encode_native_batch
from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import hqs_blend_native, hqs_prepass_native
from pcrhpg24_tpu.render.pallas_decode import decode_native_batches as ref_decode
from pcrhpg24_tpu.render.pallas_decode import pack_native_batches as ref_pack
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch.convert import dev_to_numpy
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.render.decode_tbatch import (
    code_table_plain,
    decode_native_batches,
    decode_native_plain,
    pack_native_batches,
)
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import HuffmanTpu, render_frame_native
from pcrhpg24_tpu_torch.render.methods.huffman_tpu_hqs import HuffmanTpuHqs, hqs_frame_native
from pcrhpg24_tpu_torch.render.bc1_layout import colors_kernel_layout
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180
VIEWS = {
    "orbit": Setting(yaw=0.5, pitch=-0.9, radius=1500.0, target=(450.0, 450.0, 50.0)),
    "closeup": Setting(yaw=2.4, pitch=-0.25, radius=120.0, target=(450.0, 450.0, 60.0)),
    "oblique": Setting(yaw=-1.1, pitch=-0.08, radius=700.0, target=(450.0, 450.0, 40.0)),
}
KEYS = ("lj", "streams", "ptrs", "dD", "lut", "starts")


@pytest.fixture(autouse=True)
def _restore_globals():
    lod = Debug.lod
    yield
    Debug.lod = lod
    Runtime.clear()


def _cloud(seed):
    """tests/test_pallas_decode.py's cloud: small steps plus rare 2**24 jumps."""
    rng = np.random.default_rng(seed)
    n = 65536
    steps = rng.integers(-80, 80, size=(n, 3))
    steps += rng.integers(-(2**24), 2**24, size=(n, 3)) * (rng.random((n, 1)) < 0.005)
    pts = np.cumsum(steps, axis=0, dtype=np.int64)
    pts = ((pts + 2**31) % 2**32 - 2**31).astype(np.int32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    o = morton_order(x, y, z)
    return x[o], y[o], z[o]


@pytest.fixture(scope="module")
def clouds():
    cl = [_cloud(s) for s in (0, 1)]
    nbs = [encode_native_batch(x, y, z) for x, y, z in cl]
    return cl, nbs, ref_pack(nbs)


def _port_args(packed):
    return [from_u32(packed[k]) if k == "streams" else torch.from_numpy(packed[k])
            for k in KEYS]


def test_pack_native_batches_equal(clouds):
    _cl, nbs, want = clouds
    got = pack_native_batches(nbs)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _check_decode(nbs, packed, points):
    """-> the plain decode, held to the Pallas kernel and the NumPy mirror."""
    want = np.asarray(ref_decode(*(jnp.asarray(packed[k]) for k in KEYS),
                                 interpret=True, points=points))
    got = decode_native_batches(*_port_args(packed), points=points).numpy()
    np.testing.assert_array_equal(got, want)
    plain = decode_native_plain(*_port_args(packed), points=points).numpy()
    np.testing.assert_array_equal(plain, got)
    for b, nb in enumerate(nbs):
        mirror = decode_native_batch(nb).reshape(8, 128, 64, 3)[:, :, :points]
        np.testing.assert_array_equal(np.transpose(got[b], (2, 3, 0, 1)), mirror)
    return got


@pytest.mark.parametrize("points", [64, 32])
def test_decode_plain_equals_kernel_and_mirror(clouds, points):
    cl, nbs, packed = clouds
    got = _check_decode(nbs, packed, points)
    for b, (x, _y, _z) in enumerate(cl):
        np.testing.assert_array_equal(got[b, :, 0].transpose(1, 2, 0).reshape(1024, points),
                                      x.reshape(1024, 64)[:, :points])


@pytest.fixture(scope="module")
def crafted_native():
    nbs = crafted.native_batches(seed=2)
    return nbs, ref_pack(nbs)


def test_crafted_batches_reach_the_corners(crafted_native):
    (corners, wide), _packed = crafted_native
    assert corners.code.lengths.max() == 12 and 32 in corners.code.symbols
    assert 0 in corners.code.symbols
    assert min(len(s) for s in wide.streams) > 24000


@pytest.mark.parametrize("points", [64, 40, 16])
def test_decode_plain_crafted(crafted_native, points):
    nbs, packed = crafted_native
    _check_decode(nbs, packed, points)


def _ladder(win12, packed):
    """(L, bucket) of `decode_native_plain`'s ladder for 12-bit windows
    win12 (B, n), from the limits, dD and the LUT as it reads them."""
    limits = torch.from_numpy(packed["lj"][:, 0]).to(torch.int64)
    dD = torch.from_numpy(packed["dD"][:, 0]).to(torch.int64)
    lut = torch.from_numpy(packed["lut"][:, 0]).to(torch.int64)
    L = torch.ones_like(win12)
    for j in range(1, 12):
        L = L + (win12 >= limits[:, j - 1, None]).to(torch.int64)
    code_L = win12 >> torch.clamp(12 - L, max=12)
    sym_idx = torch.clamp(code_L + torch.gather(dD, 1, L), 0, 127)
    return L, torch.gather(lut, 1, sym_idx)


@pytest.mark.parametrize("which", ["terrain", "crafted"])
def test_code_table_equals_ladder(clouds, crafted_native, which):
    packed = clouds[2] if which == "terrain" else crafted_native[1]
    tab = code_table_plain(torch.from_numpy(packed["lj"]), torch.from_numpy(packed["lut"]))
    B = packed["lj"].shape[0]
    assert tab.shape == (B, 4096) and tab.dtype == torch.int32
    L, bucket = _ladder(torch.arange(4096, dtype=torch.int64).expand(B, 4096), packed)
    np.testing.assert_array_equal((tab & 15).numpy(), L.numpy())
    np.testing.assert_array_equal((tab >> 4).numpy(), bucket.numpy())
    if which == "crafted":
        assert (L == 12).any()  # the code's 12-bit limit is reached


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two-batch `.tpc` v1 (tbatch) scene of test_torch_frame's terrain,
    loaded by the reference; `ref.dev` as numpy."""
    d = tmp_path_factory.mktemp("ttbatch")
    las, tpc = str(d / "s.las"), str(d / "s_v1.tpc")
    xyz, rgb = terrain_cloud(2 * 65536, seed=7, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False, codec="huffman")
    ref = RefData.create(tpc).wait_loaded()
    assert ref.version == 1
    return tpc, ref, {k: np.asarray(v) for k, v in ref.dev.items()}


def test_v1_dev_buffers_equal(scene):
    tpc, ref, ref_dev = scene
    las = NativeLasData.create(tpc, "cpu").wait_loaded()
    assert las.version == 1
    got = dev_to_numpy(las.dev)
    # the colours are held once, in B2's layout: no path reads the flat rows
    assert got.keys() == set(ref_dev) - {"colors"} | {"colors_k"}
    for k, v in ref_dev.items():
        if k == "colors":
            continue
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["colors_k"],
                                  colors_kernel_layout(ref_dev["colors"]))
    np.testing.assert_array_equal(las.anchor_i, ref.anchor_i)
    np.testing.assert_array_equal(las.bbox_min, ref.bbox_min)
    np.testing.assert_array_equal(las.bbox_max, ref.bbox_max)


def test_batch_wider_than_buffer_raises(scene):
    """The v1 stream buffer is sized from the header, which bounds every
    batch; a batch wider than the buffer stops the load with an error
    instead of being cut or lost (ROADMAP C2)."""
    tpc, _ref, _ref_dev = scene
    las = NativeLasData.create(tpc, "cpu")
    las.maxw = 2 * 128  # narrower than any batch of the scene
    with pytest.raises(ValueError):
        las.wait_loaded()
    las.unload()


_COMPILED = {}


def _reference_frame(ref_dev, args):
    """The reference's v1 colour frame on the port's frame arguments,
    compiled with every f32 op rounded on its own (XLA O0)."""
    dyn = dict(dev={k: jnp.asarray(v) for k, v in ref_dev.items()},
               frame_params=jnp.asarray(args["frame_params"].numpy()),
               scale=jnp.asarray(args["scale"].numpy()),
               offset_rel=jnp.zeros(3, jnp.float32),
               tb=jnp.asarray(args["tb"].numpy()))
    static = dict(width=W, height=H, mode="color", nchunks=args["nchunks"],
                  use_pallas=False, cull=args["cull"], points=args["points"],
                  need_depth=False, fmt="tbatch", color_fmt="bc1")
    key = tuple(sorted(static.items()))
    if key not in _COMPILED:
        _COMPILED[key] = ref_frame.lower(**dyn, **static).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    _fb_d, fb_p, img = _COMPILED[key](**dyn)
    return np.asarray(fb_p), np.asarray(img)


@pytest.mark.parametrize("view,lod", [("orbit", 1.0), ("closeup", 1.0),
                                      ("oblique", 0.1)])
def test_v1_frame_bit_exact_vs_reference(scene, view, lod):
    tpc, _ref, ref_dev = scene
    Debug.lod = lod
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    r.controls_update()
    las = NativeLasData.create(tpc, "cpu")
    method = HuffmanTpu(r, las)
    method.update(r)
    las.wait_loaded()
    args = method.frame_args(r)
    assert args["fmt"] == "tbatch"
    _fb_d, fb_p, img = render_frame_native(**args)
    want_p, want_img = _reference_frame(ref_dev, args)
    np.testing.assert_array_equal(to_u32(img), want_img)
    np.testing.assert_array_equal(to_u32(fb_p), want_p)
    assert (want_img != 0x00443322).sum() > 500


def test_v1_hqs_frame_bit_exact_vs_reference(scene):
    tpc, _ref, ref_dev = scene
    Debug.lod = 1.0
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS["oblique"])
    r.controls_update()
    las = NativeLasData.create(tpc, "cpu")
    method = HuffmanTpuHqs(r, las)
    method.update(r)
    las.wait_loaded()
    args = method.frame_args(r)
    assert args["fmt"] == "tbatch"
    fb_d, acc_n, img = hqs_frame_native(**args)
    dyn = dict(dev={k: jnp.asarray(v) for k, v in ref_dev.items()},
               frame_params=jnp.asarray(args["frame_params"].numpy()),
               scale=jnp.asarray(args["scale"].numpy()),
               offset_rel=jnp.zeros(3, jnp.float32),
               tb=jnp.asarray(args["tb"].numpy()))
    static = dict(width=W, height=H, nchunks=args["nchunks"], use_pallas=False,
                  cull=args["cull"], fmt="tbatch", points=args["points"],
                  color_fmt="bc1")
    O0 = {"xla_backend_optimization_level": 0}
    fb_depth, _streams = hqs_prepass_native.lower(**dyn, **static).compile(
        compiler_options=O0)(**dyn)
    blend = dict(dyn, fb_depth=fb_depth, streams=None)
    want_n, want_img = hqs_blend_native.lower(**blend, **static).compile(
        compiler_options=O0)(**blend)
    np.testing.assert_array_equal(to_u32(img), np.asarray(want_img))
    np.testing.assert_array_equal(to_u32(acc_n), np.asarray(want_n))
    live = to_u32(acc_n) > 0
    assert live.sum() > 500 and (to_u32(fb_d)[live] != 0xFFFFFFFF).all()
