"""Port B4 and B9 (HQS blend sums) and the HQS frame vs the JAX
reference, on the CPU.

* `hqs_sums_plain` gives the four (r, g, b, n) planes of the TPU path
  (`pallas_hqs.hqs_sums_from_rows` over pid-sorted rows, interpret
  mode) bit for bit, and of a direct NumPy accumulation.
* `hqs_sums(..., layout="flat")` (B4's flat layout, the `.las` and
  Potree parts) gives them on `crafted.flat_streams` in uneven parts.
* `hqs_sums_from_sorted[_multi]` (B9's plain version) give the planes
  of `pallas_hqs.hqs_sums_from_sorted[_multi]` in interpret mode.
* The port's `huffman_tpu_hqs` frame (decode -> uncollapsed projection
  -> B3 depth prepass -> B4 sums -> unswizzle -> unsigned divide) is
  bit-exact against the reference's `hqs_frame_native(use_pallas=False)`
  with both of its programs compiled per op, for bench's three views at
  LOD 1.0 and one at LOD 0.1: image, depth plane and count plane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import (
    hqs_blend_native,
    hqs_prepass_native,
)
from pcrhpg24_tpu.render.pallas_hqs import (
    hqs_sums_from_rows,
    hqs_sums_from_sorted as ref_sums_from_sorted,
    hqs_sums_from_sorted_multi as ref_sums_from_sorted_multi,
)
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.render.hqs import (
    hqs_sums,
    hqs_sums_from_sorted,
    hqs_sums_from_sorted_multi,
    hqs_sums_plain,
)
from pcrhpg24_tpu_torch.render.methods.huffman_tpu_hqs import (
    HuffmanTpuHqs,
    hqs_frame_native,
)
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

SIZE = 49_152  # 48 swizzle tiles of 1024
W, H = 320, 180
# bench.py's three views, scaled to the 900 m test scene
VIEWS = {
    "orbit": Setting(yaw=0.5, pitch=-0.9, radius=1500.0, target=(450.0, 450.0, 50.0)),
    "closeup": Setting(yaw=2.4, pitch=-0.25, radius=120.0, target=(450.0, 450.0, 60.0)),
    "oblique": Setting(yaw=-1.1, pitch=-0.08, radius=700.0, target=(450.0, 450.0, 40.0)),
}
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _restore_globals():
    lod = Debug.lod
    yield
    Debug.lod = lod
    Runtime.clear()


def _hqs_stream(seed, rows=4, n=4096):
    """pid-sorted rows with heavy collisions, sentinels and a long run."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, SIZE, rows * n).astype(np.uint32)
    pid[rng.random(rows * n) < 0.3] = SIZE
    pid[: 3000] = 777  # one run across window borders
    w = rng.random(rows * n).astype(np.float32) * 100 + 1
    # the run's depths straddle its 1 % tolerance
    w[: 3000] = 5 * (1 + rng.random(3000).astype(np.float32) * 0.02)
    dep = w.view(np.uint32)
    pay = rng.integers(0, 2**24, rows * n, dtype=np.uint64).astype(np.uint32)
    fbd = np.full(SIZE, 0xFFFFFFFF, np.uint32)
    np.minimum.at(fbd, pid[pid < SIZE], dep[pid < SIZE])
    return pid, dep, pay, fbd


def test_hqs_sums_plain_equals_rows_kernel():
    rows, n = 4, 4096
    pid, dep, pay, fbd = _hqs_stream(5, rows, n)
    sp, sd, sy = jax.lax.sort(
        [jnp.asarray(a.reshape(rows, n)) for a in (pid, dep, pay)],
        num_keys=1, is_stable=False, dimension=1)
    want = hqs_sums_from_rows(sp, sd, sy, jnp.asarray(fbd), SIZE, interpret=True)
    # the port reads the UNSORTED stream, split into two parts
    h = len(pid) // 3
    parts = [tuple(from_u32(a[:h]) for a in (pid, dep, pay)),
             tuple(from_u32(a[h:]) for a in (pid, dep, pay))]
    got = hqs_sums(parts, from_u32(fbd), SIZE)  # CPU tensors: the plain version
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert to_u32(got[3])[777] > 100


def test_hqs_sums_plain_equals_numpy_and_wraps():
    """Direct accumulation with the f32 tolerance gate; the planes wrap
    mod 2**32 like the reference's u32 planes."""
    pid, dep, pay, fbd = _hqs_stream(9)
    old = fbd.view(np.float32)
    w = dep.view(np.float32)
    keep = (pid < SIZE) & (w <= old[np.minimum(pid, SIZE - 1)] * np.float32(1.01))
    want = np.zeros((4, SIZE), np.uint64)
    for a, c in zip(want, (pay & 0xFF, (pay >> 8) & 0xFF, (pay >> 16) & 0xFF,
                           np.ones_like(pay))):
        np.add.at(a, pid[keep], c[keep].astype(np.uint64))
    parts = [tuple(from_u32(a) for a in (pid, dep, pay))]
    got = hqs_sums_plain(parts, from_u32(fbd), SIZE)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), w_.astype(np.uint32))
    # 2**24 + 1 entries on one pixel at pay 255 wrap the r plane
    many = 2**24 + 1
    p = torch.full((many,), 5, dtype=torch.int32)
    d = torch.full((many,), 0x3F800000, dtype=torch.int32)
    y = torch.full((many,), 255, dtype=torch.int32)
    fb = torch.full((8,), 0x3F800000, dtype=torch.int32)
    r, _g, _b, n = hqs_sums_plain([(p, d, y)], fb, 8)
    assert to_u32(r)[5] == (255 * many) % 2**32
    assert to_u32(n)[5] == many


@pytest.mark.parametrize("kind", crafted.HQS_KINDS)
def test_hqs_sums_plain_equals_rows_kernel_crafted(kind):
    """Crafted streams (tools/crafted.py): one pixel for every entry, two
    pixels alternating, sentinel pids (size, size + 1, 2**32 - 1), EMPTY
    depths, depths at the tolerance and one ulp above it."""
    rows, n = 4, 4096
    pid, dep, pay, fbd = crafted.hqs_streams(kind, rows * n // 1024, SIZE, seed=3)
    sp, sd, sy = jax.lax.sort(
        [jnp.asarray(a.reshape(rows, n)) for a in (pid, dep, pay)],
        num_keys=1, is_stable=False, dimension=1)
    want = hqs_sums_from_rows(sp, sd, sy, jnp.asarray(fbd), SIZE, interpret=True)
    got = hqs_sums_plain([tuple(from_u32(a) for a in (pid, dep, pay))],
                         from_u32(fbd), SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    counts = to_u32(got[3])
    assert 0 < counts.sum() < (pid < SIZE).sum()  # some accepted, some not
    if kind in ("sentinel", "mixed"):
        assert (pid >= SIZE).any() and (counts > 0).sum() > 1  # sentinels, many pixels


@pytest.mark.parametrize("kind", crafted.FLAT_KINDS)
def test_hqs_sums_flat_crafted_equals_rows_kernel(kind):
    """Flat crafted streams (one pixel, runs of one pixel, random pixels)
    through `hqs_sums(..., layout="flat")` on the CPU, in five uneven
    parts none a multiple of the flat tile's 512 entries and in both
    orders, against the TPU path over the pid-sorted stream padded with
    dead entries to 4 rows of 4096."""
    n = 4 * 4096 - 333
    pid, dep, _pay, colour, fbd = crafted.flat_streams(kind, n, SIZE, seed=5)
    padded = [np.concatenate([a, np.full(4 * 4096 - n, fill, np.uint32)]).reshape(4, 4096)
              for a, fill in ((pid, SIZE), (dep, 0), (colour, 0))]
    sp, sd, sy = jax.lax.sort([jnp.asarray(a) for a in padded], num_keys=1,
                              is_stable=False, dimension=1)
    want = hqs_sums_from_rows(sp, sd, sy, jnp.asarray(fbd), SIZE, interpret=True)
    cuts = crafted.flat_cuts(n, 5, seed=1)
    parts = [tuple(from_u32(a[x:y]) for a in (pid, dep, colour))
             for x, y in zip(cuts, cuts[1:])]
    for order in (parts, parts[::-1]):
        got = hqs_sums(order, from_u32(fbd), SIZE, layout="flat")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    counts = to_u32(got[3])
    assert 0 < counts.sum() <= (pid < SIZE).sum()
    if kind == "one_pixel":
        assert counts.sum() == n  # every entry accepted
    else:
        assert counts.sum() < (pid < SIZE).sum()


def _sorted_nk1(*arrays):
    out = jax.lax.sort([jnp.asarray(a) for a in arrays], num_keys=1,
                       is_stable=False)
    return tuple(np.asarray(a) for a in out)


def test_hqs_sums_from_sorted_equals_reference_kernel():
    """A whole-window single run, and pixels whose depth plane is EMPTY
    (a NaN that accepts nothing) though entries land there."""
    pid, dep, pay, fbd = _hqs_stream(11, rows=1, n=16 * 1024)
    pid[3000:5048] = 4321  # 2048 entries: whole 1024-entry windows of one run
    w = dep.view(np.float32)
    w[3000:5048] = 7 * (1 + np.random.default_rng(1).random(2048).astype(np.float32)
                        * 0.02)
    fbd[:] = 0xFFFFFFFF
    np.minimum.at(fbd, pid[pid < SIZE], dep[pid < SIZE])
    emptied = np.unique(pid[6000:6100][pid[6000:6100] < SIZE])
    fbd[emptied] = 0xFFFFFFFF
    s = _sorted_nk1(pid, dep, pay)
    want = ref_sums_from_sorted(*map(jnp.asarray, s), jnp.asarray(fbd), SIZE,
                                interpret=True)
    got = hqs_sums_from_sorted(*(from_u32(a) for a in s), from_u32(fbd), SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    n_plane = to_u32(got[3])
    assert n_plane[4321] > 100 and n_plane[777] > 100
    assert len(emptied) > 50 and (n_plane[emptied] == 0).all()


def test_hqs_sums_from_sorted_multi_equals_reference_kernel():
    pid, dep, pay, fbd = _hqs_stream(13, rows=1, n=16 * 1024)
    h = 7 * 1024
    parts = [_sorted_nk1(pid[:h], dep[:h], pay[:h]),
             _sorted_nk1(pid[h:], dep[h:], pay[h:])]
    want = ref_sums_from_sorted_multi(
        [tuple(map(jnp.asarray, p)) for p in parts], jnp.asarray(fbd), SIZE,
        interpret=True)
    got = hqs_sums_from_sorted_multi(
        [tuple(from_u32(a) for a in p) for p in parts], from_u32(fbd), SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two-batch `.tpc` v2 scene (test_torch_frame's), loaded by the
    reference; `ref.dev` as numpy."""
    d = tmp_path_factory.mktemp("thqs")
    las, tpc = str(d / "s.las"), str(d / "s.tpc")
    xyz, rgb = terrain_cloud(2 * 65536, seed=7, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    ref = RefData.create(tpc).wait_loaded()
    return tpc, ref, {k: np.asarray(v) for k, v in ref.dev.items()}


_COMPILED = {}


def _per_op(fn, dyn: dict, static: dict):
    """`fn` compiled with every f32 op rounded on its own (XLA O0),
    cached per static arguments, called on the dynamic ones."""
    key = (fn.__name__, tuple(sorted(static.items())))
    if key not in _COMPILED:
        _COMPILED[key] = fn.lower(**dyn, **static).compile(compiler_options=O0)
    return _COMPILED[key](**dyn)


def _reference_hqs(ref_dev, args):
    """The reference's HQS frame on the port's frame arguments."""
    dyn = dict(dev={k: jnp.asarray(v) for k, v in ref_dev.items()},
               frame_params=jnp.asarray(args["frame_params"].numpy()),
               scale=jnp.asarray(args["scale"].numpy()),
               offset_rel=jnp.zeros(3, jnp.float32),
               tb=jnp.asarray(args["tb"].numpy()))
    static = dict(width=W, height=H, nchunks=args["nchunks"], use_pallas=False,
                  cull=args["cull"], fmt=args["fmt"], points=args["points"],
                  color_fmt="bc1")
    fb_depth, _streams = _per_op(hqs_prepass_native, dyn, static)
    acc_n, img = _per_op(hqs_blend_native, dict(dyn, fb_depth=fb_depth,
                                                streams=None), static)
    return (np.asarray(ref_raster.unswizzle_plane(fb_depth, W, H)),
            np.asarray(acc_n), np.asarray(img))


@pytest.mark.parametrize("view,lod", [("orbit", 1.0), ("closeup", 1.0),
                                      ("oblique", 1.0), ("oblique", 0.1)])
def test_hqs_frame_bit_exact_vs_reference(scene, view, lod):
    tpc, _ref, ref_dev = scene
    Debug.lod = lod
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    r.controls_update()
    las = NativeLasData.create(tpc, "cpu")
    method = HuffmanTpuHqs(r, las)
    method.update(r)
    las.wait_loaded()
    args = method.frame_args(r)
    assert args["fmt"] == "fixed"
    fb_d, acc_n, img = hqs_frame_native(**args)
    want_d, want_n, want_img = _reference_hqs(ref_dev, args)
    np.testing.assert_array_equal(to_u32(img), want_img)
    np.testing.assert_array_equal(to_u32(fb_d), want_d)
    np.testing.assert_array_equal(to_u32(acc_n), want_n)
    assert (want_img != 0x00443322).sum() > 500
    assert want_n.max() > 1  # the blend averaged several points somewhere


def test_app_renders_hqs(scene, tmp_path):
    """`--method huffman_tpu_hqs` is registered and renders a PNG."""
    tpc, _ref, _dev = scene
    s = VIEWS["orbit"]
    out = tmp_path / "hqs.png"
    rr = app.run([
        "--scene", tpc, "--method", "huffman_tpu_hqs", "--device", "cpu",
        "--width", str(W), "--height", str(H), "--lod", "1.0",
        "--yaw", str(s.yaw), "--pitch", str(s.pitch), "--radius", str(s.radius),
        "--target", *map(str, s.target), "--screenshot", str(out),
    ])
    assert Runtime.selected.name == "huffman_tpu_hqs"
    assert [m.name for m in Runtime.methods] == ["huffman_tpu", "huffman_tpu_hqs"]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    fb_d, acc_n = rr.last_fb
    assert fb_d.shape == acc_n.shape == (W * H,)
    assert (rr.last_image != 0x00443322).sum() > 500
