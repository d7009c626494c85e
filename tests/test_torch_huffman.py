"""The port's `.huffman` scenes vs the JAX package, on the CPU.

On the scene of `tests/test_native_pipeline.py` (150,000 terrain points,
three batches), written by the reference's preprocessor:

* `HuffmanLasData.dev` equals the reference's (plus `colors_k`, the
  colours in B2's layout), with the same anchors and boxes.
* `huffman_mem_iter` (B12 -> B2 -> B3 on the CPU) gives the reference's
  `render_chunk` loop's (fb_d, fb_p) planes and image bit for bit, the
  reference compiled at XLA O0 (no FMA contraction).
* `huffman_hqs` gives the reference's depth prepass, count plane and
  image bit for bit.
* `HuffmanNativeData` (the load-time transcode) has the reference's
  device buffers, and its `huffman_tpu` image equals the `.tpc` v2
  scene's; its stream buffer grows for each popped task, so a batch
  wider than batch 0's 1.5x estimate that arrives after any look at the
  queue still loads (ROADMAP C2).
* The app registers `huffman_mem_iter` (selected), `huffman_hqs` and
  `huffman_tpu` for a `.huffman` scene, writes the reference's PNG, and
  raises when the load-time transcode fails.
"""

import functools
from queue import Queue
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.engine.native_resource import HuffmanNativeData as RefNativeData
from pcrhpg24_tpu.engine.resource import HuffmanLasData as RefData
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las, preprocess_las_tpc
from pcrhpg24_tpu.render import camera as ref_cam
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods import huffman_hqs as ref_hqs
from pcrhpg24_tpu.render.methods import huffman_mem_iter as ref_mem_iter
from pcrhpg24_tpu.utils.png import write_png_bytes
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app, native
from pcrhpg24_tpu_torch.codec.batch_codec import decode_batch, deltas_to_coords
from pcrhpg24_tpu_torch.convert import dev_to_numpy
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import HuffmanNativeData, NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.engine.resource import HuffmanLasData, ResourceState
from pcrhpg24_tpu_torch.formats.huffman_file import read_batch, read_file_header, write_huffman_file
from pcrhpg24_tpu_torch.preprocess import preprocess_chunk
from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_plain
from pcrhpg24_tpu_torch.render.methods.huffman_hqs import HuffmanHQS, hqs_huffman_frame
from pcrhpg24_tpu_torch.render.methods.huffman_mem_iter import HuffmanMemIter, mem_iter_frame
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import HuffmanTpu, render_frame_native
from pcrhpg24_tpu_torch.render.bc1_layout import colors_kernel_layout
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 256, 144
O0 = {"xla_backend_optimization_level": 0}
VIEWS = {  # test_native_pipeline.py's view, a close-up, a far view (LOD bucket 48)
    "orbit": Setting(yaw=0.7, pitch=-0.7, radius=800.0, target=(450.0, 450.0, 100.0)),
    "closeup": Setting(yaw=2.4, pitch=-0.25, radius=120.0, target=(450.0, 450.0, 60.0)),
    "far": Setting(yaw=-1.1, pitch=-0.5, radius=2500.0, target=(450.0, 450.0, 40.0)),
}
EMPTY32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _restore_globals():
    lod = Debug.lod
    yield
    Debug.lod = lod
    Runtime.clear()


@functools.lru_cache(maxsize=1)
def _scene(root: str):
    las, huf, tpc = f"{root}/s.las", f"{root}/s.huffman", f"{root}/s.tpc"
    xyz, rgb = terrain_cloud(150_000, seed=21, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las(las, huf, sort=True, verbose=False)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    return huf, tpc, RefData.create(huf).wait_loaded()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(.huffman path, .tpc v2 path, the reference's loaded HuffmanLasData)."""
    return _scene(str(tmp_path_factory.mktemp("thuffman")))


def _camera(view: str) -> Renderer:
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    r.controls_update()
    return r


@functools.lru_cache(maxsize=None)
def _reference_mem_iter(root: str, view: str, lod: float):
    """The reference's `render_chunk` loop (one 256-batch chunk) at O0
    -> (fb_d, fb_p, image) as numpy u32."""
    _huf, _tpc, ref = _scene(root)
    cam = _camera(view).camera
    wvp = (cam.proj() @ cam.view()).astype(np.float32)
    lod_full = _lod_full(ref, cam, lod)
    tb = ref_cam.batch_translations(cam.proj() @ cam.view(),
                                    ref.anchor_i[:ref.dev["anchor"].shape[0]],
                                    ref.scale, ref.offset, ref.las_min)
    fb_d, fb_p = (jnp.full((W * H,), EMPTY32, jnp.uint32) for _ in range(2))
    dyn = (jnp.asarray(wvp), jnp.asarray(lod_full), jnp.asarray(ref.scale, jnp.float32),
           jnp.asarray(ref.offset - ref.las_min, jnp.float32))
    comp = ref_mem_iter.render_chunk.lower(
        ref.dev, 0, *dyn, W, H, "color", fb_d, fb_p, jnp.asarray(tb)).compile(
        compiler_options=O0)
    fb_d, fb_p = comp(ref.dev, 0, *dyn, fb_d, fb_p, jnp.asarray(tb))
    img = ref_raster.resolve(fb_p, W, H)
    return np.asarray(fb_d), np.asarray(fb_p), np.asarray(img)


def _lod_full(ref, cam, lod: float) -> np.ndarray:
    """The reference method's host cull + LOD counts."""
    from pcrhpg24_tpu.engine.debug import Debug as RefDebug

    RefDebug.lod = lod
    m = ref_mem_iter.HuffmanMemIter(SimpleNamespace(), ref)
    return m.frame_setup(SimpleNamespace(width=W, height=H, camera=cam))[1]


def test_huffman_las_data_dev_equal(scene):
    huf, _tpc, ref = scene
    las = HuffmanLasData.create(huf, "cpu").wait_loaded()
    got = dev_to_numpy(las.dev)
    ref_dev = {k: np.asarray(v) for k, v in ref.dev.items()}
    assert set(got) == set(ref_dev) | {"colors_k"}
    for k, v in ref_dev.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["colors_k"], colors_kernel_layout(ref_dev["colors"]))
    np.testing.assert_array_equal(las.anchor_i, ref.anchor_i)
    np.testing.assert_array_equal(las.bbox_min, ref.bbox_min)
    np.testing.assert_array_equal(las.bbox_max, ref.bbox_max)
    assert las.dev["encoding"].numel() == ref.header.encoding_bytes // 4 + 64  # overread pad


@pytest.mark.parametrize("view,lod", [("orbit", 1.0), ("closeup", 1.0), ("far", 0.1)])
def test_mem_iter_frame_equals_reference(scene, view, lod):
    huf, _tpc, _ref = scene
    want_d, want_p, want_img = _reference_mem_iter(str(huf).rsplit("/", 1)[0], view, lod)
    Debug.lod = lod
    r = _camera(view)
    las = HuffmanLasData.create(huf, "cpu").wait_loaded()
    args = HuffmanMemIter(r, las).frame_args(r)
    if lod < 1.0:
        assert args["points"] < 64  # a LOD bucket: only a prefix decodes
    fb_d, fb_p, img = mem_iter_frame(**args)
    np.testing.assert_array_equal(fb_d.numpy().view(np.uint32), want_d)
    np.testing.assert_array_equal(fb_p.numpy().view(np.uint32), want_p)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), want_img)
    assert (want_img != 0x00443322).sum() > 500


@pytest.mark.parametrize("view", ["orbit", "closeup"])
def test_hqs_frame_equals_reference(scene, view):
    huf, _tpc, ref = scene
    Debug.lod = 1.0
    r = _camera(view)
    las = HuffmanLasData.create(huf, "cpu").wait_loaded()
    args = HuffmanHQS(r, las).frame_args(r)
    fb_d, acc_n, img = hqs_huffman_frame(**args)

    dyn = (jnp.asarray(args["transform"].numpy()), jnp.asarray(args["lod"].numpy()),
           jnp.asarray(ref.scale, jnp.float32),
           jnp.asarray(ref.offset - ref.las_min, jnp.float32))
    fbd = jnp.full((W * H,), EMPTY32, jnp.uint32)
    fbd = ref_hqs.depth_chunk.lower(ref.dev, 0, *dyn, fbd, W, H).compile(
        compiler_options=O0)(ref.dev, 0, *dyn, fbd)
    acc = [jnp.zeros((W * H,), jnp.uint32) for _ in range(4)]
    acc = ref_hqs.accumulate_chunk.lower(ref.dev, 0, *dyn, fbd, *acc, W, H).compile(
        compiler_options=O0)(ref.dev, 0, *dyn, fbd, *acc)
    want = np.asarray(ref_hqs.resolve_hqs(*acc, W, H))
    np.testing.assert_array_equal(fb_d.numpy().view(np.uint32), np.asarray(fbd))
    np.testing.assert_array_equal(acc_n.numpy().view(np.uint32), np.asarray(acc[3]))
    np.testing.assert_array_equal(img.numpy().view(np.uint32), want)
    assert (want != 0x00443322).sum() > 500


def test_native_data_dev_equal(scene):
    huf, _tpc, _ref = scene
    ref = RefNativeData.create(huf).wait_loaded()
    las = HuffmanNativeData.create(huf, "cpu").wait_loaded()
    got = dev_to_numpy(las.dev)
    ref_dev = {k: np.asarray(v) for k, v in ref.dev.items()}
    assert got.keys() == ref_dev.keys() - {"colors"}  # held as `colors_k` alone
    for k, v in ref_dev.items():
        if k == "colors":
            continue
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(las.anchor_i, ref.anchor_i)
    np.testing.assert_array_equal(las.bbox_min, ref.bbox_min)


@pytest.mark.parametrize("view", ["orbit", "closeup"])
def test_native_data_image_equals_tpc(scene, view):
    """The load-time transcode renders the `.tpc` v2 scene's image
    (`tests/test_native_pipeline.py:227-244`)."""
    huf, tpc, _ref = scene
    Debug.lod = 1.0
    imgs = []
    for data in (HuffmanNativeData.create(huf, "cpu"), NativeLasData.create(tpc, "cpu")):
        r = _camera(view)
        m = HuffmanTpu(r, data)
        m.update(r)
        data.wait_loaded()
        imgs.append(render_frame_native(**m.frame_args(r))[2].numpy())
        data.unload()
        Runtime.clear()
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert (imgs[1] != 0x00443322).sum() > 500


class _LateQueue(Queue):
    """A queue whose items never show in `.queue`: each arrives only
    when it is popped, as a task that comes in after every look at the
    queue does."""

    def _init(self, maxsize):
        super()._init(maxsize)
        self.hidden = []

    def _put(self, item):
        self.hidden.append(item)

    def _get(self):
        return self.hidden.pop(0)

    def _qsize(self):
        return len(self.hidden)


def test_native_data_grows_for_each_popped_task(tmp_path):
    """ROADMAP C2: batch 1's stream (32-bit deltas: 24,576 words a group)
    is wider than 1.5x batch 0's (a smooth walk); it loads, decoding to
    its own points, though it reaches the loader only when popped."""
    rng = np.random.default_rng(4)
    smooth = np.cumsum(rng.integers(-2, 3, (65536, 3)), axis=0)
    wide = rng.integers(-(2**31), 2**31, (65536, 3))
    pts = np.concatenate([smooth, wide]).astype(np.int32)
    header = SimpleNamespace(scale=np.full(3, 0.001), offset=np.zeros(3),
                             cmin=np.full(3, -2.2e6), cmax=np.full(3, 2.2e6))
    dumps = preprocess_chunk(pts[:, 0], pts[:, 1], pts[:, 2],
                             np.zeros(len(pts), np.uint32), header, 0, sort=False)
    path = str(tmp_path / "wide.huffman")
    write_huffman_file(path, dumps)

    las = HuffmanNativeData.create(path, "cpu")
    las.BATCHES_PER_TASK = 1
    las._queue = _LateQueue()
    first_maxt = las.maxt
    las.wait_loaded()
    assert las.state == ResourceState.LOADED and las.num_batches_loaded == 2
    assert las.maxt > first_maxt and las.dev["streams"].shape[1] == las.maxt
    d = las.dev
    coords = decode_fixed_plain(d["widths"][:2], d["streams"][:2], d["ptrs"][:2],
                                d["starts"][:2])
    hdr = read_file_header(path)
    for i in range(2):
        b = read_batch(path, hdr, i)
        want = deltas_to_coords(decode_batch(
            b.encoding, b.cluster_sizes, b.separate, b.separate_sizes,
            b.decoder_values, b.decoder_cw_len), b.start_values)
        got = coords[i].permute(2, 3, 0, 1).reshape(65536, 3).numpy()
        np.testing.assert_array_equal(got, want)


def test_app_routes_huffman_scenes(scene, tmp_path):
    huf, _tpc, _ref = scene
    methods = app.build_methods(Renderer(W, H, "cpu"), huf)
    assert [m.name for m in methods] == ["huffman_mem_iter", "huffman_hqs", "huffman_tpu"]
    assert Runtime.selected.name == "huffman_mem_iter"
    assert methods[0].las is methods[1].las
    assert isinstance(methods[2].las, HuffmanNativeData)
    Runtime.clear()
    s = VIEWS["orbit"]
    out = tmp_path / "port.png"
    assert app.main([
        "--scene", huf, "--device", "cpu", "--width", str(W), "--height", str(H),
        "--lod", "1.0", "--yaw", str(s.yaw), "--pitch", str(s.pitch),
        "--radius", str(s.radius), "--target", *map(str, s.target),
        "--screenshot", str(out)]) == 0
    assert Runtime.selected.name == "huffman_mem_iter"
    _d, _p, want = _reference_mem_iter(str(huf).rsplit("/", 1)[0], "orbit", 1.0)
    rgb = np.asarray(ref_raster.image_to_rgb8(jnp.asarray(want)))
    assert out.read_bytes() == write_png_bytes(rgb)


def test_failed_transcode_raises(scene, monkeypatch):
    """The reference warns and drops `huffman_tpu`; the port raises."""
    huf, _tpc, _ref = scene

    def broken(_b, maxw=16384):
        raise RuntimeError("transcode_ref_batch failed: rc -7 at maxw 16384")

    monkeypatch.setattr(native, "transcode_ref_batch", broken)
    with pytest.raises(RuntimeError, match="rc -7"):
        app.build_methods(Renderer(W, H, "cpu"), huf)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="codec core"):
        app.build_methods(Renderer(W, H, "cpu"), huf)


def test_loader_thread_state_is_released(scene):
    """`unload` stops the loader and drops the buffers; a reload gives
    the same device state."""
    huf, _tpc, _ref = scene
    las = HuffmanLasData.create(huf, "cpu").wait_loaded()
    before = dev_to_numpy(las.dev)
    las.unload()
    assert las.dev == {} and las.num_batches_loaded == 0
    assert not las._thread.is_alive()
    las.wait_loaded()
    after = dev_to_numpy(las.dev)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
