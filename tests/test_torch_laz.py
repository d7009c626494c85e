"""`.laz` and multi-file scenes of the PyTorch port vs the JAX reference,
on the CPU: the port's copy of the NumPy LAZ codec (`formats/laz.py`)
writes the reference's bytes and reads its points, `preprocess_las`
reads a `.laz`, and `engine/las_sparse.LasSparseData` (two `.las` and
one `.laz`, one file on another grid) holds the reference's device
buffers and boxes; the app renders a `dir/*.las` and an `a.las,b.laz`
scene through `basic`, bit-exact against the reference's chunk
function at XLA O0 over the loaded points.  The pure-Python codec is
slow, so every `.laz` here has at most 65,536 points.
"""

import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.engine.las_sparse import LasSparseData as RefSparse
from pcrhpg24_tpu.formats import las as ref_las
from pcrhpg24_tpu.formats import laz as ref_laz
from pcrhpg24_tpu.preprocess import preprocess_las as ref_preprocess
from pcrhpg24_tpu.preprocess import preprocess_las_tpc as ref_preprocess_tpc
from pcrhpg24_tpu.render.methods import basic as ref_basic
from pcrhpg24_tpu.render.methods import loop_las as ref_loop
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.engine import las_sparse
from pcrhpg24_tpu_torch.engine.las_sparse import LasSparseData, expand_scene_paths
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.formats import las, laz
from pcrhpg24_tpu_torch.preprocess import preprocess_las, preprocess_las_tpc
from pcrhpg24_tpu_torch.render.methods.basic import BasicMethod
from pcrhpg24_tpu_torch.u32 import to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 256, 144
O0 = {"xla_backend_optimization_level": 0}
EMPTY32 = 0xFFFFFFFF
VIEW = dict(yaw=0.5, pitch=-0.8, radius=450.0, target=(150.0, 150.0, 100.0))
SIZES = (40_000, 30_000, 20_000)  # f0.las, f1.laz (another grid), f2.las


@pytest.fixture(autouse=True)
def _clear_runtime():
    yield
    Runtime.clear()


def _walk(fmt: int, n: int):
    """`tests/test_laz.py`'s random-walk points, RGB and GPS times."""
    rng = np.random.default_rng(fmt)
    base = np.cumsum(rng.integers(-50, 51, (n, 3)), axis=0)
    x, y, z = (base[:, i].astype(np.int32) for i in range(3))
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    gps = np.cumsum(rng.random(n) * 1e-4) + 300000.0
    return x, y, z, dict(rgb=rgb if fmt in (2, 3) else None,
                         gps_time=gps if fmt in (1, 3) else None, point_format=fmt)


def _same_points(got, want):
    for k in ("x", "y", "z", "color"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_laz_writer_and_reader_equal_reference(tmp_path, fmt):
    """Point formats 0-3 (POINT10, GPSTIME11, RGB12), three chunks: the
    copy writes the reference's bytes, and reads its points through
    `formats/las.read_points`."""
    x, y, z, kw = _walk(fmt, 3000)
    port, ref = str(tmp_path / "port.laz"), str(tmp_path / "ref.laz")
    laz.write_laz(port, x, y, z, chunk_size=1000, **kw)
    ref_laz.write_laz(ref, x, y, z, chunk_size=1000, **kw)
    assert open(port, "rb").read() == open(ref, "rb").read()
    got = las.read_points(ref)
    assert got.header.compressed and got.header.point_format == fmt
    _same_points(got, ref_las.read_points(ref))
    np.testing.assert_array_equal(got.x, x)


def test_laz_partial_reads_equal_reference(tmp_path):
    """Reads that start and end inside chunks, and span one."""
    x, y, z, kw = _walk(0, 2500)
    path = str(tmp_path / "p.laz")
    ref_laz.write_laz(path, x, y, z, chunk_size=1000, **kw)
    for first, count in ((1500, 600), (999, 2), (0, 2500), (2400, 500)):
        got = laz.read_laz_points(path, first=first, count=count)
        _same_points(got, ref_laz.read_laz_points(path, first=first, count=count))
        np.testing.assert_array_equal(got.z, z[first:first + count])


@pytest.mark.parametrize("kind", ["huffman", "tpc"])
def test_preprocess_from_laz_writes_reference_bytes(tmp_path, kind):
    """The port's preprocessor reads a `.laz` (70,000 points, two
    batches) and writes the reference's `.huffman` / `.tpc` bytes."""
    xyz, rgb = terrain_cloud(70_000, seed=4, extent=300.0)
    grid = cloud_to_grid(xyz)
    src = str(tmp_path / "s.laz")
    ref_laz.write_laz(src, grid[:, 0], grid[:, 1], grid[:, 2], rgb=rgb, point_format=2)
    port, ref = str(tmp_path / f"port.{kind}"), str(tmp_path / f"ref.{kind}")
    if kind == "huffman":
        preprocess_las(src, port, sort=True, verbose=False)
        ref_preprocess(src, ref, sort=True, verbose=False)
    else:
        preprocess_las_tpc(src, port, sort=True, verbose=False)
        ref_preprocess_tpc(src, ref, sort=True, verbose=False)
    assert open(port, "rb").read() == open(ref, "rb").read()


@functools.lru_cache(maxsize=1)
def _files(root: str) -> tuple:
    """A 90,000-point terrain in three files: f0.las, f1.laz on a 1 cm
    grid offset by (5, 7, 0) m, f2.las; the first and last on 1 mm."""
    xyz, rgb = terrain_cloud(sum(SIZES), seed=12, extent=300.0)
    edges = np.cumsum((0,) + SIZES)
    paths = []
    for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        if i == 1:
            scale, offset = (0.01, 0.01, 0.01), (5.0, 7.0, 0.0)
            g = cloud_to_grid(xyz[a:b], scale=scale, offset=offset)
            p = f"{root}/f1.laz"
            ref_laz.write_laz(p, g[:, 0], g[:, 1], g[:, 2], rgb=rgb[a:b], scale=scale,
                              offset=offset, point_format=2)
        else:
            g = cloud_to_grid(xyz[a:b])
            p = f"{root}/f{i}.las"
            ref_las.write_las(p, g[:, 0], g[:, 1], g[:, 2], rgb[a:b])
        paths.append(p)
    return tuple(paths)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(str(tmp_path_factory.mktemp("tlaz")))


def test_las_sparse_buffers_equal_reference(files):
    """Two `.las` and a `.laz` on another grid: re-quantized, carried
    over file ends in whole batches, padded at the end; the device
    buffers, boxes and counters equal the reference's."""
    pattern = ",".join(files)
    assert expand_scene_paths(pattern) == list(files)
    port = LasSparseData.create(pattern, "cpu").wait_loaded()
    ref = RefSparse.create(pattern).wait_loaded()
    assert set(port.dev) == set(ref.dev)
    for k, v in ref.dev.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(port.dev[k].numpy().view(v.dtype), v, err_msg=k)
    for a in ("num_points", "num_batches", "num_points_loaded", "num_batches_loaded"):
        assert getattr(port, a) == getattr(ref, a), a
    assert port.num_points_loaded == 2 * 65536 > sum(SIZES)
    for a in ("bbox_min", "bbox_max", "las_min", "scale", "offset"):
        np.testing.assert_array_equal(getattr(port, a), getattr(ref, a), err_msg=a)
    port.unload()
    ref.unload()
    assert port.dev == {} and port.num_points_loaded == 0


def test_las_sparse_unload_stops_a_blocked_loader(files, monkeypatch):
    """A loader thread blocked on the full queue (4 chunks, none taken)
    stops at `unload`, and a reload starts from the first point."""
    monkeypatch.setattr(las_sparse, "CHUNK_POINTS", 1000)
    data = LasSparseData.create(files[0], "cpu")
    data.load()
    for _ in range(200):  # the queue fills: 4 chunks wait, the fifth put blocks
        if data._queue.full():
            break
        threading.Event().wait(0.01)
    assert data._queue.full()
    thread = data._thread
    data.unload()
    assert not thread.is_alive()
    data.wait_loaded()
    ref = RefSparse.create(files[0]).wait_loaded()
    np.testing.assert_array_equal(data.dev["x"].numpy(), np.asarray(ref.dev["x"]))
    data.unload()


def _ref_basic_image(ref, cam):
    """The reference's `basic` frame over the loaded points, its chunk
    function compiled at O0 -> (fb_d, fb_p, image) as numpy."""
    n = ref.num_points_loaded
    d = ref.dev
    dyn = dict(x=d["x"][:n], y=d["y"][:n], z=d["z"][:n],
               scale=jnp.asarray(ref.scale, jnp.float32),
               offset_rel=jnp.asarray(ref.offset - ref.las_min, jnp.float32),
               transform=jnp.asarray((cam.proj() @ cam.view()).astype(np.float32)),
               base_index=jnp.uint32(0), fb_d=jnp.full(W * H, EMPTY32, jnp.uint32),
               fb_p=jnp.full(W * H, EMPTY32, jnp.uint32), n_valid=jnp.uint32(n))
    fb_d, fb_p = ref_basic.raster_chunk_basic.lower(**dyn, width=W, height=H).compile(
        compiler_options=O0)(**dyn)
    img = ref_loop.resolve_indexed(fb_p, d["rgba"], W, H)
    return np.asarray(fb_d), np.asarray(fb_p), np.asarray(img)


@pytest.mark.parametrize("scene", ["glob", "comma"])
def test_app_multi_file_scene_equals_reference(files, scene):
    """`--scene 'dir/f*.las'` (two `.las`) and `--scene 'f0.las,f1.laz'`
    build `basic` on `LasSparseData`; its planes and image equal the
    reference's frame."""
    root = files[0].rsplit("/", 1)[0]
    pattern = f"{root}/f*.las" if scene == "glob" else f"{files[0]},{files[1]}"
    argv = ["--scene", pattern, "--device", "cpu", "--width", str(W), "--height", str(H),
            "--yaw", str(VIEW["yaw"]), "--pitch", str(VIEW["pitch"]),
            "--radius", str(VIEW["radius"]), "--target", *map(str, VIEW["target"])]
    rr = app.run(argv)
    (m,) = Runtime.methods
    assert isinstance(m, BasicMethod) and isinstance(m.las, LasSparseData)
    assert m.las.paths == expand_scene_paths(pattern)
    ref = RefSparse.create(pattern).wait_loaded()
    fb_d, fb_p, img = _ref_basic_image(ref, rr.camera)
    np.testing.assert_array_equal(to_u32(rr.last_fb[0]), fb_d)
    np.testing.assert_array_equal(to_u32(rr.last_fb[1]), fb_p)
    np.testing.assert_array_equal(to_u32(rr.last_image), img)
    assert (img != 0x00443322).sum() > 1000
    m.las.unload()
    ref.unload()
