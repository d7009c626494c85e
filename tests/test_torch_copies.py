"""The port's own copies of the reference's jax-free modules agree with it.

* `preprocess_las_tpc` writes a `.tpc` byte-identical to the
  reference's, v2 (fbatch) and v1 (tbatch), on a small LAS with a
  ragged tail batch; the C++ codec core builds from the port's source.
* `batch_translations`, `Camera`, `OrbitControls` and the host
  cull/LOD helpers of `render/camera.py` give the reference's values.
* The copied `.tpc` reader gives the reference's batches.
* The copied Potree reader (`formats/potree.py`: metadata, hierarchy,
  node points) and `.wg` reader (`tools/potree_to_wg.read_wg`) give the
  reference's values on the `.wg` fixture of `tests/test_wg.py`.
"""

import dataclasses
import os

import numpy as np
import pytest

from pcrhpg24_tpu.formats import potree as ref_potree
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.formats.native_file import read_tpc_batch as ref_read_batch
from pcrhpg24_tpu.formats.native_file import read_tpc_header as ref_read_header
from pcrhpg24_tpu.preprocess import preprocess_las_tpc as ref_preprocess
from pcrhpg24_tpu.render import camera as ref_cam
from pcrhpg24_tpu.tools import potree_to_wg as ref_wg
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import native
from pcrhpg24_tpu_torch.formats import potree as port_potree
from pcrhpg24_tpu_torch.formats.las import write_las as port_write_las
from pcrhpg24_tpu_torch.formats.native_file import (
    decode_tpc_batch_coords,
    read_tpc_batch,
    read_tpc_header,
)
from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
from pcrhpg24_tpu_torch.render import camera as port_cam
from pcrhpg24_tpu_torch.tools import potree_to_wg as port_wg
from pcrhpg24_tpu_torch.utils.synthetic import cloud_to_grid as port_grid
from pcrhpg24_tpu_torch.utils.synthetic import terrain_cloud as port_terrain


@pytest.fixture(scope="module")
def las(tmp_path_factory):
    """Two batches and 1000 points of terrain (the tail batch is padded)."""
    d = tmp_path_factory.mktemp("tcopies")
    path = str(d / "t.las")
    xyz, rgb = terrain_cloud(2 * 65536 + 1000, seed=3, extent=500.0)
    grid = cloud_to_grid(xyz)
    write_las(path, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    return path


@pytest.mark.parametrize("codec,version", [("fixed", 2), ("huffman", 1)])
def test_preprocess_tpc_byte_identical(las, tmp_path, codec, version):
    want, got = str(tmp_path / "ref.tpc"), str(tmp_path / "port.tpc")
    ref_preprocess(las, want, sort=True, verbose=False, codec=codec)
    preprocess_las_tpc(las, got, sort=True, verbose=False, codec=codec)
    assert native.available()  # the streams came from the port's C++ core
    with open(want, "rb") as f:
        want_bytes = f.read()
    with open(got, "rb") as f:
        assert f.read() == want_bytes
    h = read_tpc_header(got)
    assert h.version == version and h.num_batches == 3
    ref_h = ref_read_header(want)
    for i in (0, 2):
        mine, _c = read_tpc_batch(got, h, i)
        theirs, _c2 = ref_read_batch(want, ref_h, i)
        np.testing.assert_array_equal(mine.start_values, theirs.start_values)
    coords = decode_tpc_batch_coords(read_tpc_batch(got, h, 0)[0])
    assert coords.shape == (65536, 3)


def test_synthetic_and_las_writer_equal(tmp_path):
    xyz, rgb = port_terrain(5000, seed=11, extent=300.0)
    ref_xyz, ref_rgb = terrain_cloud(5000, seed=11, extent=300.0)
    np.testing.assert_array_equal(xyz, ref_xyz)
    np.testing.assert_array_equal(rgb, ref_rgb)
    g = port_grid(xyz)
    np.testing.assert_array_equal(g, cloud_to_grid(ref_xyz))
    a, b = tmp_path / "a.las", tmp_path / "b.las"
    port_write_las(str(a), g[:, 0], g[:, 1], g[:, 2], rgb)
    write_las(str(b), g[:, 0], g[:, 1], g[:, 2], rgb)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("yaw,pitch,radius", [(0.5, -0.9, 2500.0),
                                              (2.4, -0.25, 180.0),
                                              (-1.1, -0.08, 1400.0)])
def test_camera_host_half_equal(yaw, pitch, radius):
    target = np.array([1000.0, 1000.0, 60.0])
    mine = port_cam.OrbitControls(yaw=yaw, pitch=pitch, radius=radius, target=target)
    theirs = ref_cam.OrbitControls(yaw=yaw, pitch=pitch, radius=radius, target=target)
    np.testing.assert_array_equal(mine.world(), theirs.world())
    cm = port_cam.Camera(width=1920, height=1080, world=mine.world())
    cr = ref_cam.Camera(width=1920, height=1080, world=theirs.world())
    for f in ("view", "proj", "view_proj", "proj_params"):
        np.testing.assert_array_equal(getattr(cm, f)(), getattr(cr, f)(), err_msg=f)

    rng = np.random.default_rng(int(radius))
    anchors = rng.integers(0, 2_000_000, (64, 3))
    scale = np.array([0.001, 0.001, 0.001])
    offset = np.array([10.0, -5.0, 2.0])
    las_min = np.array([3.0, 4.0, 1.0])
    wvp = cm.proj() @ cm.view()
    np.testing.assert_array_equal(
        port_cam.batch_translations(wvp, anchors, scale, offset, las_min),
        ref_cam.batch_translations(wvp, anchors, scale, offset, las_min))

    bmin = rng.uniform(0, 2000, (256, 3))
    bmax = bmin + rng.uniform(1, 80, (256, 3))
    planes = port_cam.frustum_planes(wvp)
    np.testing.assert_array_equal(planes, ref_cam.frustum_planes(wvp))
    np.testing.assert_array_equal(port_cam.batches_in_frustum(planes, bmin, bmax),
                                  ref_cam.batches_in_frustum(planes, bmin, bmax))
    for got, want in zip(
            port_cam.lod_points_per_thread(cm.view(), cm.proj(), bmin, bmax, 1920, 1080),
            ref_cam.lod_points_per_thread(cr.view(), cr.proj(), bmin, bmax, 1920, 1080)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def wg_scene(tmp_path_factory):
    """The reference's Potree directory and `.wg` file of tests/test_wg.py."""
    d = tmp_path_factory.mktemp("tcopies_wg")
    xyz, rgb = terrain_cloud(60_000, seed=70, extent=300.0)
    pd, wg = str(d / "potree"), str(d / "cloud.wg")
    ref_potree.build_potree(pd, xyz, rgb)
    ref_wg.convert(pd, wg, precision=0.001)
    return pd, wg


def _assert_fields_equal(mine, theirs, skip=()):
    for f in dataclasses.fields(theirs):
        if f.name not in skip:
            np.testing.assert_array_equal(getattr(mine, f.name),
                                          getattr(theirs, f.name), err_msg=f.name)


def test_potree_reader_equal(wg_scene):
    pd, _wg = wg_scene
    meta, ref_meta = port_potree.read_metadata(pd), ref_potree.read_metadata(pd)
    _assert_fields_equal(meta, ref_meta)
    nodes = port_potree.parse_hierarchy(pd, meta)
    ref_nodes = ref_potree.parse_hierarchy(pd, ref_meta)
    assert len(nodes) == len(ref_nodes) > 3
    for mine, theirs in zip(nodes, ref_nodes):
        _assert_fields_equal(mine, theirs, skip=("children",))
    for i in (0, len(nodes) // 2, len(nodes) - 1):
        for a, b in zip(port_potree.read_node_points(pd, meta, nodes[i]),
                        ref_potree.read_node_points(pd, ref_meta, ref_nodes[i])):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sum(nd.num_points for nd in nodes) == 60_000


def test_read_wg_equal(wg_scene):
    _pd, wg = wg_scene
    records, words, colors = port_wg.read_wg(wg)
    ref_records, ref_words, ref_colors = ref_wg.read_wg(wg)
    assert len(records) == len(ref_records) > 3
    for mine, theirs in zip(records, ref_records):
        assert len(mine) == len(theirs) == 6
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(words, ref_words)
    np.testing.assert_array_equal(colors, ref_colors)
    assert words.dtype == colors.dtype == np.uint32
    assert os.path.getsize(wg) == 20 + 48 * len(records) + 4 * (len(words) + len(colors))
