"""The port's host tools (ROADMAP A13) vs the JAX package's, on the CPU:
the cases of `tests/test_tools.py` (`sort_las` in every mode and
frugal, `crop_las`, `process_stats`, `utils/batch_stats`, and the
octree buildup bench of `tools/buildup_perf.py` with its C++ core),
each output equal to the reference tool's on the same input: the same
file bytes, the same report text, the same octree shape."""

import os

import numpy as np
import pytest

from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las as ref_preprocess
from pcrhpg24_tpu.preprocess import preprocess_las_tpc as ref_preprocess_tpc
from pcrhpg24_tpu.tools import buildup_perf as ref_buildup
from pcrhpg24_tpu.tools.crop_las import crop_las as ref_crop
from pcrhpg24_tpu.tools.process_stats import delta_bit_study as ref_study
from pcrhpg24_tpu.tools.sort_las import sort_las as ref_sort
from pcrhpg24_tpu.utils.batch_stats import scene_stats as ref_stats
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch.codec.morton import morton_order
from pcrhpg24_tpu_torch.formats.las import read_header, read_points
from pcrhpg24_tpu_torch.tools import buildup_perf
from pcrhpg24_tpu_torch.tools.crop_las import crop_las
from pcrhpg24_tpu_torch.tools.process_stats import delta_bit_study
from pcrhpg24_tpu_torch.tools.sort_las import sort_las
from pcrhpg24_tpu_torch.utils.batch_stats import scene_stats


@pytest.fixture(scope="module")
def las_path(tmp_path_factory):
    """`tests/test_tools.py`'s 80,000-point terrain."""
    xyz, rgb = terrain_cloud(80_000, seed=60, extent=300.0)
    grid = cloud_to_grid(xyz)
    p = tmp_path_factory.mktemp("ttools") / "t.las"
    write_las(str(p), grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    return str(p)


def _same_bytes(a: str, b: str) -> None:
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("mode,frugal", [("morton", False), ("morton", True), ("x", False),
                                         ("shuffle", False)])
def test_sort_las_writes_the_reference_bytes(las_path, tmp_path, mode, frugal):
    """Morton, x and shuffled order, and the frugal two-pass external sort."""
    port, ref = str(tmp_path / "port.las"), str(tmp_path / "ref.las")
    sort_las(las_path, port, mode, frugal=frugal)
    ref_sort(las_path, ref, mode, frugal=frugal)
    _same_bytes(port, ref)
    if mode == "morton":
        pts = read_points(port)
        assert (morton_order(pts.x, pts.y, pts.z) == np.arange(len(pts.x))).all()


def test_crop_las_writes_the_reference_bytes(las_path, tmp_path):
    port, ref = str(tmp_path / "port.las"), str(tmp_path / "ref.las")
    crop_las(las_path, port, 1000)
    ref_crop(las_path, ref, 1000)
    _same_bytes(port, ref)
    assert read_header(port).num_points == 1000


def test_process_stats_report_equals_reference(las_path):
    rep = delta_bit_study(las_path)
    assert rep == ref_study(las_path)
    assert "bit-length histogram" in rep and "mean bits/delta" in rep


@pytest.mark.parametrize("kind", ["tpc", "huffman"])
def test_batch_stats_report_equals_reference(las_path, tmp_path, kind):
    """The per-batch dump of a `.tpc` and of a `.huffman` scene."""
    path = str(tmp_path / f"s.{kind}")
    (ref_preprocess_tpc if kind == "tpc" else ref_preprocess)(las_path, path, verbose=False)
    rep = scene_stats(path)
    assert rep == ref_stats(path)
    assert "#batches: 2" in rep and "geometry compression" in rep


def test_buildup_strategies_build_the_reference_octree(tmp_path):
    """Every strategy ingests every point into the reference's octree
    shape (nodes, depth), from a library built under `build/buildup/`."""
    xyz, rgb = terrain_cloud(300_000, seed=4, extent=500.0)
    grid = cloud_to_grid(xyz)
    las = str(tmp_path / "b.las")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    hdr = read_header(las)
    pts = read_points(las, 0, hdr.num_points)
    w = np.stack([pts.x * hdr.scale[0] + hdr.offset[0], pts.y * hdr.scale[1] + hdr.offset[1],
                  pts.z * hdr.scale[2] + hdr.offset[2]], axis=1)
    bbox = np.concatenate([np.asarray(hdr.cmin), np.asarray(hdr.cmax) + 1e-9])
    so = buildup_perf.build()
    assert so.parent.parent == buildup_perf.BUILD_ROOT
    assert not os.path.exists(buildup_perf.SRC.with_name("libbuildup.so"))
    lib, ref_lib = buildup_perf.get_lib(), ref_buildup.get_lib()
    shapes = set()
    for s in range(4):
        got = buildup_perf.run_strategy(lib, w, bbox, s, 2)
        want = ref_buildup.run_strategy(ref_lib, w, bbox, s, 2)
        assert (got["nodes"], got["max_depth"]) == (want["nodes"], want["max_depth"])
        shapes.add((got["nodes"], got["max_depth"]))
    assert len(shapes) == 1
