"""Port `.wg` (nodewise-compressed) scenes vs the JAX reference, on the CPU.

* The port's copies of `build_potree` and `convert` write a Potree
  directory and a `.wg` file byte-identical to the reference's, on the
  fixture of `tests/test_wg.py`.
* `pack_bits`/`unpack_bits` round-trip and pack the reference's words.
* `ComputeLoopNodesCompressed` gives the planes and the image of the
  reference's `_render_wg` + `resolve_indexed` bit for bit (reference
  compiled at `xla_backend_optimization_level=0`, no FMA contraction),
  for a point count that is not a multiple of 1024 and one that is.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.formats.potree import build_potree as ref_build_potree
from pcrhpg24_tpu.render.methods import loop_nodes_compressed as ref
from pcrhpg24_tpu.render.methods.loop_las import resolve_indexed as ref_resolve_indexed
from pcrhpg24_tpu.tools.potree_to_wg import convert as ref_convert
from pcrhpg24_tpu.tools.potree_to_wg import pack_bits as ref_pack_bits
from pcrhpg24_tpu.utils.synthetic import terrain_cloud
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.formats.potree import build_potree
from pcrhpg24_tpu_torch.render.methods.loop_nodes_compressed import (
    ComputeLoopNodesCompressed,
    WgData,
)
from pcrhpg24_tpu_torch.tools.potree_to_wg import convert, pack_bits, unpack_bits
from pcrhpg24_tpu_torch.u32 import to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 192, 108
O0 = {"xla_backend_optimization_level": 0}
VIEWS = [Setting(yaw=0.4, pitch=-0.8, radius=500.0, target=(150, 150, 60)),
         Setting(yaw=2.4, pitch=-0.25, radius=60.0, target=(150, 150, 100))]


def _scene(d, n, port: bool):
    """terrain_cloud(n) -> Potree dir -> `.wg`, by the port or the reference."""
    xyz, rgb = terrain_cloud(n, seed=70, extent=300.0)
    pd, out = os.path.join(d, "potree"), os.path.join(d, "cloud.wg")
    (build_potree if port else ref_build_potree)(pd, xyz, rgb)
    (convert if port else ref_convert)(pd, out, precision=0.001)
    return pd, out


@pytest.fixture(scope="module", params=[60_000, 60 * 1024])
def scenes(request, tmp_path_factory):
    """(port's dir and .wg, reference's dir and .wg) at n points."""
    n = request.param
    mine = _scene(str(tmp_path_factory.mktemp("wg_port")), n, True)
    theirs = _scene(str(tmp_path_factory.mktemp("wg_ref")), n, False)
    return n, mine, theirs


def test_potree_and_wg_files_byte_identical(scenes):
    _n, (pd, wg), (ref_pd, ref_wg) = scenes
    names = sorted(os.listdir(ref_pd))
    assert names == ["hierarchy.bin", "metadata.json", "octree.bin"]
    assert sorted(os.listdir(pd)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(pd, name), os.path.join(ref_pd, name),
                           shallow=False), name
    assert filecmp.cmp(wg, ref_wg, shallow=False)


@pytest.mark.parametrize("bits", [1, 7, 13, 30])
def test_pack_unpack_roundtrip(bits):
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 1 << bits, size=(777, 3)).astype(np.uint32)
    words = pack_bits(vals, bits)
    np.testing.assert_array_equal(words, ref_pack_bits(vals, bits))
    np.testing.assert_array_equal(unpack_bits(words, bits, 777), vals)


def _reference_frame(wg_path, renderer):
    """The reference's frame on its own `.wg` resource, per op."""
    data = ref.WgData.create(wg_path)
    data.load()
    d = data.dev
    cam = renderer.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    args = (d["words"], d["colors"], d["bits"], d["base_bit"], d["bmin"],
            d["bmax"], wvp)
    fb_d, fb_p = ref._render_wg.lower(*args, width=W, height=H).compile(
        compiler_options=O0)(*args)
    img = ref_resolve_indexed(fb_p, d["colors"], W, H)
    return np.asarray(fb_d), np.asarray(fb_p), np.asarray(img)


@pytest.mark.parametrize("view", [0, 1])
def test_method_bit_exact_vs_reference(scenes, view):
    n, (_pd, wg_path), _ref = scenes
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    wg = WgData.create(wg_path, "cpu")
    assert wg.num_points == n
    m = ComputeLoopNodesCompressed(r, wg)
    img = r.loop(m.update, m.render, frames=1)
    fb_d, fb_p = r.last_fb
    want_d, want_p, want_img = _reference_frame(wg_path, r)
    np.testing.assert_array_equal(to_u32(fb_d), want_d)
    np.testing.assert_array_equal(to_u32(fb_p), want_p)
    np.testing.assert_array_equal(to_u32(img), want_img)
    assert (want_img != 0x00443322).mean() > 0.02
    assert len(np.unique(want_p)) > 1000  # many points won pixels
    # 36 B of expansion tables, ~8 B of packed words and 4 B of colour
    assert sum(d.numel() * d.element_size() for d in wg.dev.values()) < 50 * n


def test_unloaded_method_renders_background(scenes):
    _n, (_pd, wg_path), _ref = scenes
    r = Renderer(W, H, "cpu")
    m = ComputeLoopNodesCompressed(r, WgData.create(wg_path, "cpu"))
    img = m.render(r)
    assert img.shape == (H, W) and (img == 0x00443322).all()
