"""The port's live-chunk skip, mid-load frames and residency cap vs the
JAX reference, on the CPU.

Every other frame test renders a scene of one 64-batch chunk, so none
of them can tell a skip that drops a live chunk from a right one.  Here
the scene has 72 batches, two chunks (64 + 8), and three frames are
held bit for bit to the reference's `render_frame_native`
(`use_pallas=False`):

* a close-up whose frustum leaves every batch of chunk 0 at LOD 0:
  `frame_streams` returns one part, chunk 1's;
* a frame taken mid-load, after one loader task of 40 batches: chunk 0
  is half resident and chunk 1 not at all, and both packages report the
  same `num_batches_loaded`;
* a scene under `budget_batches=71`, which ends inside chunk 1: the
  device buffers are equal and `resident_limited` is set.

Each frame culls with the real camera (`frame_setup_device` on the view
and projection) and projects with the exact power-of-two transform of
`test_torch_frame.py`'s pow2 frame, so XLA's FMA contraction cannot move
a bit of the reference's image.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcrhpg24_tpu.engine.debug import Debug as RefDebug
from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu_torch.convert import dev_to_numpy
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.formats.las import write_las
from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
from pcrhpg24_tpu_torch.render.methods import huffman_tpu
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import CHUNK, HuffmanTpu
from pcrhpg24_tpu_torch.utils.synthetic import cloud_to_grid, terrain_cloud
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180
BATCHES = 72  # chunk 0: batches 0-63, chunk 1: 64-71 (the Morton tail's corner)
BACKGROUND = 0x00443322
ORBIT = Setting(yaw=0.5, pitch=-0.9, radius=2500.0, target=(450.0, 450.0, 50.0))
# a close-up of the (870, 860) corner of the 900 m scene, whose batches
# are chunk 1's: no batch of chunk 0 is inside its frustum
CORNER = Setting(yaw=0.3, pitch=-0.9, radius=25.0, target=(870.0, 860.0, 50.0))


@pytest.fixture(autouse=True)
def _low_lod():
    """LOD floor 0.1 on both packages (cheaper frames), restored after."""
    saved = Debug.lod, RefDebug.lod
    Debug.lod = RefDebug.lod = 0.1
    yield
    Debug.lod, RefDebug.lod = saved
    Runtime.clear()


@pytest.fixture(scope="module")
def tpc(tmp_path_factory):
    """A 72-batch `.tpc` v2 scene written by the port's preprocessor."""
    d = tmp_path_factory.mktemp("tchunks")
    las, out = str(d / "s.las"), str(d / "s.tpc")
    xyz, rgb = terrain_cloud(BATCHES * 65536, seed=3, extent=900.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, out, sort=True, verbose=False)
    return out


def _frames(las, ref, setting, monkeypatch):
    """One frame of the port and one of the reference, each from its own
    resource, at `setting` -> (parts, port image, reference image,
    host lod per batch)."""
    r = Renderer(W, H, "cpu")
    r.apply_setting(setting)
    r.controls_update()
    method = HuffmanTpu(r, las)
    a = method.frame_args(r)
    _wvp, lod = method.frame_setup(r)
    fp = a["frame_params"].numpy().copy()
    t = np.zeros((4, 4), np.float32)
    t[0, 0] = t[1, 1] = t[3, 2] = 2.0 ** -19
    fp[24:40] = t.reshape(-1)
    tb = np.zeros(tuple(a["tb"].shape), np.float32)
    tb[:, 3] = 2.0
    ones = np.ones(3, np.float32)

    parts = []
    streams = huffman_tpu.frame_streams

    def counted(*args, **kw):
        out = streams(*args, **kw)
        parts.append(len(out[0]))
        return out

    monkeypatch.setattr(huffman_tpu, "frame_streams", counted)
    _fb_d, _fb_p, img = huffman_tpu.render_frame_native(**{
        **a, "frame_params": torch.from_numpy(fp), "tb": torch.from_numpy(tb),
        "scale": torch.from_numpy(ones)})

    rfp = fp.copy()
    rfp[23] = float(ref.num_batches_loaded)
    _d, _p, want = ref_frame(
        ref.dev, jnp.asarray(rfp), jnp.asarray(ones), jnp.zeros(3, jnp.float32),
        width=W, height=H, mode="color", nchunks=-(-ref.num_batches // CHUNK),
        use_pallas=False, cull=a["cull"], points=a["points"], need_depth=False,
        fmt="fixed", tb=jnp.asarray(tb))
    return parts[0], img.numpy().view(np.uint32), np.asarray(want), lod


def _live(lod):
    """Whether each of the scene's two chunks has a batch in view."""
    return [bool(lod[c * CHUNK:(c + 1) * CHUNK].any()) for c in range(2)]


def test_whole_chunk_culled(tpc, monkeypatch):
    las = NativeLasData.create(tpc, "cpu").wait_loaded()
    ref = RefData.create(tpc).wait_loaded()
    assert las.num_batches == ref.num_batches == BATCHES
    parts, got, want, lod = _frames(las, ref, CORNER, monkeypatch)
    assert _live(lod) == [False, True]
    assert parts == 1
    np.testing.assert_array_equal(got, want)
    assert (want != BACKGROUND).sum() > 100


def test_mid_load_frame(tpc, monkeypatch):
    """One loader task of 40 batches on both resources: chunk 0 is still
    loading, chunk 1 is not loaded; the frame skips the same batches."""
    las = NativeLasData.create(tpc, "cpu")
    ref = RefData.create(tpc)
    for res in (las, ref):
        res.BATCHES_PER_TASK = 40
        res.load()
        while res.num_batches_loaded == 0:
            res.process(max_tasks=1)
    try:
        assert las.num_batches_loaded == ref.num_batches_loaded == 40
        parts, got, want, lod = _frames(las, ref, ORBIT, monkeypatch)
        assert (lod[:40] > 0).all() and not lod[40:].any()
        assert parts == 1
        np.testing.assert_array_equal(got, want)
        assert (want != BACKGROUND).sum() > 100
    finally:
        las.unload()
        ref.unload()


def test_budget_batches(tpc, monkeypatch):
    """`budget_batches=71` keeps batches 0-70 resident: chunk 1 holds 7
    of its 8.  The corner view's batches are 68-71, and 71 is cut."""
    las = NativeLasData.create(tpc, "cpu", budget_batches=71).wait_loaded()
    ref = RefData.create(tpc, budget_batches=71).wait_loaded()
    assert las.resident_limited and ref.resident_limited
    assert las.num_batches_loaded == ref.num_batches_loaded == 71
    got_dev = dev_to_numpy(las.dev)
    assert got_dev.keys() == ref.dev.keys() - {"colors"}  # held as `colors_k` alone
    for k, v in ref.dev.items():
        if k != "colors":
            np.testing.assert_array_equal(got_dev[k], np.asarray(v), err_msg=k)
    parts, got, want, lod = _frames(las, ref, CORNER, monkeypatch)
    assert _live(lod) == [False, True] and lod[64:71].any()
    assert parts == 1
    np.testing.assert_array_equal(got, want)
    assert (want != BACKGROUND).sum() > 100
