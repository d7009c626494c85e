"""The port's sharded frames (`pcrhpg24_tpu_torch/parallel/`) vs the
single-process frames and the JAX reference, on the CPU.

* `mesh.shard_streams_host` writes the reference's rows and offsets where
  dp divides the batch count; where it does not, each shard holds its
  contiguous range of `batch_range` (ROADMAP C4: the reference raises),
  an empty range an empty row.
* One `dryrun_multichip` of 4 `gloo` ranks on the CPU renders every
  sharded path (each rank holds its image rows to the single-process
  frame it renders itself):
  - the flagship colour and HQS frames of an 8-batch BC7 `.tpc` v2 (the
    reference dryrun's 8-batch scene, seed 11) as dp=2 x sp=2 and as
    dp=3 x sp=1 (3, 3 and 2 batches; rank 3 outside the layout), and the
    colour frame of its first 3 batches as dp=4 x sp=1, where rank 3
    holds no batch and contributes an EMPTY plane; each image equals the
    port's single-process frame and the reference's single-device
    `render_frame_native` / `hqs_frame_native` (XLA O0);
  - the `.huffman`-format path on `__graft_entry__._tiny_scene`: 4
    batches as dp=2 x sp=2, equal to the reference's own sharded
    `make_multichip_render` (dp=4 x sp=2 on the 8-device CPU mesh, O0)
    and single-device `_local_raster`; 3 batches as dp=4 x sp=1, one rank
    empty, equal to `_local_raster`.
  No rank loads jax or the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from __graft_entry__ import _tiny_scene
from pcrhpg24_tpu.engine.native_resource import NativeLasData as RefData
from pcrhpg24_tpu.parallel.mesh import _local_raster, make_multichip_render
from pcrhpg24_tpu.parallel.mesh import shard_streams_host as ref_shard_streams
from pcrhpg24_tpu.render.decode_jax import decode_batches_core
from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native as ref_frame
from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import hqs_blend_native, hqs_prepass_native
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.parallel.dryrun import dryrun_multichip
from pcrhpg24_tpu_torch.parallel.mesh import shard_streams_host
from pcrhpg24_tpu_torch.parallel.mesh_native import batch_range
from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
from pcrhpg24_tpu_torch.render.methods.huffman_tpu import HuffmanTpu, render_frame_native
from pcrhpg24_tpu_torch.render.methods.huffman_tpu_hqs import hqs_frame_native
from pcrhpg24_tpu_torch.u32 import to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 160, 96  # rows divisible by sp = 2
TW, TH = 128, 128  # the `.huffman` path's frame (the reference test's 128 x 64 * sp)
LOD = 0.4
BG = 0x00443322
O0 = {"xla_backend_optimization_level": 0}
VIEW = dict(yaw=0.5, pitch=-0.9, radius=1500.0, target=(450.0, 450.0, 50.0))
TINY = dict(transform=np.eye(4, dtype=np.float32), scale=np.full(3, 0.01, np.float32),
            offset_rel=np.zeros(3, np.float32))
TINY["transform"][3] = (0.0, 0.0, 1e-3, 1.0)


def _scene_np(batches: int, seed: int = 3) -> dict:
    return {k: np.asarray(v) for k, v in _tiny_scene(batches, seed=seed).items()}


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_streams_equal_reference_where_dp_divides(dp):
    scene = _scene_np(4)
    want = ref_shard_streams(scene, dp)
    got = shard_streams_host(scene, dp)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype, k


@pytest.mark.parametrize("batches,dp", [(3, 2), (3, 4), (5, 3)])
def test_shard_streams_remainder(batches, dp):
    """C4: the reference raises; the port's shards are contiguous and
    uneven, each row its batches' words, an empty range a zero row."""
    scene = _scene_np(batches)
    with pytest.raises(ValueError):
        ref_shard_streams(scene, dp)
    got = shard_streams_host(scene, dp)
    enc, eo = scene["encoding"], scene["enc_offsets"].astype(np.int64)
    ends = np.append(eo[1:], len(enc))
    sizes = [batch_range(batches, dp, s) for s in range(dp)]
    assert [b - a for a, b in sizes] == [batches // dp + (s < batches % dp) for s in range(dp)]
    for s, (a, b) in enumerate(sizes):
        for i in range(a, b):  # each batch's words at its rebased offset in its row
            o = got["enc_offsets"][i]
            np.testing.assert_array_equal(got["encoding"][s, o:o + ends[i] - eo[i]],
                                          enc[eo[i]:ends[i]])
        used = (ends[b - 1] - eo[a]) if b > a else 0
        assert not got["encoding"][s, used:].any()
    assert got["encoding"].shape[1] == max(
        max(1, int(ends[b - 1] - eo[a])) if b > a else 1 for a, b in sizes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenes, and one dryrun of 4 gloo ranks over every task."""
    d = tmp_path_factory.mktemp("tmultichip")
    xyz, rgb = terrain_cloud(8 * 65536, seed=11, extent=900.0)
    grid = cloud_to_grid(xyz)
    las, tpc = str(d / "s.las"), str(d / "s_bc7.tpc")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False, color_fmt="bc7")
    tiny = {}
    for b in (4, 3):
        tiny[b] = dict(_scene_np(b), lod_n=np.full(b, 64, np.int32), **TINY)
        np.savez(d / f"tiny{b}.npz", **tiny[b])
    common = dict(kind="tpc", scene=tpc, width=W, height=H, lod=LOD, views={"orbit": VIEW})
    tasks = [
        dict(common, name="bc7 2x2", dp=2, sp=2, modes=["color", "hqs"]),
        dict(common, name="bc7 3x1", dp=3, sp=1, modes=["color", "hqs"]),
        dict(common, name="bc7 4x1 of 3", dp=4, sp=1, budget=3, modes=["color"]),
        dict(kind="huffman", name="tiny 2x2", scene=str(d / "tiny4.npz"), dp=2, sp=2,
             width=TW, height=TH),
        dict(kind="huffman", name="tiny 4x1 of 3", scene=str(d / "tiny3.npz"), dp=4, sp=1,
             width=TW, height=TH),
    ]
    res = dryrun_multichip(4, tasks, "gloo", "cpu", workdir=str(d), reps=0)
    return dict(tpc=tpc, tiny=tiny, res=res)


def test_no_rank_loads_jax(runs):
    assert runs["res"]["foreign_modules"] == []


_REF = {}


def _reference(runs, budget, mode):
    """The reference's single-device image on the port's frame arguments (O0)."""
    key = (budget, mode)
    if key not in _REF:
        Debug.lod, lod = LOD, Debug.lod
        r = Renderer(W, H, "cpu")
        r.apply_setting(Setting(**VIEW))
        r.controls_update()
        las = NativeLasData.create(runs["tpc"], "cpu", budget_batches=budget).wait_loaded()
        args = HuffmanTpu(r, las).frame_args(r)
        Debug.lod = lod
        port = (render_frame_native if mode == "color" else hqs_frame_native)(**args)[2]
        ref = RefData.create(runs["tpc"], budget_batches=budget).wait_loaded()
        dyn = dict(dev=ref.dev, frame_params=jnp.asarray(args["frame_params"].numpy()),
                   scale=jnp.asarray(args["scale"].numpy()),
                   offset_rel=jnp.zeros(3, jnp.float32), tb=jnp.asarray(args["tb"].numpy()))
        static = dict(width=W, height=H, nchunks=args["nchunks"], use_pallas=False,
                      cull=args["cull"], points=args["points"], fmt="fixed",
                      color_fmt="bc7")
        if mode == "color":
            img = ref_frame.lower(**dyn, **static, mode="color", need_depth=False).compile(
                compiler_options=O0)(**dyn)[2]
        else:
            fbd, _s = hqs_prepass_native.lower(**dyn, **static).compile(
                compiler_options=O0)(**dyn)
            hdyn = dict(dyn, fb_depth=fbd, streams=None)
            img = hqs_blend_native.lower(**hdyn, **static).compile(
                compiler_options=O0)(**hdyn)[1]
        _REF[key] = (to_u32(port), np.asarray(img))
    return _REF[key]


@pytest.mark.parametrize("task,frame,budget", [
    ("bc7 2x2", "orbit/color", None), ("bc7 2x2", "orbit/hqs", None),
    ("bc7 3x1", "orbit/color", None), ("bc7 3x1", "orbit/hqs", None),
    ("bc7 4x1 of 3", "orbit/color", 3)])
def test_flagship_sharded_equals_single_and_reference(runs, task, frame, budget):
    run = runs["res"][task]
    img = run["images"][frame].view(np.uint32)
    port, ref = _reference(runs, budget, frame.split("/")[1])
    np.testing.assert_array_equal(img, port)
    np.testing.assert_array_equal(img, ref)
    assert (img != BG).sum() > 500
    active = [r for r in run["ranks"] if r["active"]]
    spans = sorted((r["start"], r["stop"]) for r in active if r["sp_idx"] == 0)
    if task == "bc7 3x1":  # dp = 3 does not divide 8 batches
        assert spans == [(0, 3), (3, 6), (6, 8)]
        assert not run["ranks"][3]["active"]
    if task == "bc7 4x1 of 3":  # rank 3 holds no batch: an EMPTY plane
        assert spans == [(0, 1), (1, 2), (2, 3), (3, 3)]


def _tiny_reference(tiny: dict):
    """The reference's single-device `_local_raster` image (O0)."""
    args = [jnp.asarray(tiny[k]) for k in ("encoding", "enc_offsets", "cluster_sizes",
                                           "separate", "sep_offsets", "separate_sizes",
                                           "table_values", "table_cw_len", "start_values")]
    coords = decode_batches_core(*args)
    fn = jax.jit(functools.partial(_local_raster, width=TW, height=TH))
    dyn = (coords, jnp.asarray(tiny["scale"]), jnp.asarray(tiny["offset_rel"]),
           jnp.asarray(tiny["lod_n"]), jnp.asarray(tiny["transform"]))
    _fb_d, fb_p = fn.lower(*dyn).compile(compiler_options=O0)(*dyn)
    fb_p = np.asarray(fb_p)
    return np.where(fb_p != 0xFFFFFFFF, fb_p, BG).reshape(TH, TW)


def test_huffman_sharded_equals_reference_mesh(runs):
    """dp=2 x sp=2 of the port against the reference's dp=4 x sp=2 on its
    virtual 8-device mesh: the winners do not depend on the layout."""
    tiny = runs["tiny"][4]
    img = runs["res"]["tiny 2x2"]["images"]["frame"].view(np.uint32)
    mesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("dp", "sp"))
    sh = {k: jnp.asarray(v) for k, v in ref_shard_streams(tiny, 4).items()}
    args = (sh["encoding"], sh["enc_offsets"], sh["cluster_sizes"], sh["separate"],
            sh["sep_offsets"], sh["separate_sizes"], sh["table_values"],
            sh["table_cw_len"], sh["start_values"], jnp.asarray(tiny["lod_n"]),
            jnp.asarray(tiny["transform"]), jnp.asarray(tiny["scale"]),
            jnp.asarray(tiny["offset_rel"]))
    render = jax.jit(make_multichip_render(mesh, TW, TH))
    want = np.asarray(render.lower(*args).compile(compiler_options=O0)(*args))
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(img, _tiny_reference(tiny))
    assert (img != BG).sum() >= 10
    assert len(set(np.unique(img).tolist()) - {BG}) >= 2  # batches of both dp shards win


def test_huffman_remainder_shards_equal_reference(runs):
    """dp=4 over 3 batches: rank 3 has no batch and no words."""
    run = runs["res"]["tiny 4x1 of 3"]
    img = run["images"]["frame"].view(np.uint32)
    np.testing.assert_array_equal(img, _tiny_reference(runs["tiny"][3]))
    r3 = run["ranks"][3]
    assert (r3["start"], r3["stop"]) == (3, 3) and r3["frames"]["frame"]["shown"] > 0
