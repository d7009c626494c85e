"""The `.las` scenes of the PyTorch port vs the JAX reference, on the CPU:
the three resources, the 10-10-10 packing and projection, and the nine
methods the reference app registers for a `.las` (`loop_las`,
`loop_las2`, `loop_las_hqs`, `basic`, the four 2021 variants and
`2021 hqs`).

The scene is `tests/test_methods_family.py`'s 120k-point terrain (two
batches, the second padded), its points sorted by x as a lidar tile's
scan order keeps them, so that each batch covers a strip: the close
view culls one and gives the two different precision levels.  The reference's chunk functions are
compiled at `xla_backend_optimization_level=0` (XLA-CPU otherwise
contracts `Xs * (box / denom) + bmin`, the `t * p` sums and `ndc * 0.5 +
0.5` into FMAs) and run over the loaded prefix; the port projects the
loaded batches only, so a mid-load frame is also held against the
reference method's own frame over its full padded 256-batch chunk.
Every comparison is bit for bit: planes, HQS sums, images, streams.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.engine import las_resources as ref_res
from pcrhpg24_tpu.engine.debug import Debug as RefDebug
from pcrhpg24_tpu.engine.renderer import Renderer as RefRenderer
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.render import camera as ref_cam
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods import basic as ref_basic
from pcrhpg24_tpu.render.methods import compute_2021 as ref_2021
from pcrhpg24_tpu.render.methods import loop_las as ref_loop
from pcrhpg24_tpu.render.methods.huffman_hqs import resolve_hqs as ref_resolve_hqs
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.engine import las_resources as res
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.render.hqs import hqs_sums
from pcrhpg24_tpu_torch.render.methods import basic, compute_2021, loop_las
from pcrhpg24_tpu_torch.render.raster import u64_min_planes
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 256, 144
P = 65536
O0 = {"xla_backend_optimization_level": 0}
EMPTY32 = 0xFFFFFFFF
BG = 0x00443322
VIEWS = {  # levels (3, 3), (1, culled), (4, 4)
    "orbit": Setting(yaw=0.3, pitch=-0.8, radius=600.0, target=(300.0, 300.0, 100.0)),
    "close": Setting(yaw=2.4, pitch=-0.3, radius=60.0, target=(100.0, 300.0, 100.0)),
    "far": Setting(yaw=-1.1, pitch=-0.5, radius=4000.0, target=(300.0, 300.0, 40.0)),
}
# method name -> (port class, resource key, reference frame kind, hqs)
METHODS = {
    "loop_las": (loop_las.ComputeLoopLas, "d1010", "101010", False),
    "loop_las2": (loop_las.ComputeLoopLas2, "d1010", "101010", False),
    "loop_las_hqs": (loop_las.ComputeLoopLasHqs, "d1010", "101010", True),
    "basic": (basic.BasicMethod, "basic", "basic", False),
    **{name: (functools.partial(compute_2021.Compute2021, name=name), "std", "f32", False)
       for name in compute_2021.Compute2021.VARIANTS},
    "2021 hqs": (compute_2021.Compute2021Hqs, "std", "f32", True),
}
RESOURCES = {"d1010": "ComputeLasData", "basic": "ComputeLasDataBasic",
             "std": "LasStandardData"}


@pytest.fixture(autouse=True)
def _restore_globals():
    yield
    Debug.frustum_culling_enabled = RefDebug.frustum_culling_enabled = True
    Debug.edl = False
    Runtime.clear()


@functools.lru_cache(maxsize=1)
def _path(root: str) -> str:
    xyz, rgb = terrain_cloud(120_000, seed=33, extent=600.0)
    order = np.argsort(xyz[:, 0], kind="stable")
    grid = cloud_to_grid(xyz[order])
    rgb = rgb[order]
    p = f"{root}/f.las"
    write_las(p, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    return p


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The `.las` path, the port's and the reference's loaded resources
    of each kind."""
    path = _path(str(tmp_path_factory.mktemp("tlas")))
    port = {k: getattr(res, c).create(path, "cpu").wait_loaded() for k, c in RESOURCES.items()}
    ref = {k: getattr(ref_res, c).create(path).wait_loaded() for k, c in RESOURCES.items()}
    yield SimpleNamespace(path=path, port=port, ref=ref)
    for d in (*port.values(), *ref.values()):
        d.unload()


def _camera(view: str) -> Renderer:
    r = Renderer(W, H, "cpu")
    r.apply_setting(VIEWS[view])
    r.controls_update()
    return r


_COMPILED = {}


def _o0(fn, **kw):
    """`fn` (a jitted reference function) compiled at O0 for these
    argument shapes and static width/height, then called."""
    dyn = {k: v for k, v in kw.items() if k not in ("width", "height")}
    key = (fn, tuple((k, getattr(v, "shape", None)) for k, v in dyn.items()))
    if key not in _COMPILED:
        _COMPILED[key] = fn.lower(**dyn, width=W, height=H).compile(compiler_options=O0)
    return _COMPILED[key](**dyn)


def _empty():
    return jnp.full((W * H,), EMPTY32, jnp.uint32)


def _ref_frame(ref, kind: str, hqs: bool, cam, cull: bool = True):
    """The reference method's frame from its chunk functions at O0 over
    the loaded prefix -> (fb_d, fb_p or the 4 HQS sums, image) as numpy."""
    n = ref.num_points_loaded
    d = ref.dev
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    if kind == "101010":
        B = ref.num_batches_loaded
        view, proj = cam.view(), cam.proj()
        bmin, bmax = ref.bbox_min[:B], ref.bbox_max[:B]
        vis = (ref_cam.batches_in_frustum(ref_cam.frustum_planes(proj @ view), bmin, bmax)
               if cull else np.ones(B, bool))
        level = ref_loop.precision_levels(view, proj, bmin, bmax, W, H)
        geo = dict(xyz4=d["xyz4"][:n], xyz8=d["xyz8"][:n], xyz12=d["xyz12"][:n],
                   level_pt=jnp.asarray(np.repeat(level, P)),
                   bmin_pt=jnp.asarray(np.repeat(bmin, P, axis=0)),
                   bmax_pt=jnp.asarray(np.repeat(bmax, P, axis=0)))
        vis_pt = jnp.asarray(np.repeat(vis, P))
        fb_d, fb_p = _o0(ref_loop.raster_chunk_101010, **geo, transform=wvp,
                         base_index=jnp.uint32(0), fb_d=_empty(), fb_p=_empty(), mask_pt=vis_pt)
        if hqs:
            acc = _o0(ref_loop.hqs_chunk_101010, **geo, rgba=d["rgba"][:n], transform=wvp,
                      **{k: jnp.zeros(W * H, jnp.uint32) for k in ("acc_r", "acc_g", "acc_b",
                                                                    "acc_n")},
                      fb_depth=fb_d, mask_pt=vis_pt)
    elif kind == "basic":
        fb_d, fb_p = _o0(ref_basic.raster_chunk_basic, x=d["x"][:n], y=d["y"][:n],
                         z=d["z"][:n], scale=jnp.asarray(ref.scale, jnp.float32),
                         offset_rel=jnp.asarray(ref.offset - ref.las_min, jnp.float32),
                         transform=wvp, base_index=jnp.uint32(0), fb_d=_empty(),
                         fb_p=_empty(), n_valid=jnp.uint32(n))
    else:
        pos = dict(fx=d["fx"][:n], fy=d["fy"][:n], fz=d["fz"][:n])
        fb_d, fb_p = _o0(ref_2021.raster_chunk_f32, **pos, transform=wvp,
                         base_index=jnp.uint32(0), fb_d=_empty(), fb_p=_empty(),
                         n_valid=jnp.uint32(n))
        if hqs:
            acc = _o0(ref_2021.hqs_chunk_f32, **pos, rgba=d["rgba"][:n], transform=wvp,
                      fb_depth=fb_d, **{k: jnp.zeros(W * H, jnp.uint32)
                                        for k in ("acc_r", "acc_g", "acc_b", "acc_n")},
                      n_valid=jnp.uint32(n), base_index=jnp.uint32(0))
    if hqs:
        img = ref_resolve_hqs(*acc, W, H)
        return np.asarray(fb_d), [np.asarray(a) for a in acc], np.asarray(img)
    img = ref_loop.resolve_indexed(fb_p, d["rgba"], W, H)
    return np.asarray(fb_d), np.asarray(fb_p), np.asarray(img)


def _render(scene, name: str, view: str):
    """The port's method `name` renders one frame -> (renderer, method)."""
    cls, key, _kind, _hqs = METHODS[name]
    r = _camera(view)
    m = cls(r, scene.port[key])
    Runtime.resource = m.las  # loaded by the fixture: no switch
    r.last_image = m.render(r)
    return r, m


# -- resources ----------------------------------------------------------


@pytest.mark.parametrize("key", sorted(RESOURCES))
def test_resource_buffers_equal_reference(scene, key):
    """Device buffers, boxes and counters after one 1-batch `process()`
    step (the second batch still zero) and after `wait_loaded`."""
    port = getattr(res, RESOURCES[key]).create(scene.path, "cpu")
    ref = getattr(ref_res, RESOURCES[key]).create(scene.path)
    for step in ("one batch", "loaded"):
        for d in (port, ref):
            if step == "one batch":
                d.load()
                d.process(chunk_points=P)
            else:
                d.wait_loaded()
        assert set(port.dev) == set(ref.dev)
        for k, v in ref.dev.items():
            got = port.dev[k].numpy()
            np.testing.assert_array_equal(got.view(np.asarray(v).dtype), np.asarray(v),
                                          err_msg=f"{step} {k}")
        for a in ("num_points_loaded", "num_batches_loaded", "num_points", "num_batches"):
            assert getattr(port, a) == getattr(ref, a), (step, a)
        np.testing.assert_array_equal(port.bbox_min, ref.bbox_min)
        np.testing.assert_array_equal(port.bbox_max, ref.bbox_max)
        assert port.state.name == ref.state.name
    assert port.num_batches_loaded == 2 and (port.bbox_max[1] > port.bbox_min[1]).all()
    port.unload()
    ref.unload()


def test_pack_101010_equals_reference():
    """Points inside their batch box and on both corners of it, a flat
    box axis and a tiny box; per-point and per-batch boxes.  (The
    reference's colour plane passes through; the port's returns the
    three position planes.)"""
    rng = np.random.default_rng(5)
    nb, n = 6, 4096
    lo = rng.uniform(-500, 500, (nb, 1, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 300, (nb, 1, 3))).astype(np.float32)
    hi[1, :, 2] = lo[1, :, 2]  # a flat batch
    hi[2] = lo[2] + np.float32(1e-3)
    pos = (lo + rng.uniform(0, 1, (nb, n, 3)) * (hi - lo)).astype(np.float32)
    pos[:, 0] = lo[:, 0]
    pos[:, 1] = hi[:, 0]
    rgba = rng.integers(0, 2**32, nb * n, dtype=np.uint64).astype(np.uint32)
    want = ref_res.pack_101010(
        jnp.asarray(pos.reshape(-1, 3)), jnp.asarray(rgba),
        jnp.asarray(np.broadcast_to(lo, pos.shape).reshape(-1, 3)),
        jnp.asarray(np.broadcast_to(hi, pos.shape).reshape(-1, 3)))
    t = torch.from_numpy
    for shape in ((nb, n), (nb * n,)):  # per-batch boxes, per-point boxes
        wl = t(lo) if len(shape) == 2 else t(np.broadcast_to(lo, pos.shape).reshape(-1, 3))
        wh = t(hi) if len(shape) == 2 else t(np.broadcast_to(hi, pos.shape).reshape(-1, 3))
        got = res.pack_101010(t(pos).reshape(*shape, 3), wl, wh)
        assert len(got) == 3
        np.testing.assert_array_equal(np.asarray(want[3]), rgba)  # the colour passes through
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_u32(g).reshape(-1), np.asarray(w))
    assert (np.asarray(want[0]) == 1023 * (1 + 1024 + 1024**2)).any()  # the top clamp


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_precision_levels_equal_reference(scene, view):
    d = scene.port["d1010"]
    cam = _camera(view).camera
    B = d.num_batches_loaded
    for args in ((d.bbox_min[:B], d.bbox_max[:B]),
                 (np.array([[0, 0, 0], [0, 0, 0], [10, 10, 1]], np.float32),
                  np.array([[5000, 5000, 9], [1, 1, 1], [10, 10, 1]], np.float32))):
        np.testing.assert_array_equal(
            loop_las.precision_levels(cam.view(), cam.proj(), *args, W, H),
            ref_loop.precision_levels(cam.view(), cam.proj(), *args, W, H))


# -- streams -----------------------------------------------------------------


LEVELS = {"0": [0] * 4, "1": [1] * 4, "2": [2] * 4, "3": [3] * 4, "4": [4] * 4,
          "mixed": [4, 0, 2, 1]}


@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("entry", ["project_101010", "loop_las_parts"])
def test_project_101010_streams_equal_reference(scene, monkeypatch, entry, levels):
    """`_project_101010` at O0 on four batches (two loaded, two zero) at
    each level and a per-batch mix, with the last batch masked off:
    `project_101010` on per-batch planes from point 5 * 65536, and
    `loop_las_parts`' CPU path on the per-batch tables of `frame_args`
    (int32 visibility) from point 0, in parts of three batches and one.
    Where `loop_las_parts` drops a point, only its pid and index are held:
    the kernel's contract leaves a dropped entry's depth unread."""
    d, ref = scene.port["d1010"], scene.ref["d1010"]
    cam = _camera("close").camera
    wvp = (cam.proj() @ cam.view()).astype(np.float32)
    nb = 4
    lvl = np.array(LEVELS[levels], np.int32)
    vis = np.array([True, True, True, False])
    rng = np.random.default_rng(3)
    bmin = np.concatenate([d.bbox_min[:2], rng.uniform(0, 100, (2, 3))]).astype(np.float32)
    bmax = (bmin + np.concatenate([d.bbox_max[:2] - d.bbox_min[:2],
                                   rng.uniform(0, 50, (2, 3))])).astype(np.float32)
    t = torch.from_numpy
    if entry == "project_101010":
        base = 5 * P
        planes = [d.dev[k][:nb * P].view(nb, P) for k in ("xyz4", "xyz8", "xyz12")]
        got = loop_las.project_101010(
            *planes, t(lvl)[:, None], tuple(t(bmin[:, k:k + 1]) for k in range(3)),
            tuple(t(bmax[:, k:k + 1]) for k in range(3)), t(wvp), base, W, H,
            t(vis)[:, None])
    else:
        base = 0
        monkeypatch.setattr(loop_las, "CHUNK_PTS", 3 * P)
        parts = loop_las.loop_las_parts(
            {k: d.dev[k][:nb * P] for k in ("xyz4", "xyz8", "xyz12")}, t(lvl),
            t(vis.astype(np.int32)), t(bmin), t(bmax), t(wvp), nb, W, H)
        assert [tuple(p[0].shape) for p in parts] == [(3, P), (1, P)]
        got = [torch.cat([p[k] for p in parts]) for k in range(3)]
    fn = jax.jit(ref_loop._project_101010, static_argnames=("width", "height"))
    want = _o0(fn, xyz4=ref.dev["xyz4"][:nb * P], xyz8=ref.dev["xyz8"][:nb * P],
               xyz12=ref.dev["xyz12"][:nb * P], level_pt=jnp.asarray(np.repeat(lvl, P)),
               bmin_pt=jnp.asarray(np.repeat(bmin, P, axis=0)),
               bmax_pt=jnp.asarray(np.repeat(bmax, P, axis=0)), transform=jnp.asarray(wvp),
               base_index=jnp.uint32(base), mask_pt=jnp.asarray(np.repeat(vis, P)))
    pid, dep, idx = (to_u32(g).reshape(-1) for g in got)
    wpid, wdep, widx = (np.asarray(w).astype(np.uint32) for w in want)
    np.testing.assert_array_equal(pid, wpid)
    np.testing.assert_array_equal(idx, widx)
    live = wpid < W * H
    np.testing.assert_array_equal(dep[live] if entry == "loop_las_parts" else dep,
                                  wdep[live] if entry == "loop_las_parts" else wdep)
    assert live.sum() > 1000 and (wpid[3 * P:] == W * H).all()


def test_loop_las_parts_layout_across_parts(scene, monkeypatch):
    """At three batches in parts of two, the card path's parts (views of
    one whole-frame projection, `chunk_parts`) equal the plain path's
    per-chunk parts entry for entry: the same shapes, each part k holding
    the points from k * CHUNK_PTS, so `colour_parts` slices `rgba` at the
    same points and `resolve_parts` gives the same planes and image."""
    monkeypatch.setattr(loop_las, "CHUNK_PTS", 2 * P)
    d = scene.port["d1010"]
    nb = 3
    cam = _camera("orbit").camera
    wvp = torch.from_numpy((cam.proj() @ cam.view()).astype(np.float32))
    level = torch.tensor([0, 4, 2], dtype=torch.int32)
    vis = torch.tensor([1, 0, 1], dtype=torch.int32)
    bmin = torch.from_numpy(np.concatenate([d.bbox_min[:2], d.bbox_min[:1]]))
    bmax = torch.from_numpy(np.concatenate([d.bbox_max[:2], d.bbox_max[:1]]))
    dev = {k: d.dev[k][:nb * P] for k in ("xyz4", "xyz8", "xyz12", "rgba")}
    want = loop_las.loop_las_parts(dev, level, vis, bmin, bmax, wvp, nb, W, H)
    planes = [dev[k].view(nb, P) for k in ("xyz4", "xyz8", "xyz12")]
    whole = loop_las.project_101010(*planes, level[:, None],
                                    tuple(bmin[:, k:k + 1] for k in range(3)),
                                    tuple(bmax[:, k:k + 1] for k in range(3)), wvp, 0, W, H,
                                    vis[:, None] != 0)
    got = loop_las.chunk_parts(whole, nb)
    assert [tuple(p[0].shape) for p in got] == [(2, P), (1, P)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and a.is_contiguous() and torch.equal(a, b)
    for g, w in zip(loop_las.colour_parts(got, dev["rgba"]),
                    loop_las.colour_parts(want, dev["rgba"])):
        assert torch.equal(g[2], w[2])
    assert (to_u32(got[1][0]) < W * H).sum() > 1000  # the second part's batch lands
    for hqs in (False, True):
        for g, w in zip(loop_las.resolve_parts(got, dev["rgba"], W, H, hqs),
                        loop_las.resolve_parts(want, dev["rgba"], W, H, hqs)):
            assert torch.equal(g, w)


def _streams_of(monkeypatch, module, fn_name, **kw):
    """The (pid, depth, payload) stream a reference chunk function hands
    its resolve, from a fresh jit of it at O0."""
    monkeypatch.setattr(module, "sorted_scatter_u64_min",
                        lambda pid, depth, payload, size, fb_d, fb_p: (pid, (depth, payload)))
    inner = getattr(module, fn_name).__wrapped__

    def chunk(**a):
        return inner(**a)

    # jax caches a trace by its Python function: a jit of `inner` itself
    # would share the module's jitted function's traces, and leave this
    # patched trace behind for later callers of it at these shapes
    fn = jax.jit(chunk, static_argnames=("width", "height"))
    pid, (dep, pay) = _o0(fn, **kw)
    return [np.asarray(x).astype(np.uint32) for x in (pid, dep, pay)]


@pytest.mark.parametrize("kind", ["basic", "f32"])
def test_chunk_streams_equal_reference(scene, monkeypatch, kind):
    """`basic`'s and the 2021 projection's streams of a 65,536-point
    slice starting at point 1000, its last 2,000 points past `n_valid`."""
    cam = _camera("orbit").camera
    wvp = (cam.proj() @ cam.view()).astype(np.float32)
    s, n = 1000, P
    nv = s + n - 2000
    if kind == "basic":
        d, ref = scene.port["basic"], scene.ref["basic"]
        got = basic.raster_chunk_basic(
            *(d.dev[k][s:s + n] for k in "xyz"), torch.tensor(d.scale, dtype=torch.float32),
            torch.tensor(d.offset - d.las_min, dtype=torch.float32), torch.from_numpy(wvp),
            s, W, H, nv)
        want = _streams_of(
            monkeypatch, ref_basic, "raster_chunk_basic",
            **{k: ref.dev[k][s:s + n] for k in "xyz"}, scale=jnp.asarray(ref.scale, jnp.float32),
            offset_rel=jnp.asarray(ref.offset - ref.las_min, jnp.float32),
            transform=jnp.asarray(wvp), base_index=jnp.uint32(s), fb_d=_empty(), fb_p=_empty(),
            n_valid=jnp.uint32(nv))
    else:
        d, ref = scene.port["std"], scene.ref["std"]
        got = compute_2021.raster_chunk_f32(*(d.dev[k][s:s + n] for k in ("fx", "fy", "fz")),
                                            torch.from_numpy(wvp), s, W, H, nv)
        want = _streams_of(monkeypatch, ref_2021, "raster_chunk_f32",
                           **{k: ref.dev[k][s:s + n] for k in ("fx", "fy", "fz")},
                           transform=jnp.asarray(wvp), base_index=jnp.uint32(s),
                           fb_d=_empty(), fb_p=_empty(), n_valid=jnp.uint32(nv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), w)
    assert (want[0][-2000:] == W * H).all() and (want[0] < W * H).sum() > 1000


# -- frames ------------------------------------------------------------------


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("name", list(METHODS))
def test_method_frame_equals_reference(scene, name, view):
    """Each of the nine methods: the planes left in `last_fb`, the image
    and, for HQS, the (r, g, b, n) sums, against the reference's frame."""
    _cls, key, kind, hqs = METHODS[name]
    r, m = _render(scene, name, view)
    fb_d, fb_x, img = _ref_frame(scene.ref[key], kind, hqs, r.camera)
    np.testing.assert_array_equal(to_u32(r.last_fb[0]), fb_d)
    np.testing.assert_array_equal(to_u32(r.last_image), img)
    if hqs:
        args = {k: v for k, v in m.frame_args(r).items() if k != "hqs"}
        parts = (loop_las.loop_las_parts if kind == "101010"
                 else compute_2021.compute2021_parts)(**args)
        sums = hqs_sums(loop_las.colour_parts(parts, args["dev"]["rgba"]), r.last_fb[0], W * H)
        for g, w in zip(sums, fb_x):
            np.testing.assert_array_equal(to_u32(g), w)
        np.testing.assert_array_equal(to_u32(r.last_fb[1]), fb_x[3])
    else:
        np.testing.assert_array_equal(to_u32(r.last_fb[1]), fb_x)
    assert (img != BG).sum() > 150


def test_frame_without_culling_equals_reference(scene):
    """`Debug.frustum_culling_enabled = False` (`--no-frustum-culling`)
    on `loop_las` at a view that culls a batch: the reference's frame
    without culling, and the same image as with it (the cull only drops
    batches wholly off screen)."""
    cam = _camera("close").camera
    d = scene.port["d1010"]
    B = d.num_batches_loaded
    vis = ref_cam.batches_in_frustum(ref_cam.frustum_planes(cam.proj() @ cam.view()),
                                     d.bbox_min[:B], d.bbox_max[:B])
    assert not vis.all()
    Debug.frustum_culling_enabled = False
    r, m = _render(scene, "loop_las", "close")
    assert bool(m.frame_args(r)["vis"].all())
    fb_d, fb_p, img = _ref_frame(scene.ref["d1010"], "101010", False, r.camera, cull=False)
    np.testing.assert_array_equal(to_u32(r.last_fb[0]), fb_d)
    np.testing.assert_array_equal(to_u32(r.last_fb[1]), fb_p)
    np.testing.assert_array_equal(to_u32(r.last_image), img)
    culled = _ref_frame(scene.ref["d1010"], "101010", False, r.camera)[2]
    np.testing.assert_array_equal(img, culled)


def _per_op(fn):
    """A reference chunk function, compiled at O0 on each call's shapes."""

    def call(*args, **kw):
        names = fn.__wrapped__.__code__.co_varnames
        return _o0(fn, **dict(zip(names, args)), **kw)  # width, height: W, H
    return call


def test_mid_load_frame_equals_reference_full_chunk(scene, monkeypatch):
    """With one of the two batches loaded, the port's `loop_las`
    projects that batch; the reference method's own `render` projects
    its whole padded 256-batch chunk (16.8M points, the rest masked:
    visibility False), its chunk function at O0.  Same planes and image.
    (The one full-chunk frame: ~3.5 GB and ~12 s on the CPU.)"""
    monkeypatch.setattr(ref_loop, "raster_chunk_101010",
                        _per_op(ref_loop.raster_chunk_101010))
    port = res.ComputeLasData.create(scene.path, "cpu")
    ref = ref_res.ComputeLasData.create(scene.path)
    for d in (port, ref):
        d.load()
        d.process(chunk_points=P)
        d.process = lambda renderer=None: None  # no more loading in the frame
    assert port.num_batches_loaded == ref.num_batches_loaded == 1
    rr = RefRenderer(W, H)
    rr.apply_setting(VIEWS["orbit"])
    rr.controls_update()
    want = np.asarray(ref_loop.ComputeLoopLas(rr, ref).render(rr))
    r = _camera("orbit")
    m = loop_las.ComputeLoopLas(r, port)
    Runtime.resource = port
    got = m.render(r)
    np.testing.assert_array_equal(to_u32(got), want)
    for g, w in zip(r.last_fb, rr.last_fb):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (want != BG).sum() > 100
    port.unload()
    ref.unload()


def test_app_depth_and_edl_on_loop_las(scene, tmp_path):
    """`--depth` and `--edl` through `app.run` on `loop_las`: the depth
    file is the reference renderer's of the reference's plane, the image
    the reference's EDL (at O0) of its frame."""
    s = VIEWS["orbit"]
    depth = tmp_path / "port.npy"
    rr = app.run(["--scene", scene.path, "--method", "loop_las", "--device", "cpu",
                  "--width", str(W), "--height", str(H), "--yaw", str(s.yaw),
                  "--pitch", str(s.pitch), "--radius", str(s.radius),
                  "--target", *map(str, s.target), "--edl", "--depth", str(depth)])
    fb_d, _fb_p, img = _ref_frame(scene.ref["d1010"], "101010", False, rr.camera)
    a = (jnp.asarray(img), jnp.asarray(fb_d))
    want = ref_raster.edl_shade.lower(*a, width=W, height=H).compile(compiler_options=O0)(*a)
    np.testing.assert_array_equal(to_u32(rr.last_image), np.asarray(want))
    assert (np.asarray(want) != img).sum() > 100  # EDL shaded something
    ref_r = RefRenderer(W, H)
    ref_r.last_fb = (jnp.asarray(fb_d), None)
    ref_r.save_depth_exr(str(tmp_path / "ref.npy"))
    assert depth.read_bytes() == (tmp_path / "ref.npy").read_bytes()
    Runtime.selected.las.unload()


def test_list_methods_in_reference_order(scene, capsys):
    """`--list-methods` on a `.las` lists the reference app's nine
    methods, in its order (`app.py:90-99`)."""
    app.run(["--scene", scene.path, "--list-methods", "--device", "cpu"])
    names = [m.name for m in Runtime.methods]
    assert names == ["loop_las", "loop_las2", "loop_las_hqs", "basic",
                     *compute_2021.Compute2021.VARIANTS, "2021 hqs"]
    out = capsys.readouterr().out
    assert all(n in out for n in names)
    assert {type(m.las).__name__ for m in Runtime.methods} == set(RESOURCES.values())


def test_u32_pid_past_the_plane_drops():
    """ROADMAP C5: the `.las` methods resolve through B3's plain version,
    which drops a pid of 2**32 - 1 (int32 -1), as the reference's
    `sorted_scatter_u64_min` (their resolve) does."""
    size = 8
    pid = np.array([3, EMPTY32, 3, size, 7], np.uint32)
    dep = np.array([5, 1, 6, 0, 9], np.uint32)
    pay = np.array([1, 2, 3, 4, 5], np.uint32)
    got = u64_min_planes([tuple(from_u32(a) for a in (pid, dep, pay))], size)
    want = ref_raster.sorted_scatter_u64_min(
        jnp.asarray(pid.view(np.int32)), jnp.asarray(dep), jnp.asarray(pay), size,
        jnp.full(size, EMPTY32, jnp.uint32), jnp.full(size, EMPTY32, jnp.uint32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert to_u32(got[0])[size - 1] == 9 and to_u32(got[1])[3] == 1
