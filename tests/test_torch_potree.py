"""The Potree scenes of the PyTorch port vs the JAX reference, on the CPU:
`engine/potree_resource.PotreeData` (bins, node tables, the residency
cap, streaming, `unload`), `loop_nodes` and `loop_nodes_hqs`
(`render/methods/loop_nodes.py`) and the app on a Potree directory.

The scene is `tests/test_potree.py`'s: `terrain_cloud(120_000, seed=44,
extent=500.0)` through `build_potree` (21 nodes, levels 0-2).  The
reference renders through its methods' own `render` on its CPU path:
`raster_chunk_101010_nodes` per live chunk over the padded buffer, its
HQS `step` jitted inside `_hqs_accumulate_101010`.  Both are compiled
at `xla_backend_optimization_level=0`, because XLA-CPU otherwise
contracts the projection's multiply-adds into FMAs: the chunk function
is monkeypatched in `loop_nodes` with an O0-compiled one, and the `jax`
name of `loop_nodes` with a shim whose `jit` compiles at O0.  Every
comparison is bit for bit: planes, HQS sums and images.

The port's budgeted frame gathers each visible node's first `take`
points, the reference's TPU compact frame; it is held to the
reference's CPU frame, which masks the same points in place (the
reference's compact frame copies a segment twice where two nodes share
it, ROADMAP C1, so its HQS sums are not the ones to hold).
"""

import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu import app as ref_app
from pcrhpg24_tpu.engine import potree_resource as ref_res
from pcrhpg24_tpu.engine.debug import Debug as RefDebug
from pcrhpg24_tpu.engine.method import Runtime as RefRuntime
from pcrhpg24_tpu.engine.renderer import Renderer as RefRenderer
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods import loop_nodes as ref_ln
from pcrhpg24_tpu.tools.synth_potree import synth_potree as ref_synth
from pcrhpg24_tpu.utils.png import write_png_bytes
from pcrhpg24_tpu.utils.synthetic import terrain_cloud
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.engine import potree_resource as res
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
from pcrhpg24_tpu_torch.formats.potree import build_potree
from pcrhpg24_tpu_torch.render.methods import loop_nodes as ln
from pcrhpg24_tpu_torch.tools.synth_potree import synth_potree
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 192, 108
O0 = {"xla_backend_optimization_level": 0}
BG = 0x00443322
VIEWS = {
    "orbit": Setting(yaw=0.4, pitch=-0.8, radius=500.0, target=(250.0, 250.0, 100.0)),
    "mid": Setting(yaw=0.4, pitch=-0.8, radius=900.0, target=(250.0, 250.0, 60.0)),
    # a close-up whose frustum leaves nodes 4-12 out: at 16,384-point
    # chunks, chunks 5 and 7 hold no visible point
    "close": Setting(yaw=4.0, pitch=-0.5, radius=150.0, target=(400.0, 100.0, 60.0)),
}
CLASSES = {"loop_nodes": (ln.ComputeLoopNodes, ref_ln.ComputeLoopNodes),
           "loop_nodes_hqs": (ln.ComputeLoopNodesHqs, ref_ln.ComputeLoopNodesHqs)}

_COMPILED = {}


def _o0_call(fn, code, static, args, kw):
    """`fn` (jitted) compiled at O0 for these argument shapes and static
    values, then called with the dynamic ones."""
    kw = {**dict(zip(code.co_varnames[:code.co_argcount], args)), **kw}
    dyn = {k: v for k, v in kw.items() if k not in static}
    key = (code, tuple((k, getattr(v, "shape", None), str(getattr(v, "dtype", "")))
                       for k, v in dyn.items()),
           tuple(kw.get(k) for k in static))
    if key not in _COMPILED:
        _COMPILED[key] = fn.lower(**kw).compile(compiler_options=O0)
    return _COMPILED[key](**dyn)


def _per_op(fn):
    """A module-level jitted reference function, compiled at O0."""
    code = fn.__wrapped__.__code__
    return lambda *a, **kw: _o0_call(fn, code, ("width", "height"), a, kw)


class _O0Jax:
    """`jax` with a `jit` that compiles at O0 (for the HQS `step` that
    `_hqs_accumulate_101010` jits on each call); the rest is jax's."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fun=None, **kw):
        kw.pop("donate_argnums", None)
        static = tuple(kw.get("static_argnames", ()))
        jitted = jax.jit(fun, **kw)
        return lambda *a, **k: _o0_call(jitted, fun.__code__, static, a, k)


@pytest.fixture(autouse=True)
def _reference_at_o0(monkeypatch):
    monkeypatch.setattr(ref_ln, "raster_chunk_101010_nodes",
                        _per_op(ref_ln.raster_chunk_101010_nodes))
    monkeypatch.setattr(ref_ln, "jax", _O0Jax())
    yield
    for d in (Debug, RefDebug):
        d.frustum_culling_enabled = True
        d.node_budget = 0.0
    Runtime.clear()
    RefRuntime.resource = None


@functools.lru_cache(maxsize=1)
def _scene(root: str) -> str:
    xyz, rgb = terrain_cloud(120_000, seed=44, extent=500.0)
    path = os.path.join(root, "cloud")
    build_potree(path, xyz, rgb)
    return path


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The Potree directory and both packages' loaded resources."""
    path = _scene(str(tmp_path_factory.mktemp("tpotree")))
    port = res.PotreeData.create(path, "cpu").wait_loaded()
    ref = ref_res.PotreeData.create(path).wait_loaded()
    yield path, port, ref
    port.unload()
    ref.unload()


def _renderers(view: str):
    s = VIEWS[view] if isinstance(view, str) else view
    r, rr = Renderer(W, H, "cpu"), RefRenderer(W, H)
    for x in (r, rr):
        x.apply_setting(s)
        x.controls_update()
    return r, rr


def _frames(port, ref, name: str, view):
    """One frame of method `name` in each package, their resources
    loaded -> (port renderer, reference renderer, port image, reference
    image as numpy)."""
    cls, ref_cls = CLASSES[name]
    r, rr = _renderers(view)
    Runtime.resource, RefRuntime.resource = port, ref
    got = cls(r, port).render(r)
    want = np.asarray(ref_cls(rr, ref).render(rr))
    return r, rr, got, want


def _assert_same_frame(r, rr, got, want, shown: int = 500):
    np.testing.assert_array_equal(to_u32(got), want)
    for g, w in zip(r.last_fb, rr.last_fb):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (want != BG).sum() > shown


# -- the resource --------------------------------------------------------


def _same_resource(port, ref):
    assert [n.name for n in port.nodes] == [n.name for n in ref.nodes]
    assert [[n.name for n in b] for b in port.bins] == [[n.name for n in b] for b in ref.bins]
    for a in ("node_offset", "node_count", "node_level", "bbox_min", "bbox_max", "las_min"):
        np.testing.assert_array_equal(getattr(port, a), getattr(ref, a), err_msg=a)
    for a in ("num_points", "total_points", "nodes_loaded", "num_points_loaded",
              "resident_limited"):
        assert getattr(port, a) == getattr(ref, a), a
    n = ref.num_points_loaded
    assert set(port.dev) == set(ref.dev)
    for k, v in ref.dev.items():
        assert port.dev[k].shape == v.shape, k
        np.testing.assert_array_equal(to_u32(port.dev[k][:n]), np.asarray(v)[:n], err_msg=k)


@pytest.mark.parametrize("budget", [None, 60_000])
def test_resource_equals_reference(scene, monkeypatch, budget):
    """Bins, node tables, the loaded prefix of the four buffers and the
    node-id plane (the reference method's `nid_pt`); under `budget_points` (with 20,000-point bins) a coarse-first prefix
    of whole bins stays."""
    path, port, ref = scene
    if budget is None:
        _same_resource(port, ref)
        assert port.state.name == "LOADED" and port.total_points == 120_000
        nid = ref_ln.ComputeLoopNodes(None, ref)._per_point_tables(ref.num_points_loaded)
        np.testing.assert_array_equal(to_u32(port.node_ids[:120_000]),
                                      np.asarray(nid["nid_pt"])[:120_000])
        return
    monkeypatch.setattr(res, "BIN_POINTS", 20_000)
    monkeypatch.setattr(ref_res, "BIN_POINTS", 20_000)
    port = res.PotreeData.create(path, "cpu", budget_points=budget).wait_loaded()
    ref = ref_res.PotreeData.create(path, budget_points=budget).wait_loaded()
    _same_resource(port, ref)
    assert port.resident_limited and port.total_points <= budget
    port.unload()
    ref.unload()


def _queued(*resources, items: int):
    """Wait until each loader has `items` bins queued."""
    for _ in range(2000):
        if all(d._queue.qsize() >= items for d in resources):
            return
        threading.Event().wait(0.005)
    raise AssertionError("the loaders queued too few bins")


def test_load_streams_over_process_calls(scene, monkeypatch):
    """With 20,000-point bins the scene is five bins: each `process()`
    uploads one, and after each the loaded prefix equals the reference's."""
    path, _port, _ref = scene
    monkeypatch.setattr(res, "BIN_POINTS", 20_000)
    monkeypatch.setattr(ref_res, "BIN_POINTS", 20_000)
    port = res.PotreeData.create(path, "cpu")
    ref = ref_res.PotreeData.create(path)
    assert len(port.bins) == len(ref.bins) == 5
    port.load()
    ref.load()
    for step in range(5):
        _queued(port, ref, items=1)
        port.process()
        ref.process()
        _same_resource(port, ref)
        assert port.nodes_loaded == sum(len(b) for b in port.bins[:step + 1])
        assert port.state.name == ("LOADED" if step == 4 else "LOADING")
    port.unload()
    ref.unload()


def test_unload_stops_a_blocked_loader(scene, monkeypatch):
    """A loader blocked on its full queue stops at `unload`, and a reload
    starts over."""
    path, _port, ref = scene
    monkeypatch.setattr(res, "BIN_POINTS", 2_000)
    data = res.PotreeData.create(path, "cpu")
    assert len(data.bins) > res.QUEUE_BINS + 1
    data.load()
    for _ in range(400):  # the queue fills: the next put blocks
        if data._queue.full():
            break
        threading.Event().wait(0.005)
    assert data._queue.full()
    thread = data._thread
    data.unload()
    assert not thread.is_alive() and data.dev == {} and data.num_points_loaded == 0
    data.wait_loaded()
    np.testing.assert_array_equal(to_u32(data.dev["xyz4"][:120_000]),
                                  np.asarray(ref.dev["xyz4"])[:120_000])
    data.unload()


# -- the frames ----------------------------------------------------------


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_frame_equals_reference(scene, name, view, cull):
    """`loop_nodes` planes and image, `loop_nodes_hqs` depth plane, count
    plane and image, at three views with frustum culling on and off (the
    HQS pass culls either way, as the reference's does)."""
    _path, port, ref = scene
    Debug.frustum_culling_enabled = RefDebug.frustum_culling_enabled = cull
    _assert_same_frame(*_frames(port, ref, name, view))


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_hqs_sums_equal_reference(scene, view):
    """The four HQS sums (r, g, b, n) of the port's parts against the
    reference's `_hqs_accumulate_101010` over its live chunks, both on
    the reference's colour depth plane."""
    _path, port, ref = scene
    r, rr = _renderers(view)
    Runtime.resource, RefRuntime.resource = port, ref
    ref_ln.ComputeLoopNodes(rr, ref).render(rr)
    fb_d = rr.last_fb[0]
    cam = rr.camera
    view_m, proj = cam.view(), cam.proj()
    nn = ref.nodes_loaded
    bmin, bmax = ref.bbox_min[:nn], ref.bbox_max[:nn]
    level = ref_ln.node_levels(view_m, proj, bmin, bmax, W, H)
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes

    vis = batches_in_frustum(frustum_planes(proj @ view_m), bmin, bmax) & (level < 4)
    rm = ref_ln.ComputeLoopNodes(rr, ref)
    tables = rm._per_point_tables(ref.num_points_loaded)
    codes = rm._frame_codes(level, vis, len(ref.nodes))
    chunks = rm._live_chunks(tables["starts"], ref.node_count[:nn], vis,
                             ref.dev["xyz4"].shape[0])
    want = ref_ln._hqs_accumulate_101010(
        ref.dev, tables, codes, chunks, jnp.asarray((proj @ view_m).astype(np.float32)),
        fb_d, [jnp.zeros((W * H,), jnp.uint32) for _ in range(4)], W, H)
    m = ln.ComputeLoopNodesHqs(r, port)
    parts = ln.node_parts(**m.frame_args(r, m.frame_tables(r, cull=True)))
    got = ln.hqs_node_sums(parts, port.dev["rgba"], from_u32(np.asarray(fb_d)), W * H)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert int(np.asarray(want[3]).sum()) > 500


def test_frame_of_several_chunks_skips_a_culled_one(scene, monkeypatch):
    """16,384-point chunks in both packages: the close view's frame has
    several parts, and chunks 5 and 7 are skipped."""
    _path, port, ref = scene
    monkeypatch.setattr(ln, "CHUNK_PTS", 16_384)
    monkeypatch.setattr(ref_ln, "CHUNK_PTS", 16_384)
    r, _rr = _renderers("close")
    m = ln.ComputeLoopNodes(r, port)
    live = m.frame_tables(r, cull=True)["chunks"]
    assert list(live) == [0, 1, 2, 3, 4, 6]
    for name in CLASSES:
        _assert_same_frame(*_frames(port, ref, name, "close"))


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_mid_load_frame_equals_reference(scene, monkeypatch, name):
    """With 20,000-point bins, a frame taken as the load begins: the
    colour frame uploads one bin, the HQS frame two (its own `process()`
    and its colour pass's)."""
    path, _port, _ref = scene
    monkeypatch.setattr(res, "BIN_POINTS", 20_000)
    monkeypatch.setattr(ref_res, "BIN_POINTS", 20_000)
    port = res.PotreeData.create(path, "cpu")
    ref = ref_res.PotreeData.create(path)
    port.load()
    ref.load()
    bins = 2 if name == "loop_nodes_hqs" else 1
    _queued(port, ref, items=bins)
    r, rr, got, want = _frames(port, ref, name, "orbit")
    assert port.nodes_loaded == ref.nodes_loaded == sum(len(b) for b in port.bins[:bins])
    assert port.num_points_loaded < port.total_points
    _assert_same_frame(r, rr, got, want)
    port.unload()
    ref.unload()


def test_empty_frame_is_background(scene):
    """Before any bin is uploaded both methods return the background."""
    path, _port, ref = scene
    port = res.PotreeData.create(path, "cpu")
    port.load()
    port.process = lambda renderer=None: None
    r, _rr = _renderers("orbit")
    for cls, _ref_cls in CLASSES.values():
        img = to_u32(cls(r, port).render(r))
        assert img.shape == (H, W) and (img == BG).all()
    port.unload()


# -- the node budget -----------------------------------------------------


def _budget_64(monkeypatch):
    """`node_budget(density=0.5, min_take=64)` in both packages."""
    for mod in (ln, ref_ln):
        monkeypatch.setattr(mod, "node_budget",
                            functools.partial(mod.node_budget, min_take=64))
    Debug.node_budget = RefDebug.node_budget = 0.5


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_budgeted_frame_equals_masked_reference(scene, monkeypatch, name):
    """The port's compact frame (each visible node's first `take` points,
    gathered) equals the reference's masked frame.  The close view thins
    some nodes (take < count) and leaves whole visible nodes beside each
    other in one 4096-point segment (C1's case: the reference's compact
    HQS copies that segment twice)."""
    _path, port, ref = scene
    _budget_64(monkeypatch)
    r, _rr = _renderers("close")
    m = ln.ComputeLoopNodes(r, port)
    t = m.frame_tables(r, cull=True)
    nodes, takes = t["gather"]
    counts = port.node_count[nodes]
    assert (takes < counts).any()
    starts = port.node_offset[nodes]
    whole = np.flatnonzero((takes[:-1] == counts[:-1]) & (nodes[1:] == nodes[:-1] + 1)
                           & ((starts[:-1] + counts[:-1] - 1) // 4096 == starts[1:] // 4096))
    assert len(whole) > 0
    # each point of the cover is gathered once
    args = m.frame_args(r, t)
    index = np.concatenate([p[2].numpy() for p in ln.node_parts(**args)])
    assert len(np.unique(index)) == len(index) == takes.sum()
    _assert_same_frame(*_frames(port, ref, name, "close"))


def test_compact_cover_overflow_shrinks_the_takes(scene, monkeypatch):
    """With COMPACT_CAP at half the takes' segment cover, every take
    shrinks by 9/10 steps, as the reference's compact tables do; the
    frame renders those takes, and its masked chunks mask to them."""
    _path, port, ref = scene
    _budget_64(monkeypatch)
    r, rr = _renderers("close")
    m = ln.ComputeLoopNodes(r, port)
    nodes, takes = m.frame_tables(r, cull=True)["gather"]
    starts = port.node_offset[nodes]
    cover = int((((starts + takes - 1) // 4096) - starts // 4096 + 1).sum())
    cap = (cover // 2) * 4096
    for mod in (ln, ref_ln):
        monkeypatch.setattr(mod, "COMPACT_CAP", cap)
    nodes2, takes2 = m.frame_tables(r, cull=True)["gather"]
    np.testing.assert_array_equal(nodes2, nodes)
    assert (takes2 <= takes).all() and takes2.sum() < takes.sum()
    cam = rr.camera
    view, proj = cam.view(), cam.proj()
    nn = ref.nodes_loaded
    bmin, bmax = ref.bbox_min[:nn], ref.bbox_max[:nn]
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes

    level = ref_ln.node_levels(view, proj, bmin, bmax, W, H)
    vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax) & (level < 4)
    take = ref_ln.node_budget(view, proj, bmin, bmax, ref.node_count[:nn], W, H, density=0.5)
    want = ref_ln.ComputeLoopNodes(rr, ref)._compact_frame_tables(vis, level, take)
    assert int(takes2.sum()) == want["budgeted_pts"]
    # the masked chunks of the shrunk takes hold what the compact frame gathers
    for got, want in zip(m.frame(r), m.frame(r, compact=False)):
        np.testing.assert_array_equal(to_u32(got), to_u32(want))
    Runtime.resource = port
    img = to_u32(m.render(r))
    assert (img != BG).sum() > 500


# -- synth_potree and the app --------------------------------------------


def test_synth_potree_writes_the_reference_bytes(tmp_path):
    """250,000 points at depth 1: the three files byte for byte."""
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    synth_potree(a, 250_000, depth=1, inner_n=20_000, verbose=False)
    ref_synth(b, 250_000, depth=1, inner_n=20_000, verbose=False)
    for f in ("metadata.json", "hierarchy.bin", "octree.bin"):
        assert open(os.path.join(a, f), "rb").read() == open(os.path.join(b, f), "rb").read(), f


def _argv(path, *extra):
    s = VIEWS["orbit"]
    return ["--scene", path, "--width", str(W), "--height", str(H), "--yaw", str(s.yaw),
            "--pitch", str(s.pitch), "--radius", str(s.radius),
            "--target", *map(str, s.target), *extra]


@pytest.mark.parametrize("method", sorted(CLASSES))
def test_app_png_equals_reference(scene, tmp_path, method):
    """`app.run --scene <potree dir> --device cpu` builds the reference's
    two methods in its order and writes its pipeline's PNG."""
    path, _port, _ref = scene
    png = tmp_path / "port.png"
    rr = app.run(_argv(path, "--method", method, "--device", "cpu", "--screenshot", str(png)))
    assert [m.name for m in Runtime.methods] == ["loop_nodes", "loop_nodes_hqs"]
    assert Runtime.selected.potree.state.name == "LOADED"
    Runtime.selected.potree.unload()
    want = RefRenderer(W, H)
    RefRuntime.clear()
    ref_app.build_methods(want, path)
    RefRuntime.set_selected(method)
    m = RefRuntime.selected
    m.update(want)
    m.potree.wait_loaded(want)
    want.apply_setting(VIEWS["orbit"])
    want.loop(m.update, m.render, frames=1)
    img = np.asarray(want.last_image)
    np.testing.assert_array_equal(to_u32(rr.last_image), img)
    assert png.read_bytes() == write_png_bytes(np.asarray(ref_raster.image_to_rgb8(img)))
    m.potree.unload()
    RefRuntime.clear()


def test_list_methods(scene, capsys):
    path, _port, _ref = scene
    rr = app.run(["--scene", path, "--device", "cpu", "--list-methods"])
    out = capsys.readouterr().out.splitlines()
    RefRuntime.clear()
    ref_app.main(["--scene", path, "--list-methods"])
    assert out == capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["loop_nodes", "loop_nodes_hqs"]
    assert rr.frame_count == 0
    RefRuntime.clear()
