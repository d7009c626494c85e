"""Port B3 (exact u64-min resolve) and the raster helpers vs the reference.

`u64_min_planes_plain` must give the planes of `raster.scatter_u64_min`
bit for bit — every u32 depth and payload, ties on depth broken by the
smaller payload, out-of-range pids dropped — and, on one case and on
the crafted ties, the planes of the TPU path (`dense_from_sorted_rows`
over nk3-sorted rows, interpret mode).  The crafted streams of
`tools/crafted.resolve_streams` and `crafted.flat_streams` are the ones
the card holds B3 to, in its chain and flat layouts.  Each caller of B3
and B4 names the layout of its parts: flat for the `.las` and Potree
frames, chain for the `.tpc`, `.huffman` and sharded frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.render import raster as ref
from pcrhpg24_tpu_torch.render import raster as port
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, key_views, split_key, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

SIZE = 49_152  # 48 swizzle tiles of 1024


def _stream(seed, n=16 * 1024, kind="collide"):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, SIZE, n).astype(np.uint32)
    dep = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(0, 2**24, n).astype(np.uint32)
    if kind == "collide":  # few pixels, many entries each
        pid = rng.integers(0, 64, n).astype(np.uint32) * 97
        pid[rng.random(n) < 0.3] = SIZE
    elif kind == "ties":  # equal depths per pixel: payload decides
        pid = rng.integers(0, 512, n).astype(np.uint32)
        dep = (0x3F800000 + (pid % 3)).astype(np.uint32)
    elif kind == "oob":
        pid = SIZE + rng.integers(0, 1000, n).astype(np.uint32)
    return pid, dep, pay


@pytest.mark.parametrize("kind", ["collide", "ties", "oob", "spread"])
def test_u64_min_plain_equals_scatter(kind):
    pid, dep, pay = _stream(len(kind), kind=kind)
    want = ref.scatter_u64_min(jnp.asarray(pid.astype(np.int32)),
                               jnp.asarray(dep), jnp.asarray(pay), SIZE)
    # two parts: the plane min-combines across streams
    h = len(pid) // 3
    parts = [tuple(from_u32(a[:h]) for a in (pid, dep, pay)),
             tuple(from_u32(a[h:]) for a in (pid, dep, pay))]
    got = port.u64_min_planes(parts, SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    if kind == "oob":
        assert (to_u32(got[1]) == 0xFFFFFFFF).all()


def test_u64_min_plain_equals_merge_kernel():
    """The TPU path: nk3-sorted rows through the matscatter merge."""
    from pcrhpg24_tpu.render.pallas_merge import dense_from_sorted_rows

    pid, dep, pay = _stream(7, kind="collide")
    rows = 4
    n = len(pid) // rows
    sp, sd, sy = jax.lax.sort(
        [jnp.asarray(a.reshape(rows, n)) for a in (pid, dep, pay)],
        num_keys=3, is_stable=False, dimension=1)
    want = dense_from_sorted_rows(sp, sd, sy, SIZE, True, interpret=True,
                                  fully_sorted=True, pay_bits=24)
    got = port.u64_min_planes([tuple(from_u32(a) for a in (pid, dep, pay))], SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))


def _crafted(kind, rows=16):
    """A crafted stream and its split into four uneven parts (one of 3
    entries, one starting mid-row)."""
    pid, dep, pay = crafted.resolve_streams(kind, rows, SIZE, seed=11)
    cuts = [0, 3 * 1024 + 37, 3 * 1024 + 40, 11 * 1024 + 5, len(pid)]
    parts = [tuple(from_u32(a[x:y]) for a in (pid, dep, pay))
             for x, y in zip(cuts, cuts[1:])]
    return (pid, dep, pay), parts


def _merge_kernel_planes(pid, dep, pay, rows=4):
    """The TPU path's planes: nk3-sorted rows through the matscatter merge
    (payloads below 2**24)."""
    from pcrhpg24_tpu.render.pallas_merge import dense_from_sorted_rows

    n = len(pid) // rows
    sp, sd, sy = jax.lax.sort(
        [jnp.asarray(a.reshape(rows, n)) for a in (pid, dep, pay)],
        num_keys=3, is_stable=False, dimension=1)
    return dense_from_sorted_rows(sp, sd, sy, SIZE, True, interpret=True,
                                  fully_sorted=True, pay_bits=24)


@pytest.mark.parametrize("kind", crafted.RESOLVE_KINDS)
def test_u64_min_plain_crafted_equals_scatter(kind):
    """Each crafted kind, in four uneven parts and in both part orders."""
    (pid, dep, pay), parts = _crafted(kind)
    # u32 pids, so the reference drops 2**32 - 1 as out of range
    want = ref.scatter_u64_min(jnp.asarray(pid), jnp.asarray(dep), jnp.asarray(pay), SIZE)
    for order in (parts, parts[::-1]):
        got = port.u64_min_planes(order, SIZE)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))


def test_u64_min_plain_crafted_ties_equals_merge_kernel():
    """Tied depths (the payload decides) against the TPU path."""
    (pid, dep, pay), parts = _crafted("ties")
    want = _merge_kernel_planes(pid, dep, pay)
    got = port.u64_min_planes(parts, SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))


@pytest.mark.parametrize("kind", crafted.FLAT_KINDS)
def test_u64_min_flat_crafted_equals_scatter(kind):
    """Each flat crafted kind through `u64_min_planes(..., layout="flat")`
    on the CPU, in five uneven parts (none a multiple of the flat tile's
    512 entries) and in both part orders."""
    n = 16 * 1024 - 333
    pid, dep, pay, _colour, _fb = crafted.flat_streams(kind, n, SIZE, seed=7)
    want = ref.scatter_u64_min(jnp.asarray(pid), jnp.asarray(dep), jnp.asarray(pay), SIZE)
    cuts = crafted.flat_cuts(n, 5, seed=2)
    parts = [tuple(from_u32(a[x:y]) for a in (pid, dep, pay)) for x, y in zip(cuts, cuts[1:])]
    for order in (parts, parts[::-1]):
        got = port.u64_min_planes(order, SIZE, layout="flat")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))


def test_flat_streams_reach_their_corners():
    n = 16 * 1024 - 333
    for kind in crafted.FLAT_KINDS:
        pid, dep, pay, colour, fb = crafted.flat_streams(kind, n, SIZE, seed=7)
        live = pid < SIZE
        same = pid[1:] == pid[:-1]
        np.testing.assert_array_equal(pay, np.arange(n))
        if kind == "one_pixel":  # every entry accepted
            assert np.unique(pid).size == 1 and live.all() and (dep == fb[pid]).all()
        elif kind == "runs":
            # runs of one pixel longer than a lane's neighbour, some of them
            # tied in depth, some dead
            assert same.mean() > 0.9 and {SIZE, SIZE + 1, 2**32 - 1} & set(pid.tolist())
            assert (same & (dep[1:] == dep[:-1]) & (pid[1:] < SIZE)).sum() > 1000
        else:
            assert kind == "random"
            assert (same & (pid[1:] < SIZE)).mean() < 0.01 and 0.7 < live.mean() < 0.8
        if kind != "one_pixel":  # EMPTY depths on landed pixels, tolerance edges
            assert (fb[pid[live]] == 0xFFFFFFFF).any()
            limit = fb[pid[live]].view(np.float32) * np.float32(1.01)
            assert (dep[live].view(np.float32) == limit).any()
    cuts = crafted.flat_cuts(n, 70, seed=3)
    assert len(cuts) == 71 and all((b - a) % 512 for a, b in zip(cuts, cuts[1:]))


def test_callers_pick_their_layout(monkeypatch):
    """The `.las` resolve (`loop_las.resolve_parts`, which every `.las`
    method and `basic` call) and the Potree resolves
    (`loop_nodes.resolve_node_parts`, `hqs_node_sums`) hand B3 and B4
    their parts in the flat layout; the `.tpc` frames (`huffman_tpu`,
    `huffman_tpu_hqs`), the `.huffman` HQS frame and the sharded frame
    (`parallel/mesh_native`) in the chain layout.  Each wrapper is
    wrapped to record the layout it is given."""
    from pcrhpg24_tpu_torch.parallel import mesh_native
    from pcrhpg24_tpu_torch.render import hqs
    from pcrhpg24_tpu_torch.render.methods import (huffman_hqs, huffman_tpu, huffman_tpu_hqs,
                                                   loop_las, loop_nodes)

    seen = []

    def recorder(fn, kernel):
        def wrapped(*args, layout="chain", **kw):
            seen.append((kernel, layout))
            return fn(*args, layout=layout, **kw)
        return wrapped

    mods = (loop_las, loop_nodes, huffman_tpu, huffman_tpu_hqs, huffman_hqs, mesh_native)
    for mod in mods:
        monkeypatch.setattr(mod, "u64_min_planes", recorder(port.u64_min_planes, "B3"))
        if hasattr(mod, "hqs_sums"):
            monkeypatch.setattr(mod, "hqs_sums", recorder(hqs.hqs_sums, "B4"))
    w, h = 64, 32
    size = port.swizzle_dims(w, h)[2]  # 2,048 = w * h: linear and swizzled alike
    pid, dep, pay, colour, _fb = crafted.flat_streams("random", 3000, size, seed=1)
    part = tuple(from_u32(a) for a in (pid, dep, pay))
    rgba = from_u32(colour)

    out = {}

    def layouts(run):
        seen.clear()
        out["last"] = run()
        return list(seen)

    assert layouts(lambda: loop_las.resolve_parts([part], rgba, w, h, hqs=True)) == [
        ("B3", "flat"), ("B4", "flat")]
    assert layouts(lambda: loop_nodes.resolve_node_parts(iter([part]), size, "cpu")) == [
        ("B3", "flat")]
    fb_d = out["last"][0].contiguous()
    assert layouts(lambda: loop_nodes.hqs_node_sums([part], rgba, fb_d, size)) == [
        ("B4", "flat")]
    streams = lambda *a, **k: ([part], size, torch.device("cpu"))  # noqa: E731
    for mod in (huffman_tpu, huffman_tpu_hqs, mesh_native):
        monkeypatch.setattr(mod, "frame_streams", streams)
    monkeypatch.setattr(huffman_hqs, "hqs_streams", lambda *a, **k: [part])
    args = dict(dev=None, frame_params=torch.zeros(4), tb=None, scale=None, width=w,
                height=h, nchunks=1, cull=False)
    assert layouts(lambda: huffman_tpu.render_frame_native(**args)) == [("B3", "chain")]
    assert layouts(lambda: huffman_tpu_hqs.hqs_frame_native(**args)) == [
        ("B3", "chain"), ("B4", "chain")]
    assert layouts(lambda: huffman_hqs.hqs_huffman_frame(
        None, None, None, None, None, w, h, [slice(0, 1)])) == [("B3", "chain"), ("B4", "chain")]
    assert layouts(lambda: mesh_native._local_plane(args, collapse=True)) == [("B3", "chain")]


def test_unknown_layout_raises():
    part = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(3))
    with pytest.raises(KeyError):
        port.u64_min_planes([part], SIZE, layout="rows")


def test_resolve_streams_reach_their_corners():
    for kind in crafted.RESOLVE_KINDS:
        pid, dep, pay = crafted.resolve_streams(kind, 64, SIZE, seed=11)
        n = len(pid)
        live = pid < SIZE
        grid = pid[: n // 1024 * 1024].reshape(-1, 1024)  # (point, chain)
        if kind == "one_pid":
            assert np.unique(pid).size == 1 and live.all()
        elif kind == "alternating":
            assert (grid[:, 1:] != grid[:, :-1]).all() and (grid[1:] != grid[:-1]).all()
        elif kind == "ties":
            # 4 points of a chain share a pixel, with other payloads
            assert (grid[0::4] == grid[3::4]).all()
            pays = pay.reshape(-1, 1024)
            assert (pays[0::4] != pays[1::4]).any()
            assert all(np.unique(dep[pid == q]).size == 1 for q in np.unique(pid))
        elif kind == "all_ones":
            ones = (dep == 0xFFFFFFFF) & (pay == 0xFFFFFFFF)
            only = np.setdiff1d(pid[live & ones], pid[live & ~ones])
            assert only.size and (pid[live & ~ones].size > 0)
            fb_d, fb_p = port.u64_min_planes(
                [tuple(from_u32(a) for a in (pid, dep, pay))], SIZE)
            assert (to_u32(fb_d)[only] == 0xFFFFFFFF).all()
            assert (to_u32(fb_p)[only] == 0xFFFFFFFF).all()
        elif kind == "sentinel":
            assert {SIZE, SIZE + 1, 2**32 - 1} <= set(pid[~live].tolist())
            assert 0.4 < live.mean() < 0.6
        elif kind in ("descending", "ascending"):
            step = np.diff(dep.astype(np.int64))
            assert ((step < 0) if kind == "descending" else (step > 0)).all()
        else:
            assert kind == "ragged"
            assert n % 1024 and n % (32 * 1024) and n % 32


def test_key_views_equal_split_key():
    """The card's hand-off of B3's and B6's u64 plane: strided views with
    the bits of `split_key`, EMPTY (all ones) included."""
    rng = np.random.default_rng(5)
    plane = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, 4096, dtype=np.int64))
    plane[::7] = -1
    for v, w in zip(key_views(plane), split_key(plane)):
        assert torch.equal(v, w)


@pytest.mark.parametrize("w,h", [(320, 180), (1920, 1080), (64, 32)])
def test_swizzle_equal(w, h):
    assert port.swizzle_dims(w, h) == ref.swizzle_dims(w, h)
    rng = np.random.default_rng(w)
    px = rng.integers(0, w, 1000).astype(np.int32)
    py = rng.integers(0, h, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        port.swizzle_pid(torch.from_numpy(px), torch.from_numpy(py), w).numpy(),
        np.asarray(ref.swizzle_pid(jnp.asarray(px), jnp.asarray(py), w)))
    size = ref.swizzle_dims(w, h)[2]
    fb = rng.integers(0, 2**32, size, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        to_u32(port.unswizzle_plane(from_u32(fb), w, h)),
        np.asarray(ref.unswizzle_plane(jnp.asarray(fb), w, h)))


def test_resolve_and_rgb8_equal():
    w, h = 320, 180
    rng = np.random.default_rng(3)
    fb = rng.integers(0, 2**24, w * h).astype(np.uint32)
    fb[rng.random(w * h) < 0.5] = 0xFFFFFFFF
    img = port.resolve(from_u32(fb), w, h)
    want = ref.resolve(jnp.asarray(fb), w, h)
    np.testing.assert_array_equal(to_u32(img), np.asarray(want))
    np.testing.assert_array_equal(port.image_to_rgb8(img).numpy(),
                                  np.asarray(ref.image_to_rgb8(want)))
