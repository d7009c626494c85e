"""B10's exchange probe and the rest of B3's probes of
`pcrhpg24_tpu_torch/experiments/` on the CPU.

Their kernels run only on a card, so this file holds what the card's
results are held to, against the reference:
- the exchange (`exp_mxu_perm`): `perm_plain` equals the TPU probe's own
  `mk_kernel("roll", n)` and `mk_kernel("mxu", n)` run through
  `pl.pallas_call` in interpret mode on seeded tiles.  The TPU probe
  times TPU work when imported, so its imports, `SUBL, LANES` and
  `mk_kernel` are compiled alone from its source (`ast`);
- B3's variants (`r3_corient`, `r3_flushacc`, `r3_i8dot`, `r3_p4dot`,
  `r4_pwin`): every exact variant's plain version equals the reference's
  `sorted_resolve_u64_min` on crafted chain and flat streams (many depth
  ties, all-ones keys, dead pids) cut into uneven parts, two of them
  shorter than a tile; combine-would-be's plain count equals a numpy
  count over the kernel's tile slots; the position tiles' plain reads
  cover every entry once, and both tilings' plain tile counts equal a
  numpy reckoning.
It also checks that every new entry point raises on CPU tensors before
any build, and that rowload raises on a part off a 16-byte boundary.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu_torch.experiments import (exp_mxu_perm, probes, r3_corient, r3_flushacc,
                                            r3_i8dot, r3_p4dot, r4_pwin)
from pcrhpg24_tpu_torch.render.raster import key_plane
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SIZE = 49_152  # 48 swizzle tiles of 1024
N = 16 * 1024  # entries of a crafted stream
STREAMS = ([("chain", k) for k in ("ties", "sentinel", "all_ones")]
           + [("flat", k) for k in ("runs", "random")])
LAYOUTS = ("chain", "flat")


# ---- the exchange ----

@pytest.fixture(scope="module")
def tpu_perm() -> dict:
    """The TPU probe's namespace: its imports, `SUBL, LANES` and
    `mk_kernel`, compiled alone from `experiments/exp_mxu_perm.py` (the
    file times TPU work when imported)."""
    path = REPO / "experiments" / "exp_mxu_perm.py"
    tree = ast.parse(path.read_text(), str(path))

    def keep(node) -> bool:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return True
        if isinstance(node, ast.FunctionDef):
            return node.name == "mk_kernel"
        return isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Tuple) and [e.id for e in t.elts] == ["SUBL", "LANES"]
            for t in node.targets)

    body = [n for n in tree.body if keep(n)]
    assert [type(n).__name__ for n in body].count("FunctionDef") == 1
    ns: dict = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    assert (ns["SUBL"], ns["LANES"]) == (exp_mxu_perm.SUB, exp_mxu_perm.LANES)
    return ns


def _tpu(ns: dict, mode: str, stages: int, x: np.ndarray) -> np.ndarray:
    """The TPU probe's kernel on x, as its `run` calls it, in interpret mode."""
    pl = ns["pl"]
    spec = pl.BlockSpec((1, ns["SUBL"], ns["LANES"]), lambda t: (t, 0, 0))
    f = pl.pallas_call(ns["mk_kernel"](mode, stages), grid=(x.shape[0],), in_specs=[spec],
                       out_specs=spec, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
                       interpret=True)
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("mode,stages", [("roll", 55), ("mxu", 55), ("roll", 10), ("mxu", 10)])
def test_perm_plain_equals_tpu_probe(tpu_perm, mode, stages):
    """perm_plain equals the TPU probe's kernel, by roll and by the MXU, at
    its 55 stages and at 10 (not a multiple of 7), on 4 seeded tiles."""
    x = exp_mxu_perm.inputs(4, seed=3)
    want = _tpu(tpu_perm, mode, stages, x.numpy())
    got = exp_mxu_perm.perm_plain(x, stages)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x.numpy())


def test_perm_plain_full_range_and_probe_input(tpu_perm):
    """On int32s of the full range (negative ones too) the plain version
    equals the roll kernel; `inputs(256)` is the TPU probe's own input."""
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, (2, 8, 128), dtype=np.int64).astype(np.int32))
    np.testing.assert_array_equal(exp_mxu_perm.perm_plain(x, 17).numpy(),
                                  _tpu(tpu_perm, "roll", 17, x.numpy()))
    want = np.random.default_rng(0).integers(0, 1 << 30, (256, 8, 128)).astype(np.int32)
    np.testing.assert_array_equal(exp_mxu_perm.inputs(256).numpy(), want)
    assert torch.equal(exp_mxu_perm.perm_plain(x, 0), x)


# ---- B3's variants ----

def _stream(layout: str, kind: str):
    if layout == "chain":
        return crafted.resolve_streams(kind, N // 1024, SIZE, seed=11)
    return crafted.flat_streams(kind, N, SIZE, seed=7)[:3]


def _cuts(seed: int = 2) -> list:
    """Uneven cuts of N entries, with two parts shorter than a tile (100
    and 30 entries)."""
    return sorted(set(crafted.flat_cuts(N, 5, seed=seed)) | {100, 130})


def _parts(stream, cuts):
    return [tuple(from_u32(a[x:y]) for a in stream) for x, y in zip(cuts, cuts[1:])]


_REFERENCE = {}


def _reference(stream):
    """The reference's planes (u32): `sorted_resolve_u64_min` on the
    stream."""
    from pcrhpg24_tpu.render.raster import sorted_resolve_u64_min

    key = tuple(a.tobytes() for a in stream)
    if key not in _REFERENCE:
        _REFERENCE[key] = [np.asarray(x) for x in sorted_resolve_u64_min(
            *(jnp.asarray(a) for a in stream), SIZE)]
    return _REFERENCE[key]


def _plains():
    """(module, variant, plain version) of every exact variant of the
    slice's B3 probes."""
    mods = (r3_corient, r3_flushacc, r3_i8dot, r3_p4dot, r4_pwin)
    return [(m.__name__.rsplit(".", 1)[1], v, fn) for m in mods for v, fn in m.PLAIN.items()]


@pytest.mark.parametrize("layout,kind", STREAMS)
def test_exact_variants_plain_equal_reference(layout, kind):
    """Every exact variant's plain version (rowload, shfl, combine,
    two-pass, half-gather, position and their baselines), on the stream in
    uneven parts, equals the reference's sorted resolve of the stream."""
    stream = _stream(layout, kind)
    want = _reference(stream)
    parts = _parts(stream, _cuts())
    assert min(p[0].numel() for p in parts) < 512
    for module, variant, plain in _plains():
        for g, w in zip(plain(parts, SIZE), want):
            np.testing.assert_array_equal(to_u32(g), w, err_msg=f"{module} {variant}")


def test_two_pass_plain_ties_and_all_ones():
    """two-pass's plain version on a crafted pixel set: a depth tie won on
    the payload, a depth of all ones with a payload below all ones (it
    lands), an all-ones key (it does not), a dead pid."""
    pid = np.array([5, 5, 5, 7, 7, 9, SIZE + 3], np.uint32)
    dep = np.array([10, 10, 11, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0], np.uint32)
    pay = np.array([8, 3, 0, 0xFFFFFFFF, 6, 0xFFFFFFFF, 0], np.uint32)
    stream = (pid, dep, pay)
    got = r3_i8dot.two_pass_plain(_parts(stream, [0, 2, 7]), SIZE)
    for g, w in zip(got, _reference(stream)):
        np.testing.assert_array_equal(to_u32(g), w)
    d, y = (to_u32(g) for g in got)
    assert (d[5], y[5], d[7], y[7], y[9]) == (10, 3, 0xFFFFFFFF, 6, 0xFFFFFFFF)


def _tile_entries(n: int, layout: str) -> np.ndarray:
    """(tiles, 32 lanes, 16 columns) entry indices the kernel's tiles
    read from a part of n entries at the shipped widths: chain tiles of
    32 rows x 16 columns of 1024-entry rows, lane l holding row l of its
    band; flat tiles of 512 entries, lane l column c holding 32 c + l."""
    lane, col = np.arange(32)[None, :, None], np.arange(16)[None, None, :]
    if layout == "flat":
        return np.arange(-(-n // 512))[:, None, None] * 512 + 32 * col + lane
    band, block = np.divmod(np.arange(-(-(-(-n // 1024)) // 32) * 64), 64)
    return (band[:, None, None] * 32 * 1024 + lane * 1024 + (block * 16)[:, None, None] + col)


@pytest.mark.parametrize("layout,kind", STREAMS)
def test_combine_groups_plain_equals_numpy(layout, kind):
    """combine-would-be's plain count, in both layouts, equals a numpy
    count of the distinct (part, tile, column, pid) among the tile slots'
    live entries whose key is not all ones."""
    stream = _stream(layout, kind)
    cuts = _cuts()
    parts = _parts(stream, cuts)
    for lay in LAYOUTS:
        rows = []
        for k, (x, y) in enumerate(zip(cuts, cuts[1:])):
            e = _tile_entries(y - x, lay)
            t, _lane, c = np.indices(e.shape)
            ok = e < y - x
            pid, dep, pay = (a[x:y][e[ok]].astype(np.int64) for a in stream)
            live = (pid < SIZE) & ~((dep == 0xFFFFFFFF) & (pay == 0xFFFFFFFF))
            rows.append(np.stack([np.full(live.sum(), k), t[ok][live], c[ok][live], pid[live]], 1))
        want = len(np.unique(np.concatenate(rows), axis=0))
        assert r3_flushacc.groups_plain(parts, SIZE, lay) == want, lay
        assert want <= probes.would_be_plain(parts, SIZE)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tile_counts_plain_equal_numpy(layout):
    """Both tilings' plain tile counts equal numpy's reckoning on parts
    shorter than a tile and on 70 parts (two launches); the position
    tiles' plain reads take every entry of the parts once, and the
    dead entries are their slots less the parts'."""
    for ns in ([n for n in np.diff(_cuts())], list(np.diff(crafted.flat_cuts(N, 70, seed=3))),
               [0, 5000, 0, 1]):
        ns = [int(n) for n in ns]
        live = [n for n in ns if n]
        per_part = sum(len(_tile_entries(n, layout)) for n in live)
        assert r4_pwin.tiles_plain(ns, layout, "per-part") == per_part
        position = 0
        for k in range(0, len(live), 64):
            group = live[k:k + 64]
            slots = r4_pwin.position_slots(group, layout).numpy()
            taken = np.sort(slots[slots >= 0])
            np.testing.assert_array_equal(taken, np.arange(sum(group)))
            position += len(slots)
            if layout == "flat":
                assert len(slots) == -(-sum(group) // 512)
            else:
                assert len(slots) == -(-sum(-(-n // 1024) for n in group) // 32) * 64
        assert r4_pwin.tiles_plain(ns, layout, "position") == position
        assert position <= per_part
    assert r4_pwin.slots(layout) == 512


def test_entry_points_raise_on_cpu_tensors():
    """Each new probe's launch and `run` raise on CPU tensors, before any
    build, and count no launch; rowload raises on a part that starts off
    a 16-byte boundary."""
    stream = _stream("flat", "random")
    parts = _parts(stream, [0, N])
    plane, sums = key_plane(SIZE, "cpu"), probes.new_sums("cpu")
    calls = [lambda: r3_corient.corient(parts, SIZE, "staged", plane, sums),
             lambda: r3_corient.corient(parts, SIZE, "rowload", plane, sums),
             lambda: r3_flushacc.combine(parts, SIZE, "flat", "combine", plane, sums),
             lambda: r3_i8dot.narrow(parts, SIZE, "chain", "depth-pass", plane, sums),
             lambda: r4_pwin.pwin(parts, SIZE, "flat", "position", plane, sums),
             lambda: exp_mxu_perm.perm(exp_mxu_perm.inputs(2), "shfl"),
             lambda: exp_mxu_perm.run("no card", device="cpu")]
    calls += [lambda run=run: run("cpu", parts, SIZE, "no card")
              for run in (r3_corient.run, r3_flushacc.run, r3_i8dot.run, r3_p4dot.run,
                          r4_pwin.run)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    skewed = [tuple(from_u32(a[:N // 2 + 1])[1:] for a in stream)]
    with pytest.raises(ValueError, match="16-byte"):
        r3_corient.corient(skewed, SIZE, "rowload", plane, sums)
    with pytest.raises(ValueError, match="CUDA"):  # the other forms take any address
        r3_corient.corient(skewed, SIZE, "shfl", plane, sums)
    assert probes.build.cache_info().currsize == 0
    assert all(k.launches == 0 for k in probes.PROBES.values())
