"""The last slice of the probes of `pcrhpg24_tpu_torch/experiments/` on
the CPU: `r3_matscatter`'s two sites and B6's six.

Their kernels run only on a card, so this file holds what the card's
results are held to:
- `r3_matscatter`'s plain versions (atomic-head and store-head over a
  stream sorted by the full key) against the TPU probe's own kernels,
  `make_matscatter(1, False)` and `make_matscatter(2, True)`, and B6's
  Pallas kernel with no suffix-min (`pm._merge_nk1_kernel_ilp(
  suffix_steps=0)`), each through `pl.pallas_call(..., interpret=True)`
  on `build_rows_window_table`'s tables over 16 rows sorted by
  `lax.sort(num_keys=3)`.  The TPU probe renders a scene when imported,
  so its imports, `TPS, SUBS, LANES, RING`, `_shift_down1` and
  `make_matscatter` are compiled alone from its source (`ast`);
- the key sorts (key2, key3) against `lax.sort(num_keys=3)`;
- every exact B6 variant's plain version against the reference's B6,
  `pallas_merge.dense_from_sorted_nk1(..., interpret=True)`, on crafted
  pid-sorted streams (ties, all-ones keys, dead pids, runs longer than a
  warp);
- `warp_runs_plain`, `truncated_plain` and the lesions' checksums and
  counts against numpy loops over the kernel's warps;
- the compaction's plain version and the row sorts.
It also checks that every new entry point raises on CPU tensors before
any build.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.render import pallas_merge as pm
from pcrhpg24_tpu_torch.experiments import (probes, r2_merge_tune, r3_build_v2,
                                            r3_kernel_floor, r3_matscatter, r3_merge_micro,
                                            r3_merge_micro2, r3_rows_prefix)
from pcrhpg24_tpu_torch.render.raster import key_plane
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SIZE = 49_152  # 48 swizzle tiles of 1024
N = 16 * 1024  # entries of a crafted stream
M_SIZE = 8192  # the matscatter tests' plane: 8 tiles of 1024
M_ROWS = 16  # ... and their 16 sorted rows of 1024 entries
KINDS = ("ties", "all_ones", "sentinel", "one_pid")


def _port(arrays):
    return tuple(from_u32(a) for a in arrays)


def _planes(got):
    return [to_u32(g) for g in got]


# ---- r3_matscatter against the TPU probe's kernels ----

@pytest.fixture(scope="module")
def tpu_matscatter() -> dict:
    """The TPU probe's namespace: its imports, `TPS, SUBS, LANES, RING`,
    `_shift_down1` and `make_matscatter`, compiled alone from
    `experiments/r3_matscatter.py` (the file renders a scene when
    imported)."""
    path = REPO / "experiments" / "r3_matscatter.py"
    tree = ast.parse(path.read_text(), str(path))

    def keep(node) -> bool:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return True
        if isinstance(node, ast.FunctionDef):
            return node.name in ("_shift_down1", "make_matscatter")
        return isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Tuple) and [e.id for e in t.elts] == ["TPS", "SUBS", "LANES", "RING"]
            for t in node.targets)

    body = [n for n in tree.body if keep(n)]
    assert [type(n).__name__ for n in body].count("FunctionDef") == 2
    ns: dict = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    assert (ns["TPS"], ns["SUBS"], ns["LANES"], ns["RING"]) == (pm.TPS, pm.SUBS, pm.LANES, pm.RING)
    return ns


@pytest.fixture(scope="module")
def matscatter_stream():
    """16,384 seeded entries: pids in [0, 10240) (2,048 of them off the
    8,192-pixel plane), depths in [0, 50) (many ties), random payloads
    -> (the stream, its 16 rows sorted by `lax.sort(num_keys=3)`)."""
    rng = np.random.default_rng(18)
    n = M_ROWS * 1024
    stream = (rng.integers(0, 10240, n).astype(np.uint32), rng.integers(0, 50, n).astype(np.uint32),
              rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    rows = jax.lax.sort([jnp.asarray(a.reshape(M_ROWS, 1024)) for a in stream], num_keys=3,
                        is_stable=False, dimension=1)
    return stream, rows


def _tpu_planes(kern_of, wide: int, rows, ns=None):
    """The TPU kernel `kern_of(nrows)` over the sorted rows, as the TPU
    probe's `run_variant` calls it, in interpret mode -> (dep, pay) u32."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    sp, sd, sy = rows
    cumwin, wrowtile, nrows, nprog = pm.build_rows_window_table(
        sp, M_SIZE, wide=wide, clip=pm.CLIP_TILES, tile_cols=16)
    if ns is not None:
        ns["NROWS"] = nrows  # the kernel reads it when traced
    ntiles_pad = nprog * pm.TPS
    as_i32 = lambda x: jax.lax.bitcast_convert_type(x.astype(jnp.uint32),  # noqa: E731
                                                    jnp.int32).reshape(-1, pm.LANES)
    outspec = pl.BlockSpec((pm.TPS * pm.SUBS, pm.LANES), lambda i: (i, 0))
    outshape = jax.ShapeDtypeStruct((ntiles_pad * pm.SUBS, pm.LANES), jnp.int32)
    win = pltpu.VMEM((pm.RING, pm.SUBS, pm.LANES), jnp.int32)
    outs = pl.pallas_call(
        kern_of(nrows), grid=(nprog,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2
        + [pl.BlockSpec(memory_space=pl.ANY)] * 3,
        out_specs=[outspec] * 2, out_shape=[outshape] * 2,
        scratch_shapes=[win] * 3 + [pltpu.SemaphoreType.DMA((pm.RING, 3))], interpret=True,
    )(cumwin, wrowtile, as_i32(sp), as_i32(sd), as_i32(sy))
    return [np.asarray(jax.lax.bitcast_convert_type(o, jnp.uint32)).reshape(-1)[:M_SIZE]
            for o in outs]


@pytest.mark.parametrize("kernel", ["matscatter wide=1 one-dot", "matscatter wide=2 loop-dots",
                                    "nk1 suffix_steps=0"])
def test_matscatter_plains_equal_tpu_probe(tpu_matscatter, matscatter_stream, kernel):
    """atomic-head's and store-head's plain versions, on the stream sorted
    by the full key (key2), equal the TPU probe's kernel on its 16
    row-sorted rows, bit for bit."""
    from functools import partial

    stream, rows = matscatter_stream
    if kernel.startswith("matscatter"):
        wide = 1 if "wide=1" in kernel else 2
        make = tpu_matscatter["make_matscatter"]
        want = _tpu_planes(lambda nrows: make(wide, "loop" in kernel), wide, rows,
                           tpu_matscatter)
    else:
        want = _tpu_planes(lambda nrows: partial(pm._merge_nk1_kernel_ilp, nrows=nrows,
                                                 wide=pm.ILP_WIDE, suffix_steps=0),
                           pm.ILP_WIDE, rows)
    ks = probes.sort_by_key2(*_port(stream))
    for variant, plain in r3_matscatter.PLAIN.items():
        for g, w in zip(_planes(plain(ks, M_SIZE)), want):
            np.testing.assert_array_equal(g, w, err_msg=variant)
    assert (want[1] != 0xFFFFFFFF).sum() > 4000


def test_key_sorts_equal_lax_sort():
    """key2's order equals key3's, and both lax.sort(num_keys=3)'s, on a
    stream with ties in every key, whole duplicates, all-ones keys and
    pids with the top bit set."""
    rng = np.random.default_rng(4)
    n = 5000
    pid = rng.choice(np.array([3, 7, 2**31 + 5, 2**32 - 1, 40], np.uint32), n)
    dep = rng.choice(np.array([0, 1, 2**31, 2**32 - 1], np.uint32), n)
    pay = rng.choice(np.array([9, 2**31 + 1, 2**32 - 1], np.uint32), n)
    want = jax.lax.sort([jnp.asarray(a) for a in (pid, dep, pay)], num_keys=3, is_stable=False)
    for sort in (probes.sort_by_key2, probes.sort_by_key3):
        for g, w in zip(sort(*_port((pid, dep, pay))), want):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w), err_msg=sort.__name__)


# ---- B6's exact variants against the reference's B6 ----

_REFERENCE = {}


def _pid_sorted(kind: str):
    """A crafted stream of `kind` sorted by pid alone (`lax.sort(num_keys=1)`,
    the reference's sort) -> (numpy u32 arrays, the reference's B6 planes)."""
    if kind not in _REFERENCE:
        stream = crafted.resolve_streams(kind, N // 1024, SIZE, seed=21)
        s = [np.asarray(a) for a in jax.lax.sort([jnp.asarray(a) for a in stream], num_keys=1,
                                                 is_stable=False)]
        want = pm.dense_from_sorted_nk1(*map(jnp.asarray, s), SIZE, True, interpret=True)
        _REFERENCE[kind] = (s, [np.asarray(w) for w in want])
    return _REFERENCE[kind]


def _exact_plains(s, size: int):
    """(module, variant, plain version) of every variant exact on the
    pid-sorted stream `s`: each module's, and r3_build_v2's depths that
    cover the stream's longest warp-local run."""
    out = []
    for m in (r2_merge_tune, r3_kernel_floor, r3_merge_micro, r3_merge_micro2):
        name = m.__name__.rsplit(".", 1)[1]
        out += [(name, v, f) for v, f in m.PLAIN.items() if v in ("full", "aos")
                or m in (r3_merge_micro, r3_merge_micro2)]
    need = probes.steps_needed(probes.warp_runs_plain(s[0], size))
    out += [("r3_build_v2", f"{k} steps", lambda s, size, k=k: r3_build_v2.plain(s, size, k))
            for k in r3_build_v2.STEPS if k >= need]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_exact_b6_plains_equal_reference(kind):
    """Every exact B6 variant's plain version (full, aos, each (groups,
    stages), each cut, each covering depth) on the pid-sorted stream, and
    every r3_rows_prefix path's, equal the reference's B6 in interpret
    mode."""
    s_np, want = _pid_sorted(kind)
    s = _port(s_np)
    plains = _exact_plains(s, SIZE)
    assert len(plains) >= 20
    for module, variant, plain in plains:
        for g, w in zip(_planes(plain(s, SIZE)), want):
            np.testing.assert_array_equal(g, w, err_msg=f"{module} {variant}")
    live = r3_rows_prefix.compact_plain(s, SIZE)
    for path, picked in (("live", live), *((f"rows-{r}", r3_rows_prefix.rows_sort(s, r))
                                           for r in r3_rows_prefix.ROWS)):
        got = r3_merge_micro.PLAIN["full"](probes.sort_by_key3(*picked) if path == "live"
                                           else picked, SIZE)
        for g, w in zip(_planes(got), want):
            np.testing.assert_array_equal(g, w, err_msg=path)
    if kind in ("ties", "one_pid"):  # runs longer than a warp
        assert probes.warp_runs_plain(s[0], SIZE) == 32


# ---- the scan's depth, the lesions' checksums and counts, in numpy ----

def _warps_np(pid, size: int):
    """Per aligned warp of 32 entries: its segments as (start, end) lane
    ranges, in a numpy loop."""
    n = len(pid)
    for w0 in range(0, n, 32):
        lanes = list(range(w0, min(w0 + 32, n)))
        start = lanes[0]
        for i in lanes[1:] + [None]:
            if i is None or pid[i] != pid[i - 1]:
                yield start, (lanes[-1] + 1 if i is None else i)
                start = i


def _small_stream(seed: int, n: int = 3001):
    """A pid-sorted stream with runs of 1 to 40 entries, dead pids at the
    tail, depth ties and all-ones keys."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 41, n)
    pid = np.repeat(np.arange(n, dtype=np.uint32) * 3, lengths)[:n]
    pid[-200:] = SIZE + 7
    dep = rng.integers(0, 4, n).astype(np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ones = rng.random(n) < 0.1
    dep[ones], pay[ones] = 0xFFFFFFFF, 0xFFFFFFFF
    return pid, dep, pay


@pytest.mark.parametrize("seed", [1, 2])
def test_runs_truncated_and_checksums_equal_numpy(seed):
    """warp_runs_plain is the longest live warp-local segment; at each
    depth truncated_plain is the min over each segment's first 2**steps
    entries; heads_fold_plain, count_plain, read_plain and grid_plain are
    the no-atomic, count, read-only and grid lesions' folds, each counted
    in a numpy loop."""
    pid, dep, pay = _small_stream(seed)
    s = _port((pid, dep, pay))
    key = (dep.astype(np.uint64) << np.uint64(32)) | pay
    segs = list(_warps_np(pid, SIZE))
    live = [(a, b) for a, b in segs if pid[a] < SIZE]
    assert probes.warp_runs_plain(s[0], SIZE) == max(b - a for a, b in live)
    for steps in range(6):
        best = {}
        for a, b in live:
            k = int(key[a:min(b, a + (1 << steps))].min())
            best[int(pid[a])] = min(best.get(int(pid[a]), 2**64 - 1), k)
        want = np.full(SIZE, 2**64 - 1, np.uint64)
        want[list(best)] = list(best.values())
        d, y = _planes(probes.truncated_plain(s, SIZE, steps))
        np.testing.assert_array_equal((d.astype(np.uint64) << np.uint64(32)) | y, want)
    fold = sum(int(np.uint32(m >> np.uint64(32)) ^ np.uint32(m & np.uint64(0xFFFFFFFF)))
               for m in (key[a:b].min() for a, b in live)) % 2**32
    assert probes.heads_fold_plain(s, SIZE) == fold
    assert probes.count_plain(s, SIZE) == len(live)
    assert probes.read_plain(s) == int(np.bitwise_xor.reduce(pid ^ dep ^ pay))
    assert probes.grid_plain(len(pid)) == int(np.bitwise_xor.reduce(np.arange(len(pid))))
    shapes = probes.warp_shapes(s, SIZE)
    padded = np.concatenate([pid, np.full(-len(pid) % 32, 0xFFFFFFFF, np.uint32)])
    per_warp = np.bincount([a // 32 for a, _b in _warps_np(padded, SIZE)])
    assert (shapes["warps"], shapes["uniform"], shapes["distinct"]) == (
        -(-len(pid) // 32), int((per_warp == 1).sum()), int((per_warp == 32).sum()))


def test_compaction_and_row_sorts_plain():
    """compact_plain keeps the multiset of live entries (and nothing
    else); rows_sort sorts each row by pid as u32 and keeps the multiset,
    with dead padding to a multiple of the rows; the interleaved rows are
    (pid, dep, pay, 0)."""
    pid, dep, pay = crafted.resolve_streams("sentinel", 4, SIZE, seed=5)
    pid, dep, pay = pid[:4000], dep[:4000], pay[:4000]
    s = _port((pid, dep, pay))
    live = pid < SIZE
    got = np.stack([to_u32(t) for t in r3_rows_prefix.compact_plain(s, SIZE)], 1)
    want = np.stack([pid[live], dep[live], pay[live]], 1)
    rec = "u4,u4,u4"  # whole entries, sorted as records
    np.testing.assert_array_equal(np.sort(got.view(rec), 0), np.sort(want.view(rec), 0))
    for rows in r3_rows_prefix.ROWS:
        r = [to_u32(t).reshape(rows, -1) for t in r3_rows_prefix.rows_sort(s, rows)]
        assert r[0].shape[1] == -(-4000 // rows)
        assert (np.diff(r[0].astype(np.int64), axis=1) >= 0).all()
        pad = rows * r[0].shape[1] - 4000
        assert (r[0] == 0xFFFFFFFF).sum() == (pid == 0xFFFFFFFF).sum() + pad
        flat = np.stack([x.reshape(-1) for x in r], 1)
        flat = flat[~((flat[:, 0] == 0xFFFFFFFF) & (flat[:, 1] == 0) & (flat[:, 2] == 0))]
        keep = ~((pid == 0xFFFFFFFF) & (dep == 0) & (pay == 0))
        np.testing.assert_array_equal(np.sort(flat.view(rec), 0),
                                      np.sort(np.stack([pid, dep, pay], 1)[keep].view(rec), 0))
    rows4 = to_u32(probes.interleave(s))
    np.testing.assert_array_equal(rows4, np.stack([pid, dep, pay, np.zeros_like(pid)], 1))


def test_entry_points_raise_on_cpu_tensors():
    """Each new probe's launch and `run` raise on CPU tensors, before any
    build, and count no launch."""
    stream = _port(_small_stream(3))
    plane, sums = key_plane(SIZE, "cpu"), probes.new_sums("cpu")
    calls = [lambda: probes.launch_b6(r2_merge_tune.KERNEL, probes.B6(), stream, SIZE, plane,
                                      sums),
             lambda: probes.launch_b6(r3_merge_micro.KERNEL, probes.B6(groups=4, stages=2),
                                      stream, SIZE, plane, sums),
             lambda: r3_matscatter.heads("store-head", stream, SIZE, plane, sums),
             lambda: r3_rows_prefix.compact(stream, SIZE)]
    calls += [lambda run=m.run: run("cpu", stream, SIZE, "no card")
              for m in (r3_matscatter, r2_merge_tune, r3_kernel_floor, r3_build_v2,
                        r3_merge_micro, r3_merge_micro2, r3_rows_prefix)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert probes.build.cache_info().currsize == 0
    assert all(k.launches == 0 for k in probes.PROBES.values())
