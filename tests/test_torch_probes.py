"""The probes of `pcrhpg24_tpu_torch/experiments/` on the CPU.

Their kernels run only on a card, so this file holds what the card's
results are held to: the plain version of every exact variant against
the reference's B3 (the TPU path, `dense_from_sorted_rows` over
nk3-sorted rows in interpret mode) on the crafted chain and flat
streams of `tools/crafted.py`; the scatter probe's plain version against
`np.minimum.at` at the TPU probe's shapes; and each lesion's checksum
against a numpy emulation of the kernel's tiles.  The reference probes
(`experiments/*.py`) run their TPU work when imported, so none of them
can be called here: the reference for the scatter probe is numpy's.  It
also checks that importing the probe modules builds and launches
nothing and loads nothing of the JAX package, and that every probe entry
point raises on CPU tensors (a probe has no plain fallback).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu_torch.experiments import (exp_pallas_scatter_probe, probes, r3_mat_lesion,
                                            r4_floor, r4_winsize)
from pcrhpg24_tpu_torch.render.raster import key_plane
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SIZE = 49_152  # 48 swizzle tiles of 1024
N = 16 * 1024  # entries of a crafted stream: 4 rows of 4096 for the reference
STREAMS = [("chain", k) for k in ("ties", "sentinel")] + [("flat", k) for k in ("runs", "random")]


def _stream(layout: str, kind: str):
    if layout == "chain":
        return crafted.resolve_streams(kind, N // 1024, SIZE, seed=11)
    return crafted.flat_streams(kind, N, SIZE, seed=7)[:3]


def _parts(stream, cuts):
    return [tuple(from_u32(a[x:y]) for a in stream) for x, y in zip(cuts, cuts[1:])]


def _uneven(n: int, parts: int = 5, seed: int = 2):
    return crafted.flat_cuts(n, parts, seed=seed)


_REFERENCE = {}


def _reference_b3(stream):
    """The reference's B3 planes (u32): the TPU path over 4 nk3-sorted
    rows, in interpret mode (payloads below 2**24)."""
    from pcrhpg24_tpu.render.pallas_merge import dense_from_sorted_rows

    key = tuple(a.tobytes() for a in stream)
    if key not in _REFERENCE:
        rows = 4
        n = len(stream[0]) // rows
        sp, sd, sy = jax.lax.sort([jnp.asarray(a.reshape(rows, n)) for a in stream],
                                  num_keys=3, is_stable=False, dimension=1)
        _REFERENCE[key] = [np.asarray(x) for x in dense_from_sorted_rows(
            sp, sd, sy, SIZE, True, interpret=True, fully_sorted=True, pay_bits=24)]
    return _REFERENCE[key]


def _exact_plains():
    """(module, variant, plain version) of every exact probe variant."""
    out = [("r3_mat_lesion", v, fn) for v, fn in r3_mat_lesion.PLAIN.items()]
    out += [("r4_floor", v, fn) for v, fn in r4_floor.PLAIN.items()]
    out += [("r4_winsize", f"{layout}-{w}", r4_winsize.PLAIN)
            for layout, widths in r4_winsize.WIDTHS.items() for w in widths]
    return out


@pytest.mark.parametrize("layout,kind", STREAMS)
def test_exact_variants_plain_equal_reference_b3(layout, kind):
    """Every exact variant's plain version, on the stream in five uneven
    parts, equals the reference's B3 on the stream (no-load and nodma: on
    the entries the kernel makes, as one stream per part)."""
    stream = _stream(layout, kind)
    parts = _parts(stream, _uneven(N))
    made = probes.made_parts(parts, SIZE)
    made_stream = tuple(np.concatenate([to_u32(p[k]) for p in made]) for k in range(3))
    for module, variant, plain in _exact_plains():
        want = _reference_b3(made_stream if variant in ("no-load", "nodma") else stream)
        got = plain(parts, SIZE)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_u32(g), w, err_msg=f"{module} {variant}")


def test_made_parts_equal_numpy_hash():
    """`made_parts` computes probes.cuh's hash (u32 arithmetic, which
    numpy wraps natively) for each part's entries, the part's index in
    its launch group folded in."""
    def mix(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))

    sizes = [5, 0, 3000, 70]
    parts = [tuple(torch.zeros(n, dtype=torch.int32) for _ in range(3)) for n in sizes]
    made = probes.made_parts(parts, SIZE)
    assert len(made) == 3  # the empty part is not launched
    with np.errstate(over="ignore"):
        for k, (n, (pid, dep, pay)) in enumerate(zip([5, 3000, 70], made)):
            e = np.arange(n, dtype=np.uint32)
            h = mix(e + np.uint32((k * 0x9E3779B9) & 0xFFFFFFFF))
            np.testing.assert_array_equal(to_u32(pid), h % np.uint32(SIZE))
            np.testing.assert_array_equal(to_u32(dep), mix(h ^ np.uint32(0x5BD1E995)))
            np.testing.assert_array_equal(to_u32(pay), e)


def _tile_entries(n: int, layout: str, width: int) -> np.ndarray:
    """(tiles, 32 lanes, columns) entry indices the kernel's tiles load
    from a part of n entries: chain tiles of 32 rows x `width` columns of
    1024-entry rows, lane l holding row l; flat tiles of 512 consecutive
    entries, lane l holding 32 c + l."""
    if layout == "flat":
        t = np.arange(-(-n // 512))
        return t[:, None, None] * 512 + 32 * np.arange(16)[None, None, :] + \
            np.arange(32)[None, :, None]
    blocks = 1024 // width
    t = np.arange(-(-(-(-n // 1024)) // 32) * blocks)
    band, block = np.divmod(t, blocks)
    return (band[:, None, None] * 32 * 1024 + np.arange(32)[None, :, None] * 1024
            + (block * width)[:, None, None] + np.arange(width)[None, None, :])


def _emulated_floor(parts, layout: str, width: int) -> int:
    """numpy: XOR, tile by tile, of the words each lane loads (pid all
    ones, dep and pay 0 past a part's end)."""
    acc = np.uint32(0)
    for pid, dep, pay in parts:
        words = [to_u32(x) for x in (pid, dep, pay)]
        n = len(words[0])
        if not n:
            continue
        e = _tile_entries(n, layout, width)
        got = [np.where(e < n, w[np.minimum(e, n - 1)], fill)
               for w, fill in zip(words, (0xFFFFFFFF, 0, 0))]
        acc ^= np.bitwise_xor.reduce((got[0] ^ got[1] ^ got[2]).astype(np.uint32), axis=None)
    return int(acc)


@pytest.mark.parametrize("layout,kind", STREAMS)
def test_lesion_checksums_plain_equal_numpy(layout, kind):
    """floor (every width), no-atomic and noop: the plain checksum of the
    stream in 5 and in 70 uneven parts (a launch takes 64) equals numpy's
    emulation of the kernel's tiles."""
    stream = _stream(layout, kind)
    pid, dep, pay = stream
    for cuts in (_uneven(N), _uneven(N, 70, seed=3)):
        parts = _parts(stream, cuts)
        for lay, width in (("chain", 16), ("chain", 8), ("chain", 4), ("flat", 8)):
            assert probes.floor_plain(parts, lay, width) == _emulated_floor(parts, lay, width)
        live = (pid < SIZE) & ~((dep == 0xFFFFFFFF) & (pay == 0xFFFFFFFF))
        assert probes.would_be_plain(parts, SIZE) == int(live.sum())
        noop = 0
        for k, (x, y) in enumerate(zip(cuts, cuts[1:])):
            tiles = np.arange(len(_tile_entries(y - x, "chain", 16)), dtype=np.int64)
            noop ^= int(np.bitwise_xor.reduce(tiles ^ ((k % 64) << 24)))
        assert probes.noop_plain(parts, "chain", 16) == noop
    if kind == "sentinel":  # dead entries count for nothing
        assert probes.would_be_plain(_parts(stream, [0, N]), SIZE) < N


def test_folded_slots():
    """The checksum words: XOR (floor, noop) or u32 sum of the slots."""
    sums = torch.zeros(probes.SLOTS * probes.SLOT_PITCH, dtype=torch.int32)
    vals = np.random.default_rng(0).integers(0, 2**32, probes.SLOTS, dtype=np.uint64)
    sums[::probes.SLOT_PITCH] = from_u32(vals.astype(np.uint32))
    assert probes.folded(sums, "floor") == int(np.bitwise_xor.reduce(vals.astype(np.uint32)))
    assert probes.folded(sums, "count") == int(vals.sum()) & 0xFFFFFFFF
    assert probes.xor_reduce(torch.tensor([], dtype=torch.int64)) == 0


def test_scatter_plain_equals_minimum_at():
    """The scatter probe's plain version at the TPU probe's shapes (8192
    int32 min-stores into a 2048 x 128 int32 tile), and on u64 keys, equals
    `np.minimum.at`; a flip perturbs the low bit of every value."""
    sp = exp_pallas_scatter_probe
    words = sp.ROWS * sp.COLS
    idx, val = sp.inputs(sp.N, words, False, seed=0, device="cpu")
    for flip in (0, 1):
        got = sp.scatter_min_plain(idx, val, sp.empty_plane(words, False, "cpu"), flip)
        want = np.full(words, 2**31 - 1, np.int32)
        np.minimum.at(want, idx.numpy(), val.numpy() ^ flip)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < 2**31 - 1).sum() > 7000  # the stores landed
    idx, val = sp.inputs(50_000, 3_000, True, seed=1, device="cpu")
    got = sp.scatter_min_plain(idx, val, sp.empty_plane(3_000, True, "cpu"))
    want = np.full(3_000, 2**64 - 1, np.uint64)
    np.minimum.at(want, idx.numpy(), val.numpy().view(np.uint64))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert [c[1:4] for c in sp.cases([100])][:3] == [(8192, words, False)] * 3


def test_import_launches_nothing():
    """Importing every probe module (as `test_torch_imports` walks them)
    builds nothing, launches nothing and loads nothing of the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import pcrhpg24_tpu_torch.experiments as ex
        names = [m.name for m in pkgutil.iter_modules(ex.__path__, ex.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from pcrhpg24_tpu_torch.experiments import probes
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "pcrhpg24_tpu"))
        assert not bad, bad
        assert probes.build.cache_info().currsize == 0
        assert probes.load.cache_info().currsize == 0
        assert sorted(probes.PROBES) == ["pcr_probe_b1", "pcr_probe_b5", "pcr_probe_b6",
                                         "pcr_probe_combine",
                                         "pcr_probe_compact", "pcr_probe_corient",
                                         "pcr_probe_floor", "pcr_probe_gather",
                                         "pcr_probe_heads", "pcr_probe_lesion",
                                         "pcr_probe_narrow", "pcr_probe_parity",
                                         "pcr_probe_perm", "pcr_probe_pwin",
                                         "pcr_probe_scatter", "pcr_probe_winsize"]
        assert all(k.launches == 0 for k in probes.PROBES.values())
        print("ok", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "23"]


def test_entry_points_raise_on_cpu_tensors():
    """Each probe's launch and `run` raise on CPU tensors, before any
    build, and count no launch."""
    stream = _stream("flat", "random")
    parts = _parts(stream, [0, N])
    plane, sums = key_plane(SIZE, "cpu"), probes.new_sums("cpu")
    with pytest.raises(ValueError):
        r3_mat_lesion.lesion(parts, SIZE, "flat", "full", plane, sums)
    with pytest.raises(ValueError):
        r4_floor.anatomy(parts, SIZE, "noop", plane, sums)
    with pytest.raises(ValueError):
        r4_winsize.winsize(parts, SIZE, "chain", 8, plane, sums)
    for run in (r3_mat_lesion.run, r4_floor.run, r4_winsize.run):
        with pytest.raises(ValueError):
            run("cpu", parts, SIZE, "no card")
    sp = exp_pallas_scatter_probe
    idx, val = sp.inputs(64, 128, True, device="cpu")
    with pytest.raises(ValueError):
        sp.scatter_min(idx, val, sp.empty_plane(128, True, "cpu"), 1, 32)
    with pytest.raises(ValueError):
        sp.run("no card", (64,), device="cpu")
    assert probes.build.cache_info().currsize == 0
    assert all(k.launches == 0 for k in probes.PROBES.values())
