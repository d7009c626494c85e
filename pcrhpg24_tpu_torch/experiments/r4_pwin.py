"""B3's tiles cut per part against tiles cut at fixed positions: the
card's counterpart of the TPU probe `experiments/r4_pwin.py` (pallas_calls
at :322, the production merge on its window table, and :373, fixed
1024-entry position windows).

The TPU probe replaced its merge's per-(row, tile) windows, which need a
window table built every frame, by windows at fixed positions of the
stream, each scattering to every tile of its program.  The card's B3
(`csrc/raster.cu`) cuts its tiles per part (`tiles::make_parts`, on the
host, from the parts' entry counts): a part's last tile is padded, and a
warp finds its tile's part by a walk over the launch's parts
(`tiles::part_of`).  The card builds no window table, so the TPU probe's
"table" time has no counterpart here; the tile counts are reckoned on
the host (`pcr_probe_pwin_tiles`, held to `tiles_plain`).  `r4_pwin.cu`
builds the full kernel (`probes.cuh`'s b3_probe) with both tilings, in
both layouts at the shipped widths:

- per-part (the baseline that :322 stands for): the shipped tiles, timed
  in turns with the shipped `u64_min_planes` (within 3%);
- position: tiles cut at fixed positions of a launch's parts laid end to
  end: 32-row bands of their rows (chain; a part's last row may still
  end early) or 512-entry runs of their entries (flat).  Each row or
  entry walks forward to its own part, so a tile may read from several
  parts, and no tile is padded at a part's end.

Each tiling is held bit-exact to `u64_min_planes_plain` and timed in
turns (one launch alone each, from an EMPTY plane); the dead entries a
tiling reads are its tiles' entries less the parts'.  On a host with a
card:

    python -m pcrhpg24_tpu_torch.experiments.r4_pwin \\
        [--scene out/chip_smoke_256_v2.tpc --scene out/chip_smoke_256.las] [--view orbit]

(`chip_smoke.py` runs it on the orbit chunk, the orbit frame's 4 colour
parts, the `.las` orbit part and the Potree steady parts.)
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from ..kernels.build import MAX_PARTS, I, L, P
from ..render.raster import key_plane, key_views, u64_min_planes, u64_min_planes_plain
from . import probes

PWIN = probes.probe_kernel("pcr_probe_pwin", probes.B3_FORM_ARGS)
TILINGS = {"per-part": "staged", "position": "position"}  # tiling -> b3_probe's form
PLAIN = {t: u64_min_planes_plain for t in TILINGS}  # every tiling's plain version
SHIPPED_TOLERANCE = 0.03  # per-part against the shipped kernel, same call
COLUMNS = 16  # a chain tile's columns


def pwin(parts, size: int, layout: str, tiling: str, plane, sums) -> None:
    """One launch of the full kernel in `layout`, its tiles cut by
    `tiling`."""
    probes.launch_b3(PWIN, parts, size, layout, "full", probes.SHIPPED_WIDTH[layout], plane,
                     sums, TILINGS[tiling])


def groups(ns: list) -> list:
    """The entry counts of each launch: the non-empty parts, 64 a launch."""
    live = [n for n in ns if n]
    return [live[k:k + MAX_PARTS] for k in range(0, len(live), MAX_PARTS)]


def slots(layout: str) -> int:
    """Entries of a tile: a chain tile's 32 rows x 16 columns, a flat
    tile's 512."""
    return probes.FLAT_TILE if layout == "flat" else 32 * COLUMNS


def tiles_plain(ns: list, layout: str, tiling: str) -> int:
    """Tiles the launches over parts of `ns` entries read: per part, the
    shipped count (`probes.tiles_of`); by position, 32-row bands x 64
    column blocks of each launch's rows, or 512-entry runs of its
    entries."""
    total = 0
    for g in groups(ns):
        if tiling == "per-part":
            total += sum(probes.tiles_of(n, layout, probes.SHIPPED_WIDTH[layout]) for n in g)
        elif layout == "chain":
            rows = sum(-(-n // probes.ROW) for n in g)
            total += -(-rows // 32) * (probes.ROW // COLUMNS)
        else:
            total += -(-sum(g) // probes.FLAT_TILE)
    return total


def card_tiles(ns: list, layout: str, tiling: str) -> int:
    """The tiles the kernel's launches read, as its host code counts them
    (`pcr_probe_pwin_tiles`)."""
    fn = probes.load().pcr_probe_pwin_tiles
    fn.restype, fn.argtypes = L, [I, I, P, I]
    total = 0
    for g in groups(ns):
        arr = (ctypes.c_longlong * len(g))(*g)
        got = fn(probes.LAYOUTS[layout], probes.FORMS[TILINGS[tiling]], ctypes.addressof(arr),
                 len(g))
        if got < 0:
            raise RuntimeError(f"pcr_probe_pwin_tiles refused {len(g)} parts")
        total += got
    return total


def position_slots(ns: list, layout: str) -> torch.Tensor:
    """The plain version of the position tiles' reads: for one launch over
    parts of `ns` entries (1..64, non-empty), each tile's entries as
    (tiles, 32 lanes, 16 columns) indices into the parts' entries laid end
    to end, -1 where a slot reads nothing (past a part's end or the last
    row).  Chain: tile t is band t // 64 of the parts' rows, lane r its
    row 32 (t // 64) + r, column c entry 16 (t % 64) + c of that row; flat:
    lane l, column c is entry 512 t + 32 c + l."""
    n = torch.tensor(ns, dtype=torch.int64)
    first = torch.cat([n.new_zeros(1), n.cumsum(0)])  # each part's first entry
    t = torch.arange(tiles_plain(ns, layout, "position"), dtype=torch.int64)
    lane = torch.arange(32, dtype=torch.int64)
    col = torch.arange(COLUMNS, dtype=torch.int64)
    if layout == "flat":
        g = t[:, None, None] * probes.FLAT_TILE + 32 * col[None, None, :] + lane[None, :, None]
        return torch.where(g < first[-1], g, torch.full_like(g, -1))
    rows = -(-n // probes.ROW)
    row0 = torch.cat([rows.new_zeros(1), rows.cumsum(0)])  # each part's first row
    blocks = probes.ROW // COLUMNS
    g = (t[:, None, None] // blocks) * 32 + lane[None, :, None]  # the slot's row
    p = torch.searchsorted(row0[1:], g, right=True).clamp(max=len(ns) - 1)
    e = (g - row0[p]) * probes.ROW + (t[:, None, None] % blocks) * COLUMNS + col
    ok = (g < row0[-1]) & (e < n[p])
    return torch.where(ok, first[p] + e, torch.full_like(e, -1))


def run(label: str, parts, size: int, card: str, reps: int = 20) -> dict:
    """Both tilings in both layouts on `parts`: held bit-exact to the plain
    version, their tile counts to `tiles_plain`, then timed in turns with
    the shipped kernel -> {(layout, tiling): dict(ms, tiles, dead)} and
    {(layout, "shipped"): ms}; prints a `[probe]` line for each; raises if
    a check fails or per-part is more than 3% off the shipped kernel."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    want = u64_min_planes_plain(parts, size)
    plane, sums = key_plane(size, device), probes.new_sums(device)
    ns = [p[0].numel() for p in parts]
    out = {}
    for layout in ("chain", "flat"):
        for tiling in TILINGS:
            plane.fill_(-1)
            pwin(parts, size, layout, tiling, plane, sums)
            if not all(g.equal(w) for g, w in zip(key_views(plane), want)):
                raise AssertionError(f"r4_pwin {tiling} on {label} ({layout}) != its plain "
                                     f"version")
            tiles = card_tiles(ns, layout, tiling)
            if tiles != tiles_plain(ns, layout, tiling):
                raise AssertionError(f"r4_pwin {tiling} on {label} ({layout}): {tiles:,} tiles "
                                     f"!= the plain count {tiles_plain(ns, layout, tiling):,}")
            out[(layout, tiling)] = dict(tiles=tiles, dead=tiles * slots(layout) - sum(ns))
        fns = [lambda t=t, layout=layout: pwin(parts, size, layout, t, plane, sums)
               for t in TILINGS]
        fns.append(lambda layout=layout: u64_min_planes(parts, size, plane=plane, layout=layout))
        times = [statistics.median(t) for t in probes.paired_ms(fns, reps,
                                                                  lambda: plane.fill_(-1))]
        for tiling, ms in zip(TILINGS, times):
            out[(layout, tiling)]["ms"] = ms
        out[(layout, "shipped")] = times[-1]
        base = out[(layout, "per-part")]
        off = base["ms"] / times[-1] - 1
        for tiling in TILINGS:
            r = out[(layout, tiling)]
            print(f"[probe] r4_pwin {tiling} {label} ({layout} layout, {len(parts)} parts, "
                  f"{sum(ns):,} entries): {r['ms']:.4f} ms device, one launch alone in turns, "
                  f"{r['ms'] / base['ms']:.2f}x per-part; {r['tiles']:,} tiles, "
                  f"{r['dead']:,} dead entries read; bit-exact [{card}]")
        print(f"[probe] r4_pwin per-part {label} ({layout} layout): shipped u64_min_planes "
              f"{times[-1]:.4f} ms ({off:+.1%}) [{card}]")
        if abs(off) > SHIPPED_TOLERANCE:
            raise AssertionError(f"r4_pwin per-part {label} ({layout}): {base['ms']:.4f} ms is "
                                 f"{off:+.1%} off the shipped kernel's {times[-1]:.4f}")
    return out


def main(argv=None) -> int:
    return probes.parts_main("r4_pwin", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
