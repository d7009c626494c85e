"""A warp's same-pixel keys combined before the atomicMin: the card's
counterpart of the TPU probe `experiments/r3_flushacc.py` (pallas_call at
:263).

The TPU probe folded each window's result into one accumulator pair and
flushed it on a tile change, instead of updating every tile's
accumulators.  The card's B3 (`csrc/raster.cu`) has one atomicMin for
each key below its gathered plane word; on Potree's parts those atomics
ran at 44-46 G/s against the 77-78 of random ones (`r3_mat_lesion`,
`exp_pallas_scatter_probe`).  The question here: do lanes of one warp
that hit one pixel cost that?
`r3_flushacc.cu` builds B3's body (`probes.cuh`'s b3_probe) with its
compare-then-atomicMin combined within the warp (`combine`): for each
column of the tile, `__match_any_sync` groups the lanes of one pid, two
`__reduce_min_sync` give the group's least depth and the least payload at
that depth, and the lowest lane of the group alone issues one atomicMin,
if that key is below its gathered word.  Beside it, in both layouts at
the shipped widths:

- full, no-atomic and count: the shipped compare-then-atomicMin, its
  would-be atomics against an EMPTY plane (`probes.would_be_plain`) and
  the atomics it issues;
- combine-count: combine, counting the atomics it issues, which depends
  on the order the tiles run in: held between the landed pixels and the
  groups;
- combine-would-be: combine against a plane that stays EMPTY, counting
  the (tile, column, pid) groups of live entries with a key below all
  ones: deterministic, held to `groups_plain`.

Every exact variant is held bit-exact to `u64_min_planes_plain`, then all
six are timed in turns (one launch alone each, from an EMPTY plane).
The atomics' time is full - no-atomic (combine - combine-would-be), and
their rate the atomics issued over it; combine-would-be - no-atomic is
what the match and the two reduces cost.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_flushacc \\
        [--scene out/chip_smoke_256_v2.tpc --scene out/chip_smoke_256.las] [--view orbit]

(`chip_smoke.py` runs it on the orbit chunk and the orbit frame's 4
colour parts in the chain layout, the `.las` orbit part and the Potree
steady parts in the flat one.)
"""

from __future__ import annotations

import statistics
import sys

import torch

from ..render.raster import key_plane, key_views, u64_min_planes_plain
from ..u32 import widen
from . import probes

COMBINE = probes.probe_kernel("pcr_probe_combine", probes.B3_FORM_ARGS)
VARIANTS = ("full", "no-atomic", "count", "combine", "combine-would-be", "combine-count")
PLAIN = {"full": u64_min_planes_plain, "count": u64_min_planes_plain,
         "combine": u64_min_planes_plain, "combine-count": u64_min_planes_plain}
COUNTS = ("no-atomic", "count", "combine-would-be", "combine-count")
COLUMNS = 16  # columns of a tile in either layout (a flat tile: 16 passes of 32)


def combine(parts, size: int, layout: str, variant: str, plane, sums) -> None:
    """One launch of `variant` in `layout` at its shipped width."""
    probes.launch_b3(COMBINE, parts, size, layout, variant, probes.SHIPPED_WIDTH[layout],
                     plane, sums, "staged")


def tile_columns(n: int, layout: str, device=None) -> torch.Tensor:
    """For each entry of a part of n entries, tile * 16 + the column of
    the warp's tile that holds it: flat, tile e // 512, column (e % 512)
    // 32 (lane e % 32); chain, the 32-row x 16-column tile (e // 32768) *
    64 + (e % 1024) // 16, column e % 16 (lane: the row in the band)."""
    e = torch.arange(n, dtype=torch.int64, device=device)
    if layout == "flat":
        return (e // probes.FLAT_TILE) * COLUMNS + (e % probes.FLAT_TILE) // 32
    tile = (e // (32 * probes.ROW)) * (probes.ROW // COLUMNS) + (e % probes.ROW) // COLUMNS
    return tile * COLUMNS + e % COLUMNS


def groups_plain(parts, size: int, layout: str) -> int:
    """combine-would-be's count: the distinct (part, tile, column, pid)
    groups of live entries (pid < size) with a key below all ones."""
    count = 0
    for pid, dep, pay in probes.live_parts(parts):
        q = widen(pid.reshape(-1))
        ok = (q < size) & ~((dep.reshape(-1) == -1) & (pay.reshape(-1) == -1))
        key = (tile_columns(q.numel(), layout, q.device) << 32) | q
        count += int(torch.unique(key[ok]).numel())
    return count


def run(label: str, parts, size: int, card: str, layout: str = "chain", reps: int = 20) -> dict:
    """Every variant in `layout` on `parts`: the exact ones held to the
    plain version, the counts to theirs or between their bounds, then all
    timed in turns -> {variant: ms, and the counts: "atomics",
    "combined_atomics", "groups", "would_be", "live", "landed"}; prints
    `[probe]` lines; raises if a check fails."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    want = u64_min_planes_plain(parts, size)
    plane, sums = key_plane(size, device), probes.new_sums(device)
    res = dict(live=probes.live_entries(parts, size), landed=probes.landed_pixels(want),
               would_be=probes.would_be_plain(parts, size),
               groups=groups_plain(parts, size, layout))

    def reset():
        plane.fill_(-1)
        sums.zero_()

    got = {}
    for v in VARIANTS:
        reset()
        combine(parts, size, layout, v, plane, sums)
        if v in PLAIN and not all(g.equal(w) for g, w in zip(key_views(plane), want)):
            raise AssertionError(f"r3_flushacc {v} on {label} ({layout}) != its plain version")
        if v in COUNTS:
            got[v] = probes.folded(sums, "count")
    bounds = {"no-atomic": (res["would_be"],) * 2, "combine-would-be": (res["groups"],) * 2,
              "count": (res["landed"], res["would_be"]),
              "combine-count": (res["landed"], res["groups"])}
    for v, (lo, hi) in bounds.items():
        if not lo <= got[v] <= hi:
            raise AssertionError(f"r3_flushacc {v} on {label} ({layout}): {got[v]:,} outside "
                                 f"[{lo:,}, {hi:,}]")
    res["atomics"], res["combined_atomics"] = got["count"], got["combine-count"]
    fns = [lambda v=v: combine(parts, size, layout, v, plane, sums) for v in VARIANTS]
    for v, t in zip(VARIANTS, probes.paired_ms(fns, reps, reset)):
        res[v] = statistics.median(t)
    shipped_at = res["full"] - res["no-atomic"]
    combined_at = res["combine"] - res["combine-would-be"]
    res["match"] = res["combine-would-be"] - res["no-atomic"]  # match and reduces
    for v in VARIANTS:
        print(f"[probe] r3_flushacc {v} {label} ({layout} layout): {res[v]:.4f} ms device, one "
              f"launch alone in turns, {res[v] / res['full']:.2f}x full [{card}]")
    print(f"[probe] r3_flushacc split {label} ({layout} layout, {res['live']:,} live entries, "
          f"{res['landed']:,} landed pixels): full {res['full']:.4f} ms, {res['atomics']:,} "
          f"atomics ({res['would_be']:,} would-be) in {shipped_at:.4f} ms, "
          f"{res['atomics'] / max(shipped_at, 1e-9) / 1e6:.1f} G/s; combine "
          f"{res['combine']:.4f} ms ({res['combine'] / res['full']:.2f}x), "
          f"{res['combined_atomics']:,} atomics "
          f"({res['combined_atomics'] / max(res['atomics'], 1):.3f} of full's) from "
          f"{res['groups']:,} groups ({res['groups'] / max(res['live'], 1):.3f} "
          f"of live entries) in {combined_at:.4f} ms, "
          f"{res['combined_atomics'] / max(combined_at, 1e-9) / 1e6:.1f} G/s; the match and "
          f"two reduces (combine-would-be - no-atomic) {res['match']:.4f} ms; bit-exact "
          f"[{card}]")
    return res


def main(argv=None) -> int:
    return probes.parts_main("r3_flushacc", run, __doc__, argv, layout=True)


if __name__ == "__main__":
    sys.exit(main())
