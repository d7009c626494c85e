"""Which stage of B3 takes the time: the card's counterpart of the TPU
probe `experiments/r3_mat_lesion.py` (pallas_call at :255).

The TPU probe cut stages out of its matscatter merge (one-hot builds,
dot chain, window update) and timed what was left.  The card's B3
(`csrc/raster.cu`) has no windows or one-hots: each warp reads a tile
of the stream, gathers each entry's plane word, compares, and issues an
atomicMin for a key below the word.  `r3_mat_lesion.cu` re-states that
body (`probes.cuh`) with a lesion as a template value, in both layouts
at their shipped widths:

- full: the shipped kernel, held bit-exact to `u64_min_planes_plain`
  and timed in turns with the shipped `u64_min_planes` (within 3%, or
  the lesions' times do not stand for the shipped kernel's);
- atomic-all: an atomicMin for every live entry, no gather, no compare
  (exact, held the same way);
- no-atomic: stream read, gather and compare; its count of would-be
  atomics is held to `probes.would_be_plain`;
- floor: the stream read alone; its XOR of the loaded words is held to
  `probes.floor_plain`;
- no-load: gather, compare and atomic on entries made in registers from
  a hash of their index (the counterpart of `r4_floor`'s nodma), held
  bit-exact to the plain version on `probes.made_parts`;
- count: full, counting the atomics it issues: the share of live
  entries whose compare lets them through (between the landed pixels
  and the no-atomic count).

Each timed launch starts from an EMPTY plane (reset outside the
events).  The split of a part's time: stream read = floor; gather and
compare = no-atomic - floor; atomics = full - no-atomic.  On a host with
a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_mat_lesion \\
        [--scene out/chip_smoke_256_v2.tpc --scene out/chip_smoke_256.las] [--view orbit]

(`chip_smoke.py` runs it on the orbit chunk, the orbit frame's colour
parts, the `.las` orbit part and the Potree steady parts.)
"""

from __future__ import annotations

import statistics
import sys

import torch

from ..render.raster import key_plane, key_views, u64_min_planes, u64_min_planes_plain
from . import probes

LESION = probes.probe_kernel("pcr_probe_lesion", probes.B3_ARGS)
VARIANTS = ("full", "atomic-all", "no-atomic", "floor", "no-load", "count")
# the plain versions: of the planes of the exact variants, (parts, size)
# -> planes, and of the checksums, (parts, size, layout) -> u32 value
PLAIN = {"full": u64_min_planes_plain, "atomic-all": u64_min_planes_plain,
         "count": u64_min_planes_plain,
         "no-load": lambda parts, size: u64_min_planes_plain(probes.made_parts(parts, size),
                                                             size)}
CHECKSUMS = {"no-atomic": lambda parts, size, layout: probes.would_be_plain(parts, size),
             "floor": lambda parts, size, layout: probes.floor_plain(
                 parts, layout, probes.SHIPPED_WIDTH[layout])}
SHIPPED_TOLERANCE = 0.03  # full against the shipped kernel, same call


def lesion(parts, size: int, layout: str, variant: str, plane, sums) -> None:
    """One launch of `variant` in `layout` (at its shipped width)."""
    probes.launch_b3(LESION, parts, size, layout, variant, probes.SHIPPED_WIDTH[layout],
                     plane, sums)


def run(label: str, parts, size: int, card: str, reps: int = 20) -> dict:
    """Every variant in both layouts on `parts` (int32 CUDA tensors),
    each held to its plain version, then timed (one launch alone, device
    ms, median of `reps`); prints a `[probe]` line for each and the
    split; raises if a variant disagrees or full is more than 3% off the
    shipped kernel.  -> {layout: {variant: ms, "shipped": ms, "atomics":
    issued, "live": entries, "landed": pixels, "would_be": count}}."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    wants = {fn: fn(parts, size) for fn in set(PLAIN.values())}
    want = wants[u64_min_planes_plain]
    plane, sums = key_plane(size, device), probes.new_sums(device)
    live = probes.live_entries(parts, size)
    landed = probes.landed_pixels(want)
    would_be = probes.would_be_plain(parts, size)
    n = sum(p[0].numel() for p in parts)

    def reset():
        plane.fill_(-1)
        sums.zero_()

    out = {}
    for layout in ("chain", "flat"):
        res = dict(live=live, landed=landed, would_be=would_be)
        for v in VARIANTS:  # each once, held to its plain version
            reset()
            lesion(parts, size, layout, v, plane, sums)
            if v in PLAIN and not all(torch.equal(g, w) for g, w in
                                      zip(key_views(plane), wants[PLAIN[v]])):
                raise AssertionError(f"r3_mat_lesion {v} on {label} ({layout}) != its plain "
                                     f"version")
            if v in CHECKSUMS and probes.folded(sums, v) != CHECKSUMS[v](parts, size, layout):
                raise AssertionError(f"r3_mat_lesion {v} on {label} ({layout}): checksum "
                                     f"{probes.folded(sums, v)} != the plain version's "
                                     f"{CHECKSUMS[v](parts, size, layout)}")
            if v == "count":
                res["atomics"] = probes.folded(sums, v)
        for v in VARIANTS[1:]:
            res[v] = probes.time_ms(lambda v=v: lesion(parts, size, layout, v, plane, sums),
                                    reps, reset)
        full, shipped = probes.paired_ms(
            [lambda: lesion(parts, size, layout, "full", plane, sums),
             lambda: u64_min_planes(parts, size, plane=plane, layout=layout)], reps, reset)
        res["full"], res["shipped"] = statistics.median(full), statistics.median(shipped)
        off = res["full"] / res["shipped"] - 1
        for v in VARIANTS:
            print(f"[probe] r3_mat_lesion {v} {label} ({layout} layout): {res[v]:.4f} ms "
                  f"device, one launch alone, {res[v] / res['full']:.2f}x full [{card}]")
        read, gather = res["floor"], res["no-atomic"] - res["floor"]
        atomics = res["full"] - res["no-atomic"]
        print(f"[probe] r3_mat_lesion split {label} ({layout} layout, {n:,} entries, "
              f"{live:,} live): full {res['full']:.4f} ms (shipped u64_min_planes "
              f"{res['shipped']:.4f}, {off:+.1%}) = stream read {read:.4f} + gather and "
              f"compare {gather:.4f} + atomics {atomics:.4f}; atomic-all "
              f"{res['atomic-all']:.4f}, no-load {res['no-load']:.4f} (full - no-load "
              f"{res['full'] - res['no-load']:.4f}); atomics issued {res['atomics']:,} "
              f"({res['atomics'] / max(live, 1):.4f} of live entries; at least "
              f"{landed:,} landed pixels, at most {would_be:,}) [{card}]")
        if not landed <= res["atomics"] <= would_be:
            raise AssertionError(f"r3_mat_lesion count ({layout}): {res['atomics']} atomics "
                                 f"outside [{landed}, {would_be}]")
        if abs(off) > SHIPPED_TOLERANCE:
            raise AssertionError(f"r3_mat_lesion full {label} ({layout}): {res['full']:.4f} "
                                 f"ms is {off:+.1%} off the shipped kernel's "
                                 f"{res['shipped']:.4f}")
        out[layout] = res
    return out


def main(argv=None) -> int:
    return probes.parts_main("r3_mat_lesion", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
