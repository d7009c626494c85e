"""B6's instruction cuts, each exact: the card's counterpart of the TPU
probe `experiments/r3_merge_micro2.py` (pallas_call at :289).

The TPU probe cut ops out of its merge (`make_kernel(bprobe, lanesfx,
sharedg, steps)`), each exact: constant-position first probes, a
lane-only suffix-min, gathers sharing masks, all of them, and all at 4
steps.  The card's B6 (`csrc/merge.cuh`) has no probes or gathers; its
work is the heads' ballot, five 64-bit doubling shuffles and the
atomics.  `r2_merge_tune.cu`'s `pcr_probe_b6` builds it with each cut,
on the stream sorted by pid:

- uniform: a warp that is one run (one head bit) takes two
  `__reduce_min_sync`s (the depth, then the payload among the lanes at
  that depth) in place of the five 64-bit shuffles;
- distinct: a warp whose lanes all head a segment skips the scan;
- early: the doubling steps stop once no lane has a partner left
  (`__any_sync`);
- gather-first: a head reads its plane word and issues no atomicMin that
  cannot win, as B3 does;
- all: every cut at once; all-4: all at 4 steps, run only where the
  stream's longest warp-local run (`probes.warp_runs_plain`) is 16 or
  less;
- count and count-gather-first: full and gather-first counting the
  atomics they issue: count is one for each live warp-local head
  (`probes.count_plain`); gather-first's depends on the order warps run
  in, and is held between the landed pixels and that.

Every cut is held bit-exact to `u64_min_planes_plain`; full is timed in
turns with the shipped `pcr_merge_nk1` (within 3%).  Printed: each cut's
share of full, the warps each cut applies to (`probes.warp_shapes`) and
the atomics gather-first saves.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_merge_micro2 \\
        [--scene parametric --scene out/chip_smoke_256.wg --scene out/chip_smoke_256.las]

(`chip_smoke.py` runs it on the parametric near stream, the `.wg` orbit
stream and the `.las` orbit part.)
"""

from __future__ import annotations

import sys

from ..render.raster import sort_by_pid, u64_min_planes_plain
from . import probes
from .probes import B6
from .r2_merge_tune import KERNEL

ALL = ("uniform", "distinct", "early", "gather-first")
VARIANTS = {"full": B6(), **{c: B6(cuts=(c,)) for c in ALL}, "all": B6(cuts=ALL),
            "all-4": B6(steps=4, cuts=ALL), "count": B6(lesion="count"),
            "count-gather-first": B6(lesion="count", cuts=("gather-first",))}
# the exact cuts' plain versions, (pid-sorted stream, size) -> planes
# (all-4: where the runs allow 4 steps)
PLAIN = {v: lambda s, size: u64_min_planes_plain([s], size)
         for v in ("full", *ALL, "all", "all-4")}


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """Every cut on `stream` (unsorted int32 CUDA tensors) sorted by pid,
    held to its plain version, then timed; prints a `[probe]` line for
    each and the atomics saved; raises on a mismatch or if full is more
    than 3% off the shipped kernel.  -> {variant: ms, "shipped": ms,
    "atomics": full's, "atomics gather-first": gather-first's}."""
    probes.require_cuda([stream])
    s = sort_by_pid(*stream)
    shapes = probes.warp_shapes(s, size)
    variants = {v: b for v, b in VARIANTS.items() if v != "all-4" or shapes["runs"] <= 16}
    exact = PLAIN["full"](s, size)
    count = probes.count_plain(s, size)
    landed = probes.landed_pixels(exact)
    expect = {**{v: exact for v in PLAIN if v in variants}, "count": count,
              "count-gather-first": (landed, count)}
    res = probes.run_b6("r3_merge_micro2", KERNEL, label, s, size, variants, expect, reps)
    for v in variants:
        print(f"[probe] r3_merge_micro2 {v} {label}: {res[v]:.4f} ms device, one launch alone, "
              f"{res[v] / res['full']:.2f}x full [{card}]")
    saved = res["count sum"] - res["count-gather-first sum"]
    w = shapes["warps"]
    print(f"[probe] r3_merge_micro2 {label} ({s[0].numel():,} entries, {w:,} warps): uniform "
          f"warps {shapes['uniform']:,} ({shapes['uniform'] / w:.3f}), distinct "
          f"{shapes['distinct']:,} ({shapes['distinct'] / w:.3f}); longest warp-local run "
          f"{shapes['runs']}{'' if 'all-4' in variants else ', so all-4 is not run'}; atomics "
          f"{res['count sum']:,}, with gather-first {res['count-gather-first sum']:,} "
          f"({saved:,} saved; {landed:,} landed pixels); full {res['full']:.4f} ms (shipped "
          f"{res['shipped']:.4f}) [{card}]")
    return dict(res, atomics=res["count sum"], **{"atomics gather-first":
                                                    res["count-gather-first sum"]})


def main(argv=None) -> int:
    return probes.b6_main("r3_merge_micro2", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
