"""B6's scan at each depth: the card's counterpart of the TPU probe
`experiments/r3_build_v2.py` (pallas_call at :118).

The TPU probe built its window tables a faster way (the v2 build:
clipped 2D boxes and a sort-free expansion) and timed the merge
(`pm._merge_nk1_kernel_ilp`) at 10 and at 6 suffix-min steps, where the
stream's runs allow 6.  The table build is XLA, not Pallas, and has no
counterpart here: the port's B6 takes the pid-sorted stream itself and
builds no table.  What carries over is the scan's depth.
`r2_merge_tune.cu`'s `pcr_probe_b6` builds B6 (`csrc/merge.cuh`) at 0 to
5 doubling steps (5: the shipped kernel), run on the stream sorted by
pid:

- the stream's longest run segment of a live pid within an aligned warp
  of 32 entries is `probes.warp_runs_plain` (the card's
  `pm._runs_bounded`, pallas_merge.py:662); a depth whose 2**steps
  covers it is held bit-exact to `u64_min_planes_plain`;
- a shallower depth is held to `probes.truncated_plain(steps)`: each
  warp-local head takes the min of the first 2**steps entries of its
  segment;
- steps 5 is full, timed in turns with the shipped `pcr_merge_nk1`
  (within 3%).

On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_build_v2 \\
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

STEPS = range(6)
VARIANTS = {("full" if k == 5 else f"steps {k}"): B6(steps=k) for k in STEPS}


def plain(s, size: int, steps: int):
    """The planes of B6 at `steps` on the pid-sorted stream `s`."""
    return probes.truncated_plain(s, size, steps)


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """B6 at each depth on `stream` (unsorted int32 CUDA tensors) sorted by
    pid: held to `u64_min_planes_plain` where the depth covers the
    stream's longest warp-local run, to `truncated_plain` below it; then
    timed; prints a `[probe]` line for each; raises on a mismatch or if
    full is more than 3% off the shipped kernel.  -> {variant: ms,
    "shipped": ms, "runs": the longest run, "need": steps it needs}."""
    probes.require_cuda([stream])
    s = sort_by_pid(*stream)
    runs = probes.warp_runs_plain(s[0], size)
    need = probes.steps_needed(runs)
    exact = u64_min_planes_plain([s], size)
    expect = {v: exact if b.steps >= need else plain(s, size, b.steps)
              for v, b in VARIANTS.items()}
    res = probes.run_b6("r3_build_v2", KERNEL, label, s, size, VARIANTS, expect, reps)
    for v, b in VARIANTS.items():
        held = "exact" if b.steps >= need else "truncated, held to truncated_plain"
        print(f"[probe] r3_build_v2 {b.steps} steps {label}: {res[v]:.4f} ms device, one launch "
              f"alone, {res[v] / res['full']:.2f}x full; {held} [{card}]")
    print(f"[probe] r3_build_v2 {label} ({s[0].numel():,} entries): the longest warp-local live "
          f"run is {runs} entries, so {need} steps are exact; full {res['full']:.4f} ms (shipped "
          f"{res['shipped']:.4f}), at {need} steps "
          f"{res['full' if need == 5 else f'steps {need}']:.4f} [{card}]")
    return dict(res, runs=runs, need=need)


def main(argv=None) -> int:
    return probes.b6_main("r3_build_v2", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
