"""Independent work a warp x pipeline depth for B6: the card's
counterpart of the TPU probe `experiments/r3_merge_micro.py` (pallas_call
at :95).

The TPU probe swept windows a loop body (`wide` 2, 3, 4, 6, 8) against
the DMA ring's depth (`RING` 6, 8, 12, 16), each exact: more independent
dependency chains for the scheduler, more copies in flight.  The card's
B6 (`csrc/merge.cuh`) runs one 32-entry group a warp with direct loads.
`r2_merge_tune.cu`'s `pcr_probe_b6` builds it with kGroups groups a warp
(loaded together, then scanned step by step side by side) and with its
loads through a per-thread ring of kStages slots in shared memory,
filled by `cp.async` kStages - 1 tiles ahead in a grid of as many blocks
as the card holds at once (each warp walks its tiles):

- groups 1 (full, the shipped kernel: timed in turns with
  `pcr_merge_nk1`, within 3%), 2, 4 and 8 with direct loads;
- rings of 2, 4 and 8 stages at 1 and at 4 groups.

Every variant is exact, held bit-exact to `u64_min_planes_plain` on the
stream sorted by pid.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_merge_micro \\
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

GROUPS = (1, 2, 4, 8)
RINGS = ((1, 2), (1, 4), (1, 8), (4, 2), (4, 4), (4, 8))  # (groups, stages)
VARIANTS = {**{("full" if g == 1 else f"groups {g}"): B6(groups=g) for g in GROUPS},
            **{f"groups {g} ring {st}": B6(groups=g, stages=st) for g, st in RINGS}}
# every variant is exact: its plain version, (pid-sorted stream, size) -> planes
PLAIN = {v: lambda s, size: u64_min_planes_plain([s], size) for v in VARIANTS}


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """Every (groups, stages) variant on `stream` (unsorted int32 CUDA
    tensors) sorted by pid, each held bit-exact to `u64_min_planes_plain`,
    then timed; prints a `[probe]` line for each and the best; raises on
    a mismatch or if full is more than 3% off the shipped kernel.
    -> {variant: ms, "shipped": ms}."""
    probes.require_cuda([stream])
    s = sort_by_pid(*stream)
    exact = PLAIN["full"](s, size)
    res = probes.run_b6("r3_merge_micro", KERNEL, label, s, size, VARIANTS,
                        {v: exact for v in VARIANTS}, reps)
    for v, b in VARIANTS.items():
        print(f"[probe] r3_merge_micro groups {b.groups} stages {b.stages} {label}: "
              f"{res[v]:.4f} ms device, one launch alone, {res[v] / res['full']:.2f}x full "
              f"[{card}]")
    best = min(VARIANTS, key=lambda v: res[v])
    print(f"[probe] r3_merge_micro {label} ({s[0].numel():,} entries): best {best} "
          f"{res[best]:.4f} ms, {res[best] / res['full']:.2f}x full {res['full']:.4f} (shipped "
          f"{res['shipped']:.4f}) [{card}]")
    return res


def main(argv=None) -> int:
    return probes.b6_main("r3_merge_micro", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
