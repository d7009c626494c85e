"""What each of B6's stages costs when it alone is cut: the card's
counterpart of the TPU probe `experiments/r2_merge_tune.py` (pallas_call
at :124).

The TPU probe ablated its nk1 merge (`mk_kernel(mode)`): full, then
nosuffix, noprobe and dmaonly, each wrong and timed only.  The card's B6
(`csrc/merge.cuh`) has no windows and no binary search: a warp loads 32
entries of the pid-sorted stream, finds its run segments
(`__ballot_sync`), folds each segment's keys to its head in five
`__shfl_down_sync` doubling steps, and the head issues one atomicMin.
`r2_merge_tune.cu`'s `pcr_probe_b6` builds that body with one stage
cut, on the stream sorted by pid (`raster.sort_by_pid`); it also holds
the variants that `r3_kernel_floor`, `r3_build_v2`, `r3_merge_micro`
and `r3_merge_micro2` launch:

- full: the shipped kernel, held bit-exact to `u64_min_planes_plain` and
  timed in turns with the shipped `pcr_merge_nk1` (within 3%, or the
  lesions' times do not stand for the shipped kernel's);
- no-scan: no doubling step, each warp-local head's own key goes to the
  atomicMin; held to `probes.truncated_plain(0)` (wrong where a
  warp-local run is longer than one entry);
- no-atomic: the scan's live heads fold their keys into a checksum and
  issue nothing; held to `probes.heads_fold_plain`;
- read-only: the three loads alone, XOR-folded; held to
  `probes.read_plain`.

Printed: each one launch alone (device ms, from an EMPTY plane), and full
minus each: the scan, the atomics, everything but the read.  On a host
with a card:

    python -m pcrhpg24_tpu_torch.experiments.r2_merge_tune \\
        [--scene parametric --scene out/chip_smoke_256.wg]

(`chip_smoke.py` runs it on the parametric near frame's stream and the
`.wg` orbit frame's.)
"""

from __future__ import annotations

import sys

from ..render.raster import sort_by_pid, u64_min_planes_plain
from . import probes
from .probes import B6

KERNEL = probes.probe_kernel("pcr_probe_b6", probes.B6_ARGS)
VARIANTS = {"full": B6(), "no-scan": B6(steps=0), "no-atomic": B6(lesion="no-atomic"),
            "read-only": B6(lesion="read-only")}
# the plain versions, (pid-sorted stream, size) -> planes or a u32 checksum
PLAIN = {"full": lambda s, size: u64_min_planes_plain([s], size),
         "no-scan": lambda s, size: probes.truncated_plain(s, size, 0),
         "no-atomic": probes.heads_fold_plain,
         "read-only": lambda s, size: probes.read_plain(s)}


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """Every lesion on `stream` (unsorted int32 CUDA tensors) sorted by
    pid, each held to its plain version, then timed; prints a `[probe]`
    line for each and the split; raises on a mismatch or if full is more
    than 3% off the shipped kernel.  -> {variant: ms, "shipped": ms}."""
    probes.require_cuda([stream])
    s = sort_by_pid(*stream)
    res = probes.run_b6("r2_merge_tune", KERNEL, label, s, size, VARIANTS,
                        {k: f(s, size) for k, f in PLAIN.items()}, reps)
    full = res["full"]
    for v in VARIANTS:
        print(f"[probe] r2_merge_tune {v} {label}: {res[v]:.4f} ms device, one launch alone, "
              f"{res[v] / full:.2f}x full [{card}]")
    print(f"[probe] r2_merge_tune split {label} ({s[0].numel():,} entries): full {full:.4f} ms "
          f"(shipped pcr_merge_nk1 {res['shipped']:.4f}, {full / res['shipped'] - 1:+.1%}); "
          f"the scan full - no-scan {full - res['no-scan']:.4f}, the atomics full - no-atomic "
          f"{full - res['no-atomic']:.4f}, all but the read full - read-only "
          f"{full - res['read-only']:.4f} [{card}]")
    return res


def main(argv=None) -> int:
    return probes.b6_main("r2_merge_tune", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
