"""B6's cost built up stage by stage, and one 16-byte load a lane: the
card's counterpart of the TPU probe `experiments/r3_kernel_floor.py`
(pallas_call at :169).

The TPU probe timed its nk1 merge cumulatively (`make_kernel(mode)`):
floor (the DMAs and the loop), +suffix, +probes (the production kernel),
and 1dma, (pid, dep, pay) interleaved in one (24, 128) DMA.  Here the
stages of the card's B6 (`csrc/merge.cuh`), each an instance of
`r2_merge_tune.cu`'s `pcr_probe_b6`, on the stream sorted by pid:

- grid: the launch and the grid alone, no load (each thread folds its
  entry index; held to `probes.grid_plain`);
- floor: the three loads, folded (read-only; `probes.read_plain`);
- +scan: the loads, the heads and the scan, the heads' keys folded
  (no-atomic; `probes.heads_fold_plain`);
- full: +atomic, the shipped kernel (bit-exact, and within 3% of the
  shipped `pcr_merge_nk1` timed in turns);
- aos: full reading one `int4` a lane from an interleaved (pid, dep,
  pay, 0) copy of the stream, made outside the timed window; exact.

On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_kernel_floor \\
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

VARIANTS = {"grid": B6(lesion="grid"), "floor": B6(lesion="read-only"),
            "+scan": B6(lesion="no-atomic"), "full": B6(), "aos": B6(load="interleaved")}
PLAIN = {"grid": lambda s, size: probes.grid_plain(s[0].numel()),
         "floor": lambda s, size: probes.read_plain(s),
         "+scan": probes.heads_fold_plain,
         "full": lambda s, size: u64_min_planes_plain([s], size),
         "aos": lambda s, size: u64_min_planes_plain([s], size)}


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """The anatomy and aos on `stream` (unsorted int32 CUDA tensors) sorted
    by pid, each held to its plain version, then timed; prints a
    `[probe]` line for each and the build-up; raises on a mismatch or if
    full is more than 3% off the shipped kernel.  -> {variant: ms,
    "shipped": ms}."""
    probes.require_cuda([stream])
    s = sort_by_pid(*stream)
    res = probes.run_b6("r3_kernel_floor", KERNEL, label, s, size, VARIANTS,
                        {k: f(s, size) for k, f in PLAIN.items()}, reps,
                        inputs={"aos": (probes.interleave(s),)})
    n = s[0].numel()
    bound = probes.stream_bytes(s) / probes.HBM_BYTES_PER_S * 1e3
    for v in VARIANTS:
        print(f"[probe] r3_kernel_floor {v} {label}: {res[v]:.4f} ms device, one launch alone, "
              f"{res[v] / res['full']:.2f}x full [{card}]")
    print(f"[probe] r3_kernel_floor anatomy {label} ({n:,} entries, read bound {bound:.4f} "
          f"ms): grid {res['grid']:.4f} -> floor {res['floor']:.4f} "
          f"(+{res['floor'] - res['grid']:.4f} the loads) -> +scan {res['+scan']:.4f} "
          f"(+{res['+scan'] - res['floor']:.4f}) -> full {res['full']:.4f} "
          f"(+{res['full'] - res['+scan']:.4f} the atomics; shipped {res['shipped']:.4f}); aos {res['aos']:.4f} ({res['aos'] / res['full']:.2f}x) "
          f"[{card}]")
    return res


def main(argv=None) -> int:
    return probes.b6_main("r3_kernel_floor", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
