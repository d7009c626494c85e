"""B3's compare narrowed to the depth half of the plane word: the card's
counterpart of the TPU probe `experiments/r3_p4dot.py` (pallas_call at
:238).

The TPU probe carried the key through four 16-bit f32 planes instead of
eight bf16 byte planes, to halve its merge's per-window plane work.  The
card's B3 (`csrc/raster.cu`) gathers each entry's u64 plane word before
its atomicMin; `half-gather` gathers only the u32 depth half (a 4-byte
load) and lets an entry through if `d <= plane_d` (a strict `<` would drop
an entry that ties on depth and wins on payload); the atomicMin stays
u64.  The kernel is `r3_i8dot`'s (`pcr_probe_narrow`, no source of its
own), and so is `run`: half-gather beside the u64 form and the shipped
kernel in turns, each held bit-exact to `u64_min_planes_plain`.  On a
host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_p4dot \\
        [--scene out/chip_smoke_256_v2.tpc --scene out/chip_smoke_256.las] [--view orbit]

(`chip_smoke.py` runs it on the parts of `r3_i8dot`.)
"""

from __future__ import annotations

import sys

from ..render.raster import u64_min_planes_plain
from . import probes, r3_i8dot

FORMS = ("u64", "half-gather")
PLAIN = {f: u64_min_planes_plain for f in FORMS}


def run(label: str, parts, size: int, card: str, layout: str = "chain",
        reps: int = 20) -> dict:
    """half-gather and u64 in `layout` on `parts` (`r3_i8dot.run`)."""
    return r3_i8dot.run(label, parts, size, card, layout, FORMS, "r3_p4dot", reps)


def main(argv=None) -> int:
    return probes.parts_main("r3_p4dot", run, __doc__, argv, layout=True)


if __name__ == "__main__":
    sys.exit(main())
