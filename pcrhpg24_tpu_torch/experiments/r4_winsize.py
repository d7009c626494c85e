"""B3 at other tile widths: the card's counterpart of the TPU probe
`experiments/r4_winsize.py` (pallas_call at :214).

The TPU probe shrank its matscatter merge's windows from 8 to 4 rows of
128 entries, bit-checked against the XLA resolve.  The card's B3
(`csrc/raster.cu`) reads a chain tile of 32 rows x 16 columns
(`tiles::kCols`) through shared memory, and a flat tile of 512 entries
in two passes of 8 columns (`tiles::kFlatCols`) straight into registers.
`r4_winsize.cu` builds the full kernel (`probes.cuh`'s b3_probe) at
chain widths of 16 (shipped), 8 and 4 columns, and at flat passes of 8
(shipped) and 4 columns; `tools/flat_variants.py` has 16 columns a
pass.  Narrower chain tiles hold fewer plane words in flight a lane and
stage less shared memory a block; narrower flat passes hold fewer.
Every width is held bit-exact to `u64_min_planes_plain` and timed (one
launch alone, from an EMPTY plane).  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r4_winsize \\
        [--scene out/chip_smoke_256_v2.tpc --scene out/chip_smoke_256.las] [--view orbit]

(`chip_smoke.py` runs it on the parts of `r3_mat_lesion`.)
"""

from __future__ import annotations

import sys

import torch

from ..render.raster import key_plane, key_views, u64_min_planes_plain
from . import probes

WINSIZE = probes.probe_kernel("pcr_probe_winsize", probes.B3_ARGS)
WIDTHS = {"chain": (16, 8, 4), "flat": (8, 4)}  # the first: shipped
PLAIN = u64_min_planes_plain  # every width's plain version


def winsize(parts, size: int, layout: str, width: int, plane, sums) -> None:
    """One launch of the full kernel in `layout` at `width`."""
    probes.launch_b3(WINSIZE, parts, size, layout, "full", width, plane, sums)


def run(label: str, parts, size: int, card: str, reps: int = 20) -> dict:
    """Every width in both layouts on `parts`, held bit-exact to the plain
    version, then timed -> {(layout, width): ms}; prints a `[probe]` line
    for each."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    want = PLAIN(parts, size)
    plane, sums = key_plane(size, device), probes.new_sums(device)
    out = {}
    for layout, widths in WIDTHS.items():
        for w in widths:
            plane.fill_(-1)
            winsize(parts, size, layout, w, plane, sums)
            if not all(torch.equal(g, x) for g, x in zip(key_views(plane), want)):
                raise AssertionError(f"r4_winsize {layout} width {w} on {label} != plain")
            out[(layout, w)] = probes.time_ms(
                lambda w=w: winsize(parts, size, layout, w, plane, sums), reps,
                lambda: plane.fill_(-1))
            what = "columns a tile" if layout == "chain" else "columns a pass"
            print(f"[probe] r4_winsize {layout}-{w} {label}: {out[(layout, w)]:.4f} ms device, "
                  f"one launch alone, {w} {what}, bit-exact; "
                  f"{out[(layout, w)] / out[(layout, widths[0])]:.2f}x the shipped width "
                  f"[{card}]")
    return out


def main(argv=None) -> int:
    return probes.parts_main("r4_winsize", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
