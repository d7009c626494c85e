"""What one chain tile of B3 costs: the card's counterpart of the TPU
probe `experiments/r4_floor.py` (pallas_call at :222).

The TPU probe split its matscatter merge's cost per window into the
ring and loop (noop), the window prep, the full kernel, and the full
kernel without its DMAs (nodma).  The card's B3 in the chain layout
(`csrc/raster.cu`, the `.tpc` and `.huffman` frames) gives each warp
one 32-row x 16-column tile (512 entries), staged through 52 KB of
shared memory a block and read back transposed (`tiles::load_tile`).
`r4_floor.cu` builds the same anatomy from `probes.cuh`'s b3_probe:

- noop: the grid and each tile's part lookup, no read (its XOR of the
  tiles' (part, index) held to `probes.noop_plain`);
- prep: + the tile's staging and transpose, the stream read into
  registers (the floor lesion; its XOR of the loaded words held to
  `probes.floor_plain`);
- full: the shipped kernel (bit-exact to `u64_min_planes_plain`);
- nodma: full on tiles made in registers from a hash of the entries'
  index, staged and transposed alike, no global read (the no-load
  lesion; bit-exact to the plain version on `probes.made_parts`).

Each is reported in ms and in ns per warp-tile (the launch's time over
its tiles).  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r4_floor [--scene out/chip_smoke_256_v2.tpc]

runs it on the most populated chunk of the `.tpc` frame at bench.py's
three views and the corner close-up, as `chip_smoke.py` does.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..render.raster import key_plane, key_views, u64_min_planes_plain
from . import probes

FLOOR = probes.probe_kernel("pcr_probe_floor", probes.B3_ARGS)
VARIANTS = {"noop": "noop", "prep": "floor", "full": "full", "nodma": "no-load"}  # -> lesion
WIDTH = probes.SHIPPED_WIDTH["chain"]
VIEWS = ("orbit", "closeup", "oblique", "tpc corner")
# the plain versions: of the planes of full and nodma, (parts, size) ->
# planes, and of the checksums of noop and prep, (parts, size) -> u32
PLAIN = {"full": u64_min_planes_plain,
         "nodma": lambda parts, size: u64_min_planes_plain(probes.made_parts(parts, size),
                                                           size)}
CHECKSUMS = {"noop": lambda parts, size: probes.noop_plain(parts, "chain", WIDTH),
             "prep": lambda parts, size: probes.floor_plain(parts, "chain", WIDTH)}


def anatomy(parts, size: int, variant: str, plane, sums) -> None:
    """One launch of `variant` (a key of VARIANTS) in the chain layout."""
    probes.launch_b3(FLOOR, parts, size, "chain", VARIANTS[variant], WIDTH, plane, sums)


def run(label: str, parts, size: int, card: str, reps: int = 20) -> dict:
    """Each variant on `parts`, held to its plain version, then timed (one
    launch alone, median of `reps`, from an EMPTY plane) -> {variant: ms,
    "tiles": warp-tiles}; prints a `[probe]` line for each."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    plane, sums = key_plane(size, device), probes.new_sums(device)
    tiles = sum(probes.tiles_of(p[0].numel(), "chain", WIDTH) for p in probes.live_parts(parts))

    def reset():
        plane.fill_(-1)
        sums.zero_()

    out = {"tiles": tiles}
    for v, lesion in VARIANTS.items():
        reset()
        anatomy(parts, size, v, plane, sums)
        if v in CHECKSUMS:
            ok = probes.folded(sums, lesion) == CHECKSUMS[v](parts, size)
        else:
            ok = all(torch.equal(g, w) for g, w in zip(key_views(plane), PLAIN[v](parts, size)))
        if not ok:
            raise AssertionError(f"r4_floor {v} on {label} != its plain version")
        out[v] = probes.time_ms(lambda v=v: anatomy(parts, size, v, plane, sums), reps, reset)
        print(f"[probe] r4_floor {v} {label}: {out[v]:.4f} ms device, one launch alone, "
              f"{out[v] * 1e6 / tiles:.2f} ns per 512-entry warp-tile ({tiles:,} tiles), "
              f"{out[v] / out['noop']:.2f}x noop [{card}]")
    print(f"[probe] r4_floor per tile {label}: noop {out['noop'] * 1e6 / tiles:.2f} ns, "
          f"prep +{(out['prep'] - out['noop']) * 1e6 / tiles:.2f}, full "
          f"+{(out['full'] - out['prep']) * 1e6 / tiles:.2f} (prep "
          f"{out['prep'] / out['full']:.1%} of full); nodma "
          f"{out['nodma'] * 1e6 / tiles:.2f} ns [{card}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="out/chip_smoke_256_v2.tpc", help="a .tpc scene")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("r4_floor: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    for view in VIEWS:
        parts, size, _layout = probes.scene_parts(args.scene, probes.views()[view])
        run(f"{view} chunk", [probes.busiest(parts, size)], size, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
