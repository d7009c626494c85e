"""The chain tile of B3 read without staging it: the card's counterpart of
the TPU probe `experiments/r3_corient.py` (pallas_call at :254).

The TPU probe built its merge's one-hot in the orientation that needs no
(8,128)->(128,8) transpose.  The card's chain B3 (`csrc/raster.cu`) has
its transpose in `tiles::load_tile`: a warp loads a 32-row x 16-column
tile of a part coalesced, stages it in shared memory and reads it back
so that lane l holds row l (`r4_floor`'s prep lesion put that staging
at 63-83% of the chain kernel).  `r3_corient.cu` builds the full kernel
(`probes.cuh`'s b3_probe) in the chain layout with five ways to read
the tile:

- staged: the shipped loads, timed in turns with the shipped
  `u64_min_planes` (within 3%, or the forms' times do not stand for the
  shipped kernel's);
- rowload: lane l reads its own row, its 16 columns as four 16-byte
  loads of each stream, straight into registers: no shared memory and no
  transpose.  A row that ends inside them is read entry by entry up to
  the part's end.  The part pointers must be 16-byte aligned: `corient`
  raises on one that is not;
- shfl: the shipped coalesced loads (16 lanes a row), then a 32 x 16
  transpose in registers by `__shfl_sync` rounds;
- rowload-8, shfl-8: the same, 8 columns a pass (two 16-byte loads; 8
  lanes a row and a 32 x 8 transpose), two passes a tile, as the flat
  layout resolves its tile: half the registers.

Every form keeps the shipped 4 blocks an SM (64 registers a thread), so
ptxas spills what a 16-column form does not fit; the spills are printed.
Each form is held bit-exact to `u64_min_planes_plain` and timed in turns
with the shipped chain and flat kernels (one launch alone each, from an
EMPTY plane); the ptxas resources of each instance come from the probe
library's nvcc log.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_corient \\
        [--scene out/chip_smoke_256_v2.tpc] [--view orbit]

(`chip_smoke.py` runs it on the orbit chunk and the orbit frame's 4
colour parts.)
"""

from __future__ import annotations

import statistics
import sys

from ..render.raster import key_plane, key_views, u64_min_planes, u64_min_planes_plain
from . import probes

CORIENT = probes.probe_kernel("pcr_probe_corient", probes.B3_FORM_ARGS)
FORMS = ("staged", "rowload", "shfl", "rowload-8", "shfl-8")
PLAIN = {f: u64_min_planes_plain for f in FORMS}  # every form's plain version
ALIGN = 16  # bytes: rowload's vector loads
SHIPPED_TOLERANCE = 0.03  # staged against the shipped kernel, same call
SHIPPED_SMEM = 8 * 3 * 32 * 17 * 4  # the staged block's dynamic shared memory


def require_aligned(parts) -> None:
    """Raise unless every tensor of every part starts on a 16-byte
    boundary (rowload reads 16 bytes at a time; it has no fallback)."""
    for part in parts:
        for t in part:
            if t.data_ptr() % ALIGN:
                raise ValueError(f"rowload reads {ALIGN}-byte vectors: a part starts at "
                                 f"{t.data_ptr():#x}, off a {ALIGN}-byte boundary")


def corient(parts, size: int, form: str, plane, sums) -> None:
    """One launch of the full chain kernel reading its tiles as `form`."""
    if form.startswith("rowload"):
        require_aligned(parts)
    probes.launch_b3(CORIENT, parts, size, "chain", "full", 16, plane, sums, form)


def resources(log: str | None = None) -> dict:
    """ptxas's resources of each form's instance -> {form: dict}."""
    found = probes.instance_resources(r"b3_probeILi0ELi0ELi16ELi(\d+)EE", log)
    return {f: found.get((str(probes.FORMS[f]),), {}) for f in FORMS}


def run(label: str, parts, size: int, card: str, log: str | None = None,
        reps: int = 20) -> dict:
    """Every form on `parts` (chain), each held bit-exact to the plain
    version, then timed in turns with the shipped chain and flat kernels
    -> {form: ms, "shipped": ms, "flat": ms, "resources": {form: ptxas's
    counts}}; prints a `[probe]` line for each form; raises if a form
    disagrees or staged is more than 3% off the shipped kernel."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    want = PLAIN["staged"](parts, size)
    plane, sums = key_plane(size, device), probes.new_sums(device)
    for f in FORMS:
        plane.fill_(-1)
        corient(parts, size, f, plane, sums)
        if not all(g.equal(w) for g, w in zip(key_views(plane), want)):
            raise AssertionError(f"r3_corient {f} on {label} != its plain version")
    fns = [*(lambda f=f: corient(parts, size, f, plane, sums) for f in FORMS),
           lambda: u64_min_planes(parts, size, plane=plane),
           lambda: u64_min_planes(parts, size, plane=plane, layout="flat")]
    times = [statistics.median(t) for t in probes.paired_ms(fns, reps, lambda: plane.fill_(-1))]
    out = dict(zip([*FORMS, "shipped", "flat"], times))
    out["resources"] = res = resources(log)
    off = out["staged"] / out["shipped"] - 1
    for f in FORMS:
        r = res[f]
        smem = SHIPPED_SMEM if f == "staged" else 0
        print(f"[probe] r3_corient {f} {label}: {out[f]:.4f} ms device, one launch alone in "
              f"turns, {out[f] / out['staged']:.2f}x staged, {out[f] / out['flat']:.2f}x the "
              f"flat kernel's {out['flat']:.4f} on the same parts; {r.get('registers', '?')} "
              f"registers, {r.get('spill_stores', '?')} B spill stores, "
              f"{r.get('spill_loads', '?')} B spill loads, {smem:,} B shared memory a block; "
              f"bit-exact [{card}]")
    print(f"[probe] r3_corient staged {label}: shipped u64_min_planes {out['shipped']:.4f} ms "
          f"({off:+.1%}) [{card}]")
    if abs(off) > SHIPPED_TOLERANCE:
        raise AssertionError(f"r3_corient staged {label}: {out['staged']:.4f} ms is {off:+.1%} "
                             f"off the shipped kernel's {out['shipped']:.4f}")
    return out


def main(argv=None) -> int:
    return probes.parts_main("r3_corient", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
