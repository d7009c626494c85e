"""B3 with a narrower key: the card's counterpart of the TPU probe
`experiments/r3_i8dot.py` (pallas_call at :240), whose kernel
`r3_p4dot.py` (:238) shares.

The TPU probes scattered the (depth, payload) key through narrower planes
in their merge's matmuls: int8 nibble planes (`r3_i8dot`), four 16-bit
f32 planes instead of eight bf16 byte planes (`r3_p4dot`).  The card's B3
(`csrc/raster.cu`) gathers each entry's u64 plane word and issues a u64
atomicMin for a key below it.  `r3_i8dot.cu` builds that body
(`probes.cuh`'s b3_probe) with the key narrowed, in both layouts at the
shipped widths, every form exact:

- u64: the full kernel, timed in turns with the shipped
  `u64_min_planes` (within 3%);
- two-pass (this module): two launches over a u32 depth plane and a u32
  payload plane (the two halves of the u64 plane's words, all ones at
  the start).  Pass 1 gathers and compares the depth, then runs a u32
  atomicMin of it; pass 2, a separate launch so that it sees the final
  depths, re-reads the stream, and each live entry whose depth equals
  its pixel's runs a u32 atomicMin of its payload.  The planes are then
  the u64 plane's halves (`assemble` makes the u64 words, timed apart);
  `two_pass_plain` is its plain version;
- half-gather (`r3_p4dot`): one pass whose compare gathers only the u32
  depth half of the plane word and tests `d <= plane_d`; the atomicMin
  stays u64.

Each form is held bit-exact to its plain version, then every pass is
timed in turns with the u64 form and the shipped kernel (one launch
alone each; pass 2 from the planes pass 1 leaves).  On a host with a
card:

    python -m pcrhpg24_tpu_torch.experiments.r3_i8dot \\
        [--scene out/chip_smoke_256_v2.tpc --scene out/chip_smoke_256.las] [--view orbit]

(`chip_smoke.py` runs both modules on the orbit chunk, the orbit frame's
4 colour parts, the `.las` orbit part and the Potree steady parts.)
"""

from __future__ import annotations

import statistics
import sys

import torch

from ..render.raster import key_plane, key_views, u64_min_planes, u64_min_planes_plain
from ..u32 import MASK32, widen
from . import probes

NARROW = probes.probe_kernel("pcr_probe_narrow", probes.B3_FORM_ARGS)
# each form's launches, in order
FORMS = {"u64": ("full",), "two-pass": ("depth-pass", "pay-pass"),
         "half-gather": ("half-gather",)}
SHIPPED_TOLERANCE = 0.03  # u64 against the shipped kernel, same call


def narrow(parts, size: int, layout: str, lesion: str, plane, sums) -> None:
    """One launch of the pass `lesion` in `layout` at its shipped width."""
    probes.launch_b3(NARROW, parts, size, layout, lesion, probes.SHIPPED_WIDTH[layout],
                     plane, sums, "staged")


def halves(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """two-pass's u32 (depth, payload) planes: the two halves of the u64
    plane's words, as int32 views."""
    words = plane.view(torch.int32)
    n = words.numel() // 2
    return words[:n], words[n:]


def assemble(plane: torch.Tensor) -> torch.Tensor:
    """two-pass's planes -> the u64 words (depth << 32 | payload), int64."""
    dep, pay = halves(plane)
    return (widen(dep) << 32) | widen(pay)


def two_pass_plain(parts, size: int):
    """two-pass's plain version -> (depth, payload) u32 planes (int32
    bits): the least depth of each pixel's live entries, then the least
    payload of its entries at that depth; all ones where none landed."""
    device = parts[0][0].device
    empty = torch.full((size + 1,), MASK32, dtype=torch.int64, device=device)
    depth, pay = empty.clone(), empty.clone()
    idx = []
    for pid, dep, _pay in parts:
        q = widen(pid.reshape(-1))
        idx.append(torch.where(q < size, q, torch.full_like(q, size)))
        depth.scatter_reduce_(0, idx[-1], widen(dep.reshape(-1)), reduce="amin")
    for i, (_pid, dep, y) in zip(idx, parts):
        tied = (i < size) & (widen(dep.reshape(-1)) == depth[i])
        pay.scatter_reduce_(0, torch.where(tied, i, torch.full_like(i, size)),
                            widen(y.reshape(-1)), reduce="amin")
    return probes.as_u32_bits(depth[:size]), probes.as_u32_bits(pay[:size])


# the plain versions: of the u64 planes (both forms), and of two-pass's planes
PLAIN = {"u64": u64_min_planes_plain, "two-pass": two_pass_plain}


def run(label: str, parts, size: int, card: str, layout: str = "chain",
        forms=("u64", "two-pass"), stem: str = "r3_i8dot", reps: int = 20) -> dict:
    """`forms` in `layout` on `parts`: each held bit-exact to its plain
    version, then every pass timed in turns with the shipped kernel ->
    {form or pass: ms, "shipped": ms, "assemble": ms}; prints `[probe]`
    lines; raises if a form disagrees or u64 is more than 3% off the
    shipped kernel."""
    probes.require_cuda(parts)
    device = parts[0][0].device
    want = u64_min_planes_plain(parts, size)
    plane, sums = key_plane(size, device), probes.new_sums(device)
    two = key_plane(size, device)  # two-pass's planes
    after = None  # the planes pass 1 leaves, pass 2's input
    for form in forms:
        plane.fill_(-1)
        target = two if form == "two-pass" else plane
        target.fill_(-1)
        for k, lesion in enumerate(FORMS[form]):
            narrow(parts, size, layout, lesion, target, sums)
            if form == "two-pass" and k == 0:
                after = two.clone()
        got = halves(two) if form == "two-pass" else key_views(plane)
        wants = [want] + ([two_pass_plain(parts, size)] if form == "two-pass" else [])
        if not all(all(g.equal(w) for g, w in zip(got, ws)) for ws in wants):
            raise AssertionError(f"{stem} {form} on {label} ({layout}) != its plain version")
    out = {}
    fns = {"u64": lambda: narrow(parts, size, layout, "full", plane, sums),
           "shipped": lambda: u64_min_planes(parts, size, plane=plane, layout=layout)}
    if "two-pass" in forms:
        pass2 = after.clone()  # pass 2 times from the planes pass 1 leaves
        fns["depth-pass"] = lambda: narrow(parts, size, layout, "depth-pass", two, sums)
        fns["pay-pass"] = lambda: narrow(parts, size, layout, "pay-pass", pass2, sums)
    if "half-gather" in forms:
        fns["half-gather"] = lambda: narrow(parts, size, layout, "half-gather", plane, sums)

    def reset():
        plane.fill_(-1)
        if "two-pass" in forms:
            two.fill_(-1)
            pass2.copy_(after)

    for name, t in zip(fns, probes.paired_ms(list(fns.values()), reps, reset)):
        out[name] = statistics.median(t)
    if "two-pass" in forms:
        out["two-pass"] = out["depth-pass"] + out["pay-pass"]
        out["assemble"] = probes.time_ms(lambda: assemble(two), reps)
    off = out["u64"] / out["shipped"] - 1
    n = sum(p[0].numel() for p in parts)
    for form in forms:
        passes = (f" = depth pass {out['depth-pass']:.4f} + payload pass "
                  f"{out['pay-pass']:.4f}; assembling the u64 words {out['assemble']:.4f} apart"
                  if form == "two-pass" else "")
        print(f"[probe] {stem} {form} {label} ({layout} layout, {n:,} entries): "
              f"{out[form]:.4f} ms device, one launch alone in turns{passes}; "
              f"{out[form] / out['u64']:.2f}x u64 [{card}]")
    print(f"[probe] {stem} u64 {label} ({layout} layout): shipped u64_min_planes "
          f"{out['shipped']:.4f} ms ({off:+.1%}); every form bit-exact [{card}]")
    if abs(off) > SHIPPED_TOLERANCE:
        raise AssertionError(f"{stem} u64 {label} ({layout}): {out['u64']:.4f} ms is "
                             f"{off:+.1%} off the shipped kernel's {out['shipped']:.4f}")
    return out


def main(argv=None) -> int:
    return probes.parts_main("r3_i8dot", run, __doc__, argv, layout=True)


if __name__ == "__main__":
    sys.exit(main())
