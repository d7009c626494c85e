"""Does B1 gain from unrolling, or from ranks computed ahead: the card's
counterpart of the TPU probe `experiments/r3_decode_ilp.py` (pallas_call
at :141, `_kernel_v2`).

The TPU probe rewrote its fbatch (`.tpc` v2) decode with the step state
in closed form, all 64 ranks from one prefix matmul before the loop, and
the point loop unrolled 1 or 64 times, each bit-checked against the
production kernel.  The card's B1 (`csrc/decode_fixed.cuh`) already has
the closed-form counts; its point loop has a run-time trip count and no
unroll, and takes three ballots a round for the rank.
`r3_decode_ilp.cu` instantiates it at each variant:

- full: the shipped instance, timed in turns with the shipped
  `decode_fixed_batches` (within 3%);
- uN (N = 2, 4, 8, 64): the 64 rounds known at compile time under
  `#pragma unroll N`;
- ahead: each chain's own-lane rank of all 64 rounds computed before the
  loop into shared memory, so that no ballot stays on the loop path;
- ahead-uN: both.

Every variant is held bit-exact to `decode_fixed_plain` and timed one
launch alone; each instance's registers and spills (ptxas) are printed
beside its time.  (The TPU probe loads a scene when imported, so it has
no function to hold this against on the CPU; `decode_fixed_plain` is
held to the reference's B1 there.)  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_decode_ilp \\
        [--scene out/chip_smoke_256_v2.tpc] [--view orbit]

runs them on the scene's busiest 64-batch chunk at the view (the TPU
probe's `out/bench_64.tpc` scene at four times the batches).
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..kernels.build import I, P, check_cuda
from ..render.decode_fixed import G, LANES, PTS, decode_fixed_batches, decode_fixed_plain
from . import probes

B1 = probes.probe_kernel("pcr_probe_b1", [I, I, P, P, P, P, P, I, I, I])
# variant -> (unroll, ahead): the template values of `pcr_probe_b1`
VARIANTS = {"full": (0, False), **{f"u{n}": (n, False) for n in (2, 4, 8, 64)},
            "ahead": (0, True), **{f"ahead-u{n}": (n, True) for n in (2, 4, 8, 64)}}
KEYS = ("widths", "streams", "ptrs", "starts")
SHIPPED_TOLERANCE = 0.03  # full against the shipped kernel, same call
# the mangled name of an instance of `b1::decode_fixed_kernel<unroll, ahead>`
INSTANCE = r"decode_fixed_kernelILi(\d+)ELb([01])E"


def decode(inputs, variant: str) -> torch.Tensor:
    """One launch of pcr_probe_b1 at `variant` on B1's four inputs (CUDA
    tensors, as `decode_fixed_batches` takes them), all 64 points ->
    (B, 64, 3, 8, 128) int32 coordinates."""
    widths, streams, ptrs, starts = inputs
    B, maxt = streams.shape[0], streams.shape[1]
    check_cuda("widths", widths, torch.int32, (B, 3, G, LANES))
    check_cuda("streams", streams, torch.int32, (B, maxt, G, LANES))
    check_cuda("ptrs", ptrs, torch.int32, (B, 1, PTS))
    check_cuda("starts", starts, torch.int32, (B, 3, G, LANES))
    if streams.data_ptr() % 16:
        raise ValueError("streams must start 16-byte aligned")
    out = torch.empty((B, PTS, 3, G, LANES), dtype=torch.int32, device=streams.device)
    unroll, ahead = VARIANTS[variant]
    B1.launch(unroll, int(ahead), *(t.data_ptr() for t in (widths, streams, ptrs, starts, out)),
              B, maxt, PTS)
    return out


def resources(log: str | None = None) -> dict:
    """ptxas's resources of each variant's instance -> {variant: dict}."""
    found = probes.instance_resources(INSTANCE, log)
    return {v: found.get((str(u), str(int(a)))) for v, (u, a) in VARIANTS.items()}


def moved_bytes(inputs) -> int:
    """Bytes a launch must move: widths, ptrs, starts, each group's stream
    up to its last round's pointer + 384 words, the coordinates written."""
    widths, streams, ptrs, starts = inputs
    nwords = streams.shape[1] * LANES
    words = int(torch.clamp(ptrs[:, 0, -1].to(torch.int64) + 3 * LANES, max=nwords).sum()) * G
    out = streams.shape[0] * PTS * 3 * G * LANES * 4
    return sum(t.numel() * 4 for t in (widths, ptrs, starts)) + 4 * words + out


def run(label: str, inputs, card: str, log: str | None = None, reps: int = 20) -> dict:
    """Every variant on B1's inputs (CUDA tensors), each held bit-exact to
    `decode_fixed_plain`, then timed (one launch alone, device ms, median
    of `reps`); full in turns with the shipped kernel.  Prints a `[probe]`
    line for each with its registers and spills; raises if a variant
    disagrees or full is more than 3% off the shipped kernel.  ->
    {variant: ms, "shipped": ms, "plain_ms": ms, "resources": {variant:
    ptxas resources}}."""
    probes.require_cuda([inputs])
    want = decode_fixed_plain(*inputs)
    for v in VARIANTS:
        got = decode(inputs, v)
        if not torch.equal(got, want):
            raise AssertionError(f"r3_decode_ilp {v} on {label}: {int((got != want).sum())} "
                                 f"coordinates != decode_fixed_plain")
    del want
    res = {v: probes.time_ms(lambda v=v: decode(inputs, v), reps) for v in VARIANTS}
    full, shipped = probes.paired_ms([lambda: decode(inputs, "full"),
                                      lambda: decode_fixed_batches(*inputs)], reps)
    res["full"], res["shipped"] = statistics.median(full), statistics.median(shipped)
    res["plain_ms"] = probes.time_ms(lambda: decode_fixed_plain(*inputs), 1)
    res["resources"] = resources(log)
    off = res["full"] / res["shipped"] - 1
    for v in VARIANTS:
        r = res["resources"][v] or {}
        print(f"[probe] r3_decode_ilp {v} {label}: {res[v]:.4f} ms device, one launch alone, "
              f"{res[v] / res['full']:.2f}x full; {r.get('registers', '?')} registers, "
              f"{r.get('smem', '?')} B smem, spills {r.get('spill_stores', '?')} B stored "
              f"{r.get('spill_loads', '?')} B loaded, stack {r.get('stack', '?')} B; bit-exact "
              f"vs decode_fixed_plain [{card}]")
        for line in r.get("lines", []):
            print(f"[probe ptxas] r3_decode_ilp {v}: {line}")
    best = min(VARIANTS, key=lambda v: res[v])
    print(f"[probe] r3_decode_ilp {label}: full {res['full']:.4f} ms (shipped "
          f"decode_fixed_batches {res['shipped']:.4f}, {off:+.1%}); fastest {best} "
          f"{res[best]:.4f} ({res[best] / res['full'] - 1:+.1%}); plain {res['plain_ms']:.1f} "
          f"ms [{card}]")
    if abs(off) > SHIPPED_TOLERANCE:
        raise AssertionError(f"r3_decode_ilp full {label}: {res['full']:.4f} ms is "
                             f"{off:+.1%} off the shipped kernel's {res['shipped']:.4f}")
    return res


def inputs_of(chunk: dict) -> list:
    """B1's four inputs from a `probes.tpc_chunk` dict."""
    return [chunk[k].contiguous() for k in KEYS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="out/chip_smoke_256_v2.tpc",
                    help="a .tpc v2 scene (default: the smoke's at 256 batches)")
    ap.add_argument("--view", default="orbit", choices=sorted(probes.views()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("r3_decode_ilp: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    chunk, label = probes.tpc_chunk(args.scene, args.view)
    run(label, inputs_of(chunk), card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
