"""B5's variants by slope: the card's counterpart of the TPU probe
`experiments/exp_variant_slope.py` (pallas_call at :30, the kernel of
`exp_pallas_variants.mk_kernel`).

The TPU probe timed its decode variants by the slope of k = 1 and k = 9
chained calls, each call's `lj` perturbed by a token read from the
previous call's output (`:51-61`), so that the calls run back to back
and none can be skipped.  Here the same kernel as `exp_pallas_variants`
(`pcr_probe_b5`, no source of its own) runs k = 1 and k = 9 launches of
one variant in one stream; before launch i > 0 one torch op sets its
`lj` to `lj + (out[0] == -123454321)`, reading launch i - 1's output on
the card (the coordinates never hold that value, so `lj` is unchanged).
A launch's cost is ((t9 - t1) - (p9 - p1)) / 8, where p times the
perturbations alone; each chain is timed behind a ~1 ms spin, median of
`reps`.  Beside it: `exp_pallas_variants`' one launch alone, as B5's
kernel-table row is timed; a frame runs its chunks' B5 launches back to
back, which is what the slope times.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.exp_variant_slope \\
        [--scene out/chip_smoke_256_v1.tpc] [--view orbit]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

from . import exp_pallas_variants as ev
from . import probes

MAGIC = -123454321  # the TPU probe's token value
KS = (1, 9)


def chained(inputs, variant: str, k: int, out: torch.Tensor, ljs, launch: bool = True):
    """k launches of `variant` (launch=False: their perturbations alone),
    launch i > 0 on `lj + (out[0] == MAGIC)` of launch i - 1's output."""
    for i in range(k):
        if i:
            torch.add(inputs[0], out.view(-1)[:1].eq(MAGIC), out=ljs[i & 1])
        if launch:
            ev.decode(inputs, variant, out=out, lj=ljs[i & 1] if i else None)


def slope_ms(inputs, variant: str, reps: int = 10) -> dict:
    """One launch's device ms by slope -> dict(ms, t1, t9, p1, p9)."""
    out = ev.decode(inputs, variant)
    ljs = [inputs[0].clone(), inputs[0].clone()]
    fns = [lambda k=k, launch=launch: chained(inputs, variant, k, out, ljs, launch)
           for launch in (True, False) for k in KS]
    t1, t9, p1, p9 = (statistics.median(t) for t in probes.paired_ms(fns, reps))
    return dict(ms=((t9 - t1) - (p9 - p1)) / (KS[1] - KS[0]), t1=t1, t9=t9, p1=p1, p9=p9,
                out=out)


def run(label: str, inputs, card: str, alone: dict | None = None, reps: int = 10) -> dict:
    """Every variant of `exp_pallas_variants` by slope on B5's inputs (CUDA
    tensors); the last chained launch's output held bit-exact to the
    variant's plain version.  Prints a `[probe]` line for each beside
    `alone[variant]` (one launch alone, device ms) -> {variant: slope
    ms}."""
    probes.require_cuda([inputs])
    out, wants = {}, {}
    for v in ev.VARIANTS:
        s = slope_ms(inputs, v, reps)
        key = "exact" if v in ev.EXACT else v
        if key not in wants:
            wants[key] = ev.plain(v, inputs)
        if not torch.equal(s["out"], wants[key]):
            raise AssertionError(f"exp_variant_slope {v} on {label}: the chained output != "
                                 f"its plain version")
        out[v] = s["ms"]
        beside = (f"; one launch alone {alone[v]:.4f} ms, slope/alone "
                  f"{s['ms'] / alone[v]:.2f}" if alone and v in alone else "")
        print(f"[probe] exp_variant_slope {v} {label}: {s['ms']:.4f} ms a launch by slope "
              f"(k = 1: {s['t1']:.4f} ms, k = 9: {s['t9']:.4f}; perturbations {s['p1']:.4f}, "
              f"{s['p9']:.4f}){beside}; bit-exact [{card}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="out/chip_smoke_256_v1.tpc",
                    help="a .tpc v1 scene (default: the smoke's at 256 batches)")
    ap.add_argument("--view", default="orbit", choices=sorted(probes.views()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_variant_slope: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    targets = [("TPU probe input", ev.probe_input())]
    if os.path.exists(args.scene):
        chunk, label = probes.tpc_chunk(args.scene, args.view)
        targets.append((label, ev.inputs_of(chunk)))
    for label, inputs in targets:
        alone = {v: probes.time_ms(lambda v=v: ev.decode(inputs, v)) for v in ev.VARIANTS}
        run(label, inputs, card, alone)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
