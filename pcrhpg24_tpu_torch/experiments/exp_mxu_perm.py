"""What a partner exchange costs on the card: the counterpart of the TPU
probe `experiments/exp_mxu_perm.py` (pallas_call at :52).

The TPU probe ran 55 stages of a sorting network's step on T = 256
(8, 128) int32 tiles, `acc = min(acc, p) + (acc > p)` with p the entry
at lane `lane ^ d`, d = 1, 2, 4, ..., 64 cycling, and found the partner
by `pltpu.roll` and a select (`roll`) or by a (128, 128) permutation
matmul on four int8 planes (`mxu`); it timed each by the slope of 1 and
5 chained calls.  B10 (`csrc/tile_sort.cu`) once was such a network; its
header says in prose what an exchange through shared memory cost.
`exp_mxu_perm.cu` computes the same function three ways:

- shfl: one warp a tile, 32 entries a lane; strides 1-16 by
  `__shfl_xor_sync`, 32 and 64 by swapping the lane's own registers;
- smem-warp: one warp a tile through shared memory, a `__syncwarp` a
  stage;
- smem-block: one thread an entry, 1024 a tile, a `__syncthreads` a
  stage (the TPU's whole-register form).

Each form is held bit-exact to `perm_plain` (the stages in torch, which
the CPU tests hold to the TPU probe's own `roll` and `mxu` kernels in
interpret mode), then timed at T = 256 (the TPU probe's) and T = 4,096
(B10's row of the kernel table) two ways: one launch alone
(`probes.time_ms`), and by slope, ((t5 - t1) - (p5 - p1)) / 4 over 1 and 5
chained launches, each launch's input `x + (out[0] == -1)` from the
previous launch's output on the card (the probe's token; p times those
perturbations alone).  The rate is T x 1024 x 55 exchange-elements over a
launch's time.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.exp_mxu_perm [--tiles 256 4096]

(`chip_smoke.py` runs it beside B10's own row.)
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from ..kernels.build import I, P, check_cuda
from . import probes

PERM = probes.probe_kernel("pcr_probe_perm", [I, P, P, I, I])
FORMS = {"shfl": 0, "smem-warp": 1, "smem-block": 2}
SUB, LANES = 8, 128  # a tile, the TPU's (8, 128) vreg
STAGES = 55  # the TPU probe's
STRIDES = (1, 2, 4, 8, 16, 32, 64)
TILES = (256, 4096)  # the TPU probe's T, and B10's tiles in the kernel table
TOKEN = -1  # the TPU probe's token value
KS = (1, 5)


def inputs(tiles: int, seed: int = 0) -> torch.Tensor:
    """(tiles, 8, 128) int32 in [0, 2**30) from numpy's generator (at
    tiles = 256 and seed 0 the TPU probe's own input)."""
    x = np.random.default_rng(seed).integers(0, 1 << 30, (tiles, SUB, LANES))
    return torch.from_numpy(x.astype(np.int32))


def perm_plain(x: torch.Tensor, stages: int = STAGES) -> torch.Tensor:
    """The plain version: `stages` stages of acc = min(acc, p) + (acc > p),
    p = acc[..., lane ^ d], d = STRIDES[s % 7]."""
    lane = torch.arange(LANES, device=x.device)
    acc = x.to(torch.int32)
    for s in range(stages):
        p = acc[..., lane ^ STRIDES[s % 7]]
        acc = torch.minimum(acc, p) + (acc > p).to(torch.int32)
    return acc


def perm(x: torch.Tensor, form: str, stages: int = STAGES, out=None) -> torch.Tensor:
    """The kernel: `perm_plain` of x ((tiles, 8, 128) int32 on a card) in
    `form`, into `out` (a new tensor by default).  CUDA tensors only."""
    check_cuda("x", x, torch.int32)
    if x.dim() != 3 or tuple(x.shape[1:]) != (SUB, LANES):
        raise ValueError(f"x: expected (tiles, {SUB}, {LANES}), got {tuple(x.shape)}")
    out = torch.empty_like(x) if out is None else out
    check_cuda("out", out, torch.int32, x.shape)
    PERM.launch(FORMS[form], x.data_ptr(), out.data_ptr(), x.shape[0], stages)
    return out


def chained(x, form: str, k: int, out, xs, launch: bool = True) -> None:
    """k launches of `form` (launch=False: their perturbations alone),
    launch i > 0 on `x + (out[0] == TOKEN)` of launch i - 1's output."""
    for i in range(k):
        if i:
            torch.add(x, out.view(-1)[:1].eq(TOKEN), out=xs[i & 1])
        if launch:
            perm(xs[i & 1] if i else x, form, out=out)


def slope_ms(x, form: str, reps: int = 10) -> float:
    """One launch's device ms by the slope of KS chained launches."""
    out = torch.empty_like(x)
    xs = [x.clone(), x.clone()]
    fns = [lambda k=k, launch=launch: chained(x, form, k, out, xs, launch)
           for launch in (True, False) for k in KS]
    t1, t5, p1, p5 = (statistics.median(t) for t in probes.paired_ms(fns, reps))
    return ((t5 - t1) - (p5 - p1)) / (KS[1] - KS[0])


def run(card: str, tiles=TILES, b10_ms: float | None = None, device="cuda",
        reps: int = 20) -> dict:
    """Every form at each tile count: held bit-exact to `perm_plain`, then
    timed alone and by slope -> {(tiles, form): dict(ms, slope_ms, g_per_s,
    plain_ms)}; prints a `[probe]` line for each, and B10's row beside
    the 4,096-tile ones when `b10_ms` is given."""
    probes.require_card(device)
    out = {}
    for t in tiles:
        x = inputs(t).to(device)
        want = perm_plain(x)
        plain = probes.time_ms(lambda: perm_plain(x), 3)
        for form in FORMS:
            got = perm(x, form)
            if not torch.equal(got, want):
                raise AssertionError(f"exp_mxu_perm {form} on {t} tiles != perm_plain")
            ms = probes.time_ms(lambda form=form: perm(x, form, out=got), reps)
            slope = slope_ms(x, form)
            work = t * SUB * LANES * STAGES  # exchange-elements
            rate, by_slope = work / ms / 1e6, work / slope / 1e6 if slope > 0 else float("nan")
            out[(t, form)] = dict(ms=ms, slope_ms=slope, g_per_s=rate, plain_ms=plain)
            b10 = (f"; B10 sorts 4,096 tiles in {b10_ms:.4f} ms device ({ms / b10_ms:.2f}x)"
                   if b10_ms is not None and t == 4096 else "")
            print(f"[probe] exp_mxu_perm {form} {t:,} tiles: {ms:.4f} ms device one launch "
                  f"alone, {slope:.4f} by slope of {KS[0]} and {KS[1]} chained; {STAGES} "
                  f"stages x {t * SUB * LANES:,} entries, {rate:.1f} G exchange-elements/s "
                  f"({by_slope:.1f} by slope); plain "
                  f"{plain:.3f} ms; bit-exact{b10} [{card}]")
        del x, want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, nargs="*", default=list(TILES),
                    help="tile counts (default: the TPU probe's 256 and B10's 4,096)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_mxu_perm: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    run(card, args.tiles)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
