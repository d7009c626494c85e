"""Which stage of B5 takes the time: the card's counterpart of the TPU
probe `experiments/exp_pallas_variants.py` (pallas_call at :118,
`mk_kernel(variant).kern`).

The TPU probe cut stages out of its tbatch (`.tpc` v1) decode: the rank's
prefix matmul (`rank: roll`), the refill (`no_refill`), the window read
(`no_window`) and the LUT gathers (`no_lut`).  The card's B5
(`csrc/decode_native.cuh`) reads L and the bucket from a 4096-entry table
in shared memory, ranks by ballots with a hand-over between its two
consumer warps, and reads its words from a ring that a producer warp
streams in.  `exp_pallas_variants.cu` instantiates that kernel with a
variant as a template value (`b5::Variant`):

- full: the shipped instance, held bit-exact to `decode_native_plain`
  and timed in turns with the shipped `decode_native_batches` (within
  3%, or the variants' times do not stand for the shipped kernel's);
- ladder: no table: L by the 11-compare ladder, dD[L] and the LUT from
  shared memory (the TPU's production form), exact;
- rank-scan: the rank by a 7-step scan in shared memory behind barriers
  (the counterpart of `rank: roll`), exact;
- no-table: bucket = L, no table, dD or LUT (the TPU's `no_lut`);
- no-window: the refilled word is the rank (`no_window`);
- no-refill: no word is ever taken (`no_refill`);
- no-refill-no-table: both.

Each lesion writes real coordinates, held bit-exact to `variant_plain`,
`decode_native_plain` with the TPU probe's switches.  Each variant is
timed one launch alone (`probes.time_ms`), and B5's split printed: the
table against the ladder, the refill (full - no-refill), of which the
word read (full - no-window), and the rank (full - rank-scan).  On a
host with a card:

    python -m pcrhpg24_tpu_torch.experiments.exp_pallas_variants \\
        [--scene out/chip_smoke_256_v1.tpc] [--view orbit]

runs them on the TPU probe's own input (64 copies of one 65,536-point
seeded random walk, Morton-ordered and encoded by the port's codec) and
on the scene's busiest 64-batch chunk at the view.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import numpy as np
import torch

from ..kernels.build import I, P, check_cuda
from ..render.decode_tbatch import (G, LANES, MAXL, PTS, ROUNDS, _window_hi,
                                    decode_native_batches, decode_native_plain,
                                    pack_native_batches)
from ..u32 import from_u32, widen
from . import probes

B5 = probes.probe_kernel("pcr_probe_b5", [I, P, P, P, P, P, P, I, I, I])
VARIANTS = {"full": 0, "ladder": 1, "rank-scan": 2, "no-table": 3, "no-window": 4,
            "no-refill": 5, "no-refill-no-table": 6}
# the TPU probe's switches for each variant (`mk_kernel`'s dict); full,
# ladder and rank-scan decode exactly, so their plain version is B5's
TPU_SWITCHES = {"full": {}, "ladder": {}, "rank-scan": {"rank": "roll"},
                "no-table": {"no_lut": True}, "no-window": {"no_window": True},
                "no-refill": {"no_refill": True},
                "no-refill-no-table": {"no_refill": True, "no_lut": True}}
EXACT = ("full", "ladder", "rank-scan")
KEYS = ("lj", "streams", "ptrs", "dD", "lut", "starts")
SHIPPED_TOLERANCE = 0.03  # full against the shipped kernel, same call


def decode(inputs, variant: str, points: int = PTS, out=None, lj=None) -> torch.Tensor:
    """One launch of pcr_probe_b5 at `variant` on B5's six inputs (CUDA
    tensors, as `decode_native_batches` takes them; `lj` in place of
    theirs) into `out` (default: a new tensor) -> (B, points, 3, 8, 128)
    int32 coordinates."""
    lj_in, streams, ptrs, dD, lut, starts = inputs
    lj = lj_in if lj is None else lj
    B, maxw = streams.shape[0], streams.shape[2]
    check_cuda("streams", streams, torch.int32, (B, G, maxw))
    check_cuda("lj", lj, torch.int32, (B, 1, 32))
    check_cuda("ptrs", ptrs, torch.int32, (B, ROUNDS, G))
    check_cuda("lut", lut, torch.int32, (B, 1, 128))
    check_cuda("starts", starts, torch.int32, (B, 3, G, LANES))
    if maxw % 4 or streams.data_ptr() % 16 or not 0 < points <= PTS:
        raise ValueError("streams rows must start 16-byte aligned, points in 1..64")
    if out is None:
        out = torch.empty((B, points, 3, G, LANES), dtype=torch.int32, device=streams.device)
    check_cuda("out", out, torch.int32, (B, points, 3, G, LANES))
    B5.launch(VARIANTS[variant], lj.data_ptr(), streams.data_ptr(), ptrs.data_ptr(),
              lut.data_ptr(), starts.data_ptr(), out.data_ptr(), B, maxw, points)
    return out


def variant_plain(variant: str, lj, streams, ptrs, dD, lut, starts, points: int = PTS):
    """`decode_native_plain` with the TPU probe's switches of `variant`
    (`TPU_SWITCHES`): `no_lut` takes bucket = L; `no_refill` keeps the
    window and only wraps the bit offset; `no_window` refills the rank in
    place of the word.  The exact variants decode as B5."""
    sw = TPU_SWITCHES[variant]
    B, _, maxw = streams.shape
    dev = streams.device
    flat = widen(streams).reshape(-1)
    cur = widen(streams[:, :, 0:LANES])
    nxt = widen(streams[:, :, LANES:2 * LANES])
    bitpos = torch.zeros((B, G, LANES), dtype=torch.int64, device=dev)
    dD_flat = dD.reshape(B, 128).to(torch.int64)
    lut_flat = lut.reshape(B, 128).to(torch.int64)
    limits = lj[:, 0].to(torch.int64)
    row = ((torch.arange(B, device=dev)[:, None] * G
            + torch.arange(G, device=dev)[None, :]) * maxw)[:, :, None]
    ptrs64 = ptrs.to(torch.int64)

    def refill(t, cur, nxt, bitpos):
        need = bitpos >= 32
        bitpos = torch.where(need, bitpos - 32, bitpos)
        if sw.get("no_refill"):
            return cur, nxt, bitpos
        n = need.to(torch.int64)
        rank = torch.cumsum(n, dim=2) - n
        if sw.get("no_window"):
            val = rank
        else:
            idx = row + ptrs64[:, t, :, None] + rank
            val = flat[torch.clamp(idx, 0, flat.numel() - 1)]
        return torch.where(need, nxt, cur), torch.where(need, val, nxt), bitpos

    def decode_symbol(t, cur, nxt, bitpos):
        win12 = _window_hi(cur, nxt, bitpos) >> (32 - MAXL)
        L = torch.ones_like(win12)
        for j in range(1, MAXL):
            L = L + (win12 >= limits[:, j - 1, None, None]).to(torch.int64)
        if sw.get("no_lut"):
            bucket = L
        else:
            code_L = win12 >> torch.clamp(MAXL - L, max=MAXL)
            dd = torch.gather(dD_flat, 1, L.reshape(B, -1)).reshape(L.shape)
            sym_idx = torch.clamp(code_L + dd, 0, 127)
            bucket = torch.gather(lut_flat, 1, sym_idx.reshape(B, -1)).reshape(L.shape)
        cur, nxt, bitpos = refill(t, cur, nxt, bitpos + L)
        e = torch.clamp(bucket - 1, min=0)
        win2 = _window_hi(cur, nxt, bitpos)
        extra = ((win2 >> (31 - e)) >> 1) & ((1 << e) - 1)
        cur, nxt, bitpos = refill(t + 1, cur, nxt, bitpos + e)
        z = torch.where(bucket == 0, torch.zeros_like(e), (1 << e) | extra)
        return (z >> 1) ^ -(z & 1), cur, nxt, bitpos

    deltas = []
    for i in range(points):
        d = []
        for c in range(3):
            dc, cur, nxt, bitpos = decode_symbol(6 * i + 2 * c, cur, nxt, bitpos)
            d.append(dc)
        deltas.append(torch.stack(d, 1))
    coords = torch.cumsum(torch.stack(deltas, 1), dim=1) + starts[:, None].to(torch.int64)
    return coords.to(torch.int32)


def plain(variant: str, inputs, points: int = PTS) -> torch.Tensor:
    """The plain version `variant` is held to: B5's for the exact ones."""
    if variant in EXACT:
        return decode_native_plain(*inputs, points=points)
    return variant_plain(variant, *inputs, points=points)


def probe_batch(seed: int = 0, n: int = 65_536):
    """The TPU probe's batch (`exp_pallas_variants.py:147-154`): a seeded
    random walk of n points, steps in [-80, 80), Morton-ordered and
    encoded by the port's codec -> `pack_native_batches` arrays (NumPy)."""
    from ..codec.morton import morton_order
    from ..codec.native import encode_native_batch

    rng = np.random.default_rng(seed)
    steps = rng.integers(-80, 80, size=(n, 3))
    pts = np.cumsum(steps, axis=0, dtype=np.int64).astype(np.int32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    o = morton_order(x, y, z)
    return pack_native_batches([encode_native_batch(x[o], y[o], z[o])])


def probe_input(copies: int = 64, device="cuda") -> list:
    """The TPU probe's input: `copies` copies of `probe_batch()` as B5's
    six tensors."""
    packed = probe_batch()
    return [(from_u32(packed[k]) if packed[k].dtype == np.uint32 else torch.from_numpy(packed[k]))
            .repeat(copies, *([1] * (packed[k].ndim - 1))).to(device).contiguous()
            for k in KEYS]


def moved_bytes(inputs) -> int:
    """Bytes a launch must move: lj, ptrs, lut and starts, each group's
    stream up to its last round's pointer + 128 words, and the
    coordinates written."""
    lj, streams, ptrs, _dD, lut, starts = inputs
    words = int(torch.clamp(ptrs[:, -1, :].to(torch.int64) + LANES, max=streams.shape[2]).sum())
    out = streams.shape[0] * PTS * 3 * G * LANES * 4
    return sum(t.numel() * 4 for t in (lj, ptrs, lut, starts)) + 4 * words + out


def run(label: str, inputs, card: str, reps: int = 20) -> dict:
    """Every variant on B5's six inputs (CUDA tensors), each held
    bit-exact to its plain version, then timed (one launch alone, device
    ms, median of `reps`); full in turns with the shipped kernel.  Prints
    a `[probe]` line for each and the split; raises if a variant
    disagrees or full is more than 3% off the shipped kernel.  -> {variant:
    ms, "shipped": ms, "plain_ms": the plain version's device ms}."""
    probes.require_cuda([inputs])
    wants = {}
    for v in VARIANTS:
        key = "exact" if v in EXACT else v
        if key not in wants:
            wants[key] = plain(v, inputs)
        got = decode(inputs, v)
        if not torch.equal(got, wants[key]):
            bad = int((got != wants[key]).sum())
            raise AssertionError(f"exp_pallas_variants {v} on {label}: {bad} coordinates != "
                                 f"its plain version")
    del wants
    res = {v: probes.time_ms(lambda v=v: decode(inputs, v), reps) for v in VARIANTS}
    full, shipped = probes.paired_ms([lambda: decode(inputs, "full"),
                                      lambda: decode_native_batches(*inputs)], reps)
    res["full"], res["shipped"] = statistics.median(full), statistics.median(shipped)
    res["plain_ms"] = probes.time_ms(lambda: decode_native_plain(*inputs), 1)
    off = res["full"] / res["shipped"] - 1
    n = inputs[1].shape[0]
    for v in VARIANTS:
        print(f"[probe] exp_pallas_variants {v} {label}: {res[v]:.4f} ms device, one launch "
              f"alone, {res[v] / res['full']:.2f}x full, bit-exact vs "
              f"{'decode_native_plain' if v in EXACT else 'its lesion plain'} [{card}]")
    print(f"[probe] exp_pallas_variants split {label} ({n} batches): full {res['full']:.4f} "
          f"ms (shipped decode_native_batches {res['shipped']:.4f}, {off:+.1%}); table vs "
          f"ladder {res['ladder'] - res['full']:+.4f} (ladder {res['ladder']:.4f}, no-table "
          f"{res['no-table']:.4f}); refill {res['full'] - res['no-refill']:.4f} (no-refill "
          f"{res['no-refill']:.4f}), of which the word read "
          f"{res['full'] - res['no-window']:.4f} (no-window {res['no-window']:.4f}); rank "
          f"full - rank-scan {res['full'] - res['rank-scan']:+.4f} (rank-scan "
          f"{res['rank-scan']:.4f}); no-refill-no-table {res['no-refill-no-table']:.4f}; "
          f"plain {res['plain_ms']:.1f} ms [{card}]")
    if abs(off) > SHIPPED_TOLERANCE:
        raise AssertionError(f"exp_pallas_variants full {label}: {res['full']:.4f} ms is "
                             f"{off:+.1%} off the shipped kernel's {res['shipped']:.4f}")
    return res


def inputs_of(chunk: dict) -> list:
    """B5's six inputs from a `probes.tpc_chunk` dict."""
    return [chunk[k].contiguous() for k in KEYS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="out/chip_smoke_256_v1.tpc",
                    help="a .tpc v1 scene (default: the smoke's at 256 batches)")
    ap.add_argument("--view", default="orbit", choices=sorted(probes.views()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_pallas_variants: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    run("TPU probe input", probe_input(), card)
    if os.path.exists(args.scene):
        chunk, label = probes.tpc_chunk(args.scene, args.view)
        run(label, inputs_of(chunk), card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
