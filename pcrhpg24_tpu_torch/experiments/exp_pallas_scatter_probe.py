"""What a random min-store costs on the card: the counterpart of the TPU
probe `experiments/exp_pallas_scatter_probe.py` (pallas_calls at :31
and, chained, :63).

The TPU probe ran N = 8192 serial scalar min-stores `fb[idx] =
min(fb[idx], val)` (int32, from SMEM) into one 2048 x 128 int32 VMEM
tile (1 MB) and timed a call by the slope of 1 against 5 chained calls.
On the card a min-store is an `atomicMin` into device memory, the
operation flat B3 (`csrc/raster.cu`) spends its atomics on.
`exp_pallas_scatter_probe.cu` runs n of them at random positions of a
plane, from one thread (the TPU's serial order), one warp or a full
grid:

- at the TPU probe's shapes: 8192 int32 stores into 262,144 words (1 MB),
  from one thread and from one warp (and a full grid);
- at the flat parts' scale: u64 keys (B3's) into the 1080p plane
  (2,073,600 words, 16.6 MB, which L2 holds) and into a 256 MiB plane
  (2**25 words, whose lines come from device memory), at the flat
  parts' entry counts (the `.las` orbit part's 16.8M, Potree 5e7's
  50.0M).

Timed by slope, as the probe: k = 1 and k = 5 chained launches, each
from an EMPTY plane (a fill of the plane before each launch, inside the
chain) with the values flipped in their low bit every other launch (the
probe's perturbation); a launch's cost is ((t5 - t1) - (f5 - f1)) / 4,
where f times the fills alone.  Each case's first launch, from an EMPTY
plane with no flip, is held bit-exact to its plain version,
`scatter_reduce_(..., "amin")` on the same inputs.  On a host with a
card:

    python -m pcrhpg24_tpu_torch.experiments.exp_pallas_scatter_probe \\
        [--counts 16777216 50000000]
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..kernels.build import I, L, P, check_cuda
from ..u32 import INT64_MIN
from . import probes

SCATTER = probes.probe_kernel("pcr_probe_scatter", [I, I, I, P, P, L, P, L])
N, ROWS, COLS = 8192, 2048, 128  # the TPU probe's stores and tile
PLANE_1080P = 1920 * 1080  # u64 words of B3's flat plane, 16.6 MB
DRAM_WORDS = 2**25  # u64 words of a 256 MiB plane: past the 50 MB L2
EMPTY = {False: 2**31 - 1, True: -1}  # the min's identity: INT32_MAX, u64 all ones
THREADS = 256


def inputs(n: int, words: int, wide: bool, seed: int = 0, device="cuda"):
    """n random (index, value) pairs: int32 indices into `words`; int32
    values in [0, 2**30) as the TPU probe's, or random u64 keys (as int64
    bits) when `wide`."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, words, (n,), generator=g, dtype=torch.int32, device=device)
    if wide:
        val = torch.randint(-2**63, 2**63 - 1, (n,), generator=g, dtype=torch.int64,
                            device=device)
    else:
        val = torch.randint(0, 2**30, (n,), generator=g, dtype=torch.int32, device=device)
    return idx, val


def empty_plane(words: int, wide: bool, device="cuda") -> torch.Tensor:
    return torch.full((words,), EMPTY[wide], dtype=torch.int64 if wide else torch.int32,
                      device=device)


def scatter_min(idx, val, plane, blocks: int, threads: int, flip: int = 0) -> None:
    """The kernel: plane[idx[i]] = min(plane[idx[i]], val[i] ^ flip) for
    every i, as atomics (u64 order for int64 planes), on blocks x
    threads.  CUDA tensors only."""
    wide = plane.dtype == torch.int64
    check_cuda("idx", idx, torch.int32)
    check_cuda("val", val, plane.dtype, idx.shape)
    check_cuda("plane", plane, plane.dtype)
    SCATTER.launch(int(wide), blocks, threads, idx.data_ptr(), val.data_ptr(), idx.numel(),
                   plane.data_ptr(), flip)


def scatter_min_plain(idx, val, plane, flip: int = 0) -> torch.Tensor:
    """The plain version, in place: `scatter_reduce_(..., "amin")`, int32
    values as signed, int64 keys in u64 order (biased by INT64_MIN)."""
    index = idx.to(torch.int64)
    if plane.dtype == torch.int32:
        return plane.scatter_reduce_(0, index, val ^ flip, reduce="amin")
    biased = plane ^ INT64_MIN
    biased.scatter_reduce_(0, index, (val ^ flip) ^ INT64_MIN, reduce="amin")
    return plane.copy_(biased ^ INT64_MIN)


def slope_ms(launch, fill, reps: int = 5) -> float:
    """A launch's device ms by the slope of 1 and 5 chained (fill,
    launch(k)) pairs, less the slope of the fills alone; medians of
    `reps` chains each."""
    def chain_ms(k: int, with_launch: bool) -> float:
        def chain():
            for i in range(k):
                fill()
                if with_launch:
                    launch(i & 1)
        return statistics.median(probes.paired_ms([chain], reps)[0])

    return ((chain_ms(5, True) - chain_ms(1, True))
            - (chain_ms(5, False) - chain_ms(1, False))) / 4


def cases(counts) -> list:
    """(label, entries, plane words, wide, blocks, threads) of each case."""
    grid = lambda n: max(1, -(-n // THREADS))  # noqa: E731  (one thread an entry)
    out = [(f"probe shapes, {name}", N, ROWS * COLS, False, b, t)
           for name, b, t in (("one thread", 1, 1), ("one warp", 1, 32),
                              ("full grid", grid(N), THREADS))]
    for n in counts:
        for plane, words in (("1080p plane", PLANE_1080P), ("256 MiB plane", DRAM_WORDS)):
            out.append((f"{plane}, {n:,} u64 keys", n, words, True, grid(n), THREADS))
    return out


def run(card: str, counts=(16_777_216, 50_000_000), device="cuda") -> dict:
    """Every case of `cases(counts)`: held bit-exact to the plain version,
    then timed by slope -> {label: dict(ms=per launch, gatomics=per s,
    plain_ms=the plain version's device ms, n, words, wide)}; prints a
    `[probe]` line for each."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the probes run on a card, not on {device}")
    out = {}
    for label, n, words, wide, blocks, threads in cases(counts):
        idx, val = inputs(n, words, wide, seed=n + words, device=device)
        plane = empty_plane(words, wide, device)
        scatter_min(idx, val, plane, blocks, threads)
        want = scatter_min_plain(idx, val, empty_plane(words, wide, device))
        if not torch.equal(plane, want):
            raise AssertionError(f"exp_pallas_scatter_probe {label}: != scatter_reduce_")
        ms = slope_ms(lambda flip: scatter_min(idx, val, plane, blocks, threads, flip),
                      lambda: plane.fill_(EMPTY[wide]))
        plain = probes.time_ms(lambda: scatter_min_plain(idx, val, plane), 5,
                               lambda: plane.fill_(EMPTY[wide]))
        out[label] = dict(ms=ms, gatomics=n / ms / 1e6, plain_ms=plain, n=n, words=words,
                          wide=wide)
        print(f"[probe] exp_pallas_scatter_probe slope {label}: {ms:.4f} ms a launch "
              f"({blocks:,} x {threads} threads; {n:,} random atomicMins into "
              f"{words:,} words, {words * (8 if wide else 4) / 2**20:.1f} MiB), "
              f"{n / ms / 1e6:.3f} Gatomics/s; plain scatter_reduce_ {plain:.4f} ms, "
              f"bit-exact [{card}]")
        del idx, val, plane, want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", type=int, nargs="*", default=[16_777_216, 50_000_000],
                    help="entries of the u64 cases (default: the .las and Potree 5e7 "
                         "parts')")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_pallas_scatter_probe: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    run(card, args.counts)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
