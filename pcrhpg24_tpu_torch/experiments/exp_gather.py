"""Where B12's 4096-entry table belongs: the card's counterpart of the TPU
probe `experiments/exp_gather.py` (pallas_call at :18, `kern`).

The TPU probe asked whether a Pallas kernel can gather from a 4096-entry
int32 table in VMEM at a per-lane index: 1024 lookups into
`arange(4096) * 7`.  On the card the question is what such a lookup
costs where B12 (`csrc/decode_huffman.cu`) makes it: each batch's table
staged in shared memory as (value, length) `int2` pairs, one 8-byte read
a symbol on each lane's dependent chain (`:260-262`, `:395-402`).
`exp_gather.cu` runs `pcr_probe_gather<source, pattern>`:

- source: smem-int2 (the shipped form), smem-split (two int tables in
  shared memory, two loads), ldg (`__ldg` of the pair from device
  memory, through L1);
- pattern: tpu (the TPU probe's 1024 lookups into `arange(4096) * 7`, the
  lengths 0), random (a fresh hashed 12-bit index a lane and step),
  broadcast (one hashed index a warp and step), chain (each lane's next
  index is the low 12 bits of the value + length it just read: B12's
  dependent chain).

Random, broadcast and chain run at B12's scale: 65,536 lanes x 192 steps
over 64 batch tables (1,024 lanes a table, 256-thread blocks).  A lane
writes the u32 sum of its lookups, held bit-exact to `gather_plain`, a
torch gather (the chain unrolled in torch).  Each source is timed one
launch alone; ns per dependent lookup = ms / steps, G lookups/s = lanes x
steps / ms.  On a host with a card:

    python -m pcrhpg24_tpu_torch.experiments.exp_gather
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels.build import I, P, check_cuda
from ..u32 import MASK32
from . import probes

GATHER = probes.probe_kernel("pcr_probe_gather", [I, I, P, P, P, P, I, I, I, I, P])
SOURCES = {"smem-int2": 0, "smem-split": 1, "ldg": 2}
PATTERNS = {"tpu": 0, "random": 1, "broadcast": 2, "chain": 3}
TAB = 4096
LANES, STEPS, TABLES = 65_536, 192, 64  # B12's chunk: lanes, symbols a lane, batches
THREADS = 256  # B12's 8-warp blocks


def tpu_tables(device="cuda") -> dict:
    """The TPU probe's table, `arange(4096) * 7`, with lengths 0."""
    val = (torch.arange(TAB, dtype=torch.int32, device=device) * 7)[None]
    return tables_of(val, torch.zeros_like(val))


def random_tables(tables: int = TABLES, seed: int = 0, device="cuda") -> dict:
    """`tables` seeded tables: random int32 values, lengths in [-12, 12]
    (B12's code lengths, the sign marking an escape)."""
    g = torch.Generator(device=device).manual_seed(seed)
    val = torch.randint(-2**31, 2**31 - 1, (tables, TAB), generator=g, dtype=torch.int32,
                        device=device)
    length = torch.randint(-12, 13, (tables, TAB), generator=g, dtype=torch.int32,
                           device=device)
    return tables_of(val, length)


def tables_of(val: torch.Tensor, length: torch.Tensor) -> dict:
    """(tables, 4096) values and lengths -> the probe's table arguments:
    those, and the (tables, 4096, 2) pairs."""
    return dict(val=val.contiguous(), len=length.contiguous(),
                pairs=torch.stack([val, length], -1).contiguous())


def gather(tabs: dict, source: str, pattern: str, idx=None, lanes: int = LANES,
           steps: int = STEPS, threads: int = THREADS) -> torch.Tensor:
    """One launch of pcr_probe_gather (CUDA tensors) -> (lanes,) int32, the
    u32 sum of each lane's lookups (pattern tpu: one lookup at idx)."""
    tables = tabs["val"].shape[0]
    for k in ("val", "len"):
        check_cuda(k, tabs[k], torch.int32, (tables, TAB))
    check_cuda("pairs", tabs["pairs"], torch.int32, (tables, TAB, 2))
    if pattern == "tpu":
        check_cuda("idx", idx, torch.int32, (lanes,))
        steps = 1
    per_table = lanes // tables
    out = torch.empty(lanes, dtype=torch.int32, device=tabs["val"].device)
    GATHER.launch(SOURCES[source], PATTERNS[pattern], tabs["pairs"].data_ptr(),
                  tabs["val"].data_ptr(), tabs["len"].data_ptr(),
                  idx.data_ptr() if idx is not None else 0, per_table, lanes, steps, threads,
                  out.data_ptr())
    return out


def gather_plain(tabs: dict, pattern: str, idx=None, lanes: int = LANES,
                 steps: int = STEPS) -> torch.Tensor:
    """The plain version of `gather`, any source: lane l reads table l //
    (lanes / tables); a lookup of entry i yields value + length (u32)."""
    entry = (tabs["val"].to(torch.int64) + tabs["len"].to(torch.int64)) & MASK32
    tables = entry.shape[0]
    lane = torch.arange(lanes, dtype=torch.int64, device=entry.device)
    t = lane // (lanes // tables)
    if pattern == "tpu":
        return probes.as_u32_bits(entry[t, idx.to(torch.int64)])
    acc = torch.zeros(lanes, dtype=torch.int64, device=entry.device)
    if pattern == "chain":
        i = probes.mix(lane) & (TAB - 1)
        for _ in range(steps):
            r = entry[t, i]
            acc = acc + r
            i = r & (TAB - 1)
    else:
        key = lane if pattern == "random" else lane >> 5
        for s in range(steps):
            acc = acc + entry[t, probes.mix((key * 256 + s) & MASK32) & (TAB - 1)]
    return probes.as_u32_bits(acc & MASK32)


def tpu_index(device="cuda") -> torch.Tensor:
    """1024 seeded indices in [0, 4096) for the tpu pattern (the TPU
    probe's come from `jax.random`, which the port does not use)."""
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, TAB, (1024,), generator=g, dtype=torch.int32, device=device)


def run(card: str, device="cuda", reps: int = 20) -> dict:
    """Every source on the tpu pattern and at B12's scale on random,
    broadcast and chain: each held bit-exact to `gather_plain`, then timed
    (one launch alone, device ms, median of `reps`).  Prints a `[probe]`
    line for each -> {(source, pattern): dict(ms, ns_per_step,
    glookups)}, and "plain_ms" (the chain's plain version)."""
    probes.require_card(device)
    small, big = tpu_tables(device), random_tables(device=device)
    idx = tpu_index(device)
    cases = [("tpu", small, 1024, 1024)] + [(p, big, LANES, THREADS)
                                            for p in ("random", "broadcast", "chain")]
    out = {}
    for pattern, tabs, lanes, threads in cases:
        want = gather_plain(tabs, pattern, idx, lanes)
        steps = 1 if pattern == "tpu" else STEPS
        for source in SOURCES:
            got = gather(tabs, source, pattern, idx, lanes, threads=threads)
            if not torch.equal(got, want):
                raise AssertionError(f"exp_gather {source} {pattern}: "
                                     f"{int((got != want).sum())} lanes != gather_plain")
            ms = probes.time_ms(lambda s=source: gather(tabs, s, pattern, idx, lanes,
                                                        threads=threads), reps)
            n = lanes * steps
            out[(source, pattern)] = dict(ms=ms, ns_per_step=ms * 1e6 / steps,
                                          glookups=n / ms / 1e6)
            print(f"[probe] exp_gather {source} {pattern}: {ms:.4f} ms device, one launch "
                  f"alone ({lanes:,} lanes x {steps} lookups, {tabs['val'].shape[0]} tables "
                  f"of 4096 (value, length) pairs); {ms * 1e6 / steps:.2f} ns a "
                  f"{'dependent ' if pattern == 'chain' else ''}step, {n / ms / 1e6:.2f} G "
                  f"lookups/s; bit-exact vs gather_plain [{card}]")
    out["plain_ms"] = probes.time_ms(lambda: gather_plain(big, "chain"), 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_gather: no card", file=sys.stderr)
        return 1
    card = probes.card_line()
    run(card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
