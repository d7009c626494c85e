"""Batch statistics + delta-bit compression study over a LAS file.

Role-equivalent of the reference's ProcessPointclouds tool
(reference: tools/process/main.cpp:104-419): per-batch bbox/point
stats plus a study of how many bits the Morton-sorted coordinate deltas
need — the number that decides the achievable compression ratio.

A copy of `pcrhpg24_tpu/tools/process_stats.py`.

Usage: python -m pcrhpg24_tpu_torch.tools.process_stats in.las
"""

from __future__ import annotations

import sys

import numpy as np

from ..codec.batch_codec import chain_deltas
from ..codec.morton import morton_order
from ..codec.native import _bitlen, zigzag
from ..constants import POINTS_PER_WORKGROUP
from ..formats.las import read_points


def delta_bit_study(path: str) -> str:
    pts = read_points(path)
    x, y, z = pts.x, pts.y, pts.z
    pad = (-len(x)) % POINTS_PER_WORKGROUP
    if pad:
        x = np.concatenate([x, np.full(pad, x[-1])])
        y = np.concatenate([y, np.full(pad, y[-1])])
        z = np.concatenate([z, np.full(pad, z[-1])])
    order = morton_order(x, y, z)
    x, y, z = x[order], y[order], z[order]

    hist = np.zeros(34, np.int64)
    nb = len(x) // POINTS_PER_WORKGROUP
    for b in range(nb):
        sl = slice(b * POINTS_PER_WORKGROUP, (b + 1) * POINTS_PER_WORKGROUP)
        deltas, _ = chain_deltas(x[sl], y[sl], z[sl])
        buckets = _bitlen(zigzag(deltas))
        hist += np.bincount(buckets.reshape(-1), minlength=34)

    total = hist.sum()
    lines = [f"file: {path}", f"#points: {len(x)}", f"#batches: {nb}",
             "delta zigzag bit-length histogram:"]
    for bits, cnt in enumerate(hist):
        if cnt:
            lines.append(f"  {bits:2d} bits: {cnt:12d}  ({100.0 * cnt / total:5.2f}%)")
    avg_bits = (hist * np.arange(34)).sum() / total
    lines.append(f"mean bits/delta: {avg_bits:.2f} (+code overhead)")
    lines.append(f"entropy-coded estimate: {3 * avg_bits / 8 + 1:.1f} B/point vs raw 12")
    return "\n".join(lines)


def main(argv=None):
    argv = argv or sys.argv[1:]
    print(delta_bit_study(argv[0]))


if __name__ == "__main__":
    main()
