"""Synthesize a billion-point-scale potree-2 dataset, out of core.

The reference renders multi-billion-point scenes through its Potree
path (reference: src/main.cpp:87,115 configure 1-4.1B-point datasets;
modules/compute/PotreeData.h consumes them).  Those datasets come from
an external converter; to prove the same capability without external
data this tool writes a VALID potree-2 directory (metadata.json /
hierarchy.bin / octree.bin) procedurally, node by node, so neither the
build nor the later render ever holds the cloud in memory:

* a full octree of depth L: inner nodes carry `inner_n`
  spacing-subsampled points, leaves `leaf_n`;
* each node's points are generated inside its AABB from a deterministic
  per-node seed — terraced terrain (a global height field clipped to
  the node's z-cell) with height-graded colors;
* blobs append to octree.bin in BFS order; hierarchy.bin is one flat
  chunk (no proxies needed at ~4-40k nodes).

1e9 points at 18 B/point is ~18 GB of octree.bin.

A copy of `pcrhpg24_tpu/tools/synth_potree.py`: it writes the same bytes.

Usage:
  python -m pcrhpg24_tpu_torch.tools.synth_potree OUT_DIR --points 1e9
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np

from ..formats.potree import TYPE_LEAF, TYPE_NORMAL, child_aabb

EXTENT = 4096.0  # world edge length, cubic root bbox
SCALE = (0.001, 0.001, 0.001)


def _height(x, y):
    """Deterministic global height field in [0.08, 0.5] * EXTENT."""
    fx, fy = x / EXTENT, y / EXTENT
    h = (
        0.22
        + 0.10 * np.sin(3.1 * fx + 1.7) * np.cos(2.3 * fy + 0.4)
        + 0.06 * np.sin(9.2 * fx + 0.9) * np.sin(7.7 * fy + 2.1)
        + 0.03 * np.sin(23.0 * fx) * np.cos(19.0 * fy)
    )
    return np.clip(h, 0.08, 0.5) * EXTENT


def _node_points(rng, nmin, nmax, n):
    """n points in the node AABB: surface where the height field passes
    through the cell, clipped to the z-cell otherwise (terraces)."""
    x = rng.uniform(nmin[0], nmax[0], n)
    y = rng.uniform(nmin[1], nmax[1], n)
    z = _height(x, y) + rng.normal(0.0, 0.35, n)
    z = np.clip(z, nmin[2], np.nextafter(nmax[2], nmin[2]))
    shade = ((z / EXTENT) * 1024).astype(np.uint32)
    r = 60 + (shade % 160)
    g = 80 + ((shade * 7) % 150)
    b = 40 + ((shade * 13) % 120)
    return np.stack([x, y, z], 1), np.stack([r, g, b], 1).astype(np.uint16)


def synth_potree(out_dir: str, total_points: int, depth: int | None = None,
                 inner_n: int = 30_000, verbose: bool = True) -> str:
    os.makedirs(out_dir, exist_ok=True)
    if depth is None:
        depth = max(1, int(np.ceil(np.log(total_points / 250_000) / np.log(8))))
    n_inner_nodes = sum(8 ** l for l in range(depth))
    n_leaves = 8 ** depth
    leaf_n = max(1, (total_points - n_inner_nodes * inner_n) // n_leaves)

    bmin = np.zeros(3)
    bmax = np.full(3, EXTENT)
    offset = bmin
    scale = np.asarray(SCALE)

    # BFS enumeration of the full octree
    names = [("r", bmin, bmax, 0)]
    for l in range(depth):
        start = sum(8 ** k for k in range(l))
        for i in range(8 ** l):
            nm, nmn, nmx, _lv = names[start + i]
            for ci in range(8):
                cmin, cmax = child_aabb(nmn, nmx, ci)
                names.append((nm + str(ci), cmin, cmax, l + 1))

    hier = bytearray()
    byte_cursor = 0
    written = 0
    with open(os.path.join(out_dir, "octree.bin"), "wb") as f:
        for idx, (nm, nmn, nmx, lv) in enumerate(names):
            is_leaf = lv == depth
            n = leaf_n if is_leaf else inner_n
            rng = np.random.default_rng(0xBEEF ^ idx)
            pts, rgb = _node_points(rng, nmn, nmx, n)
            rec = np.zeros((n, 18), np.uint8)
            grid = np.round((pts - offset) / scale).astype(np.int32)
            rec[:, 0:12] = grid.view(np.uint8).reshape(n, 12)
            rec[:, 12:18] = rgb.view(np.uint8).reshape(n, 6)
            blob = rec.tobytes()
            f.write(blob)
            mask = 0 if is_leaf else 0xFF
            t = TYPE_LEAF if is_leaf else TYPE_NORMAL
            hier += struct.pack("<BBIqq", t, mask, n, byte_cursor, len(blob))
            byte_cursor += len(blob)
            written += n
            if verbose and idx % 512 == 0:
                print(f"  node {idx}/{len(names)} "
                      f"({written/1e6:.0f}M pts)", flush=True)

    with open(os.path.join(out_dir, "hierarchy.bin"), "wb") as f:
        f.write(bytes(hier))
    meta = {
        "version": "2.0",
        "points": int(written),
        "boundingBox": {"min": list(map(float, bmin)),
                        "max": list(map(float, bmax))},
        "scale": list(map(float, scale)),
        "offset": list(map(float, offset)),
        "spacing": float(EXTENT / 128.0),
        "hierarchy": {"firstChunkSize": len(hier), "stepSize": 100},
        "attributes": [
            {"name": "position", "size": 12, "type": "int32"},
            {"name": "rgb", "size": 6, "type": "uint16"},
        ],
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    if verbose:
        print(f"wrote {written:,} points, {byte_cursor/2**30:.1f} GiB, "
              f"{len(names)} nodes, depth {depth} -> {out_dir}")
    return out_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--points", type=float, default=1e9)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--inner", type=int, default=30_000)
    args = ap.parse_args(argv)
    synth_potree(args.out_dir, int(args.points), args.depth, args.inner)
    return 0


if __name__ == "__main__":
    sys.exit(main())
