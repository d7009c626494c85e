"""LAS -> `.tpc` preprocessor.

The port's copy of `preprocess_las_tpc` from `pcrhpg24_tpu/preprocess.py`
(:123-187): read LAS records per chunk of up to MAX_POINTS_PER_BATCH
points, pad the tail batch by repeating the last point, Morton-sort,
split into 65 536-point batches, encode each batch's geometry (fbatch
`.tpc` v2 or tbatch v1) and BC1 colours, and write the file.  Raw and
BC7 colours are ROADMAP A11, the `.huffman` writer A7.

Usage: python -m pcrhpg24_tpu_torch.preprocess input.las out.tpc [sort 0|1] [fixed|huffman]
"""

from __future__ import annotations

import sys

import numpy as np

from .codec.bc1 import encode_bc1
from .codec.fixed import encode_fixed_batch
from .codec.morton import morton_order
from .codec.native import encode_native_batch
from .constants import MAX_POINTS_PER_BATCH, POINTS_PER_WORKGROUP, WORKGROUP_SIZE
from .formats.las import read_header, read_points
from .formats.native_file import write_tpc


def preprocess_las_tpc(las_path: str, out_path: str, sort: bool = True,
                       verbose=True, codec: str = "fixed",
                       color_fmt: str = "bc1"):
    """LAS -> `.tpc` (TPU-native format).

    codec="fixed" writes v2 fbatch blobs (fixed-width, fastest decode —
    the flagship format); codec="huffman" writes v1 bucket-Huffman
    tbatch blobs (~13% smaller, slower decode).  Colours are BC1.
    """
    if color_fmt != "bc1":
        raise NotImplementedError(f"{color_fmt} colours are ROADMAP A11")
    if codec not in ("fixed", "huffman"):
        raise ValueError(f"unknown codec {codec!r}")
    encode = encode_fixed_batch if codec == "fixed" else encode_native_batch

    header = read_header(las_path)
    n_total = header.num_points
    batches, colors = [], []
    for start in range(0, n_total, MAX_POINTS_PER_BATCH):
        count = min(MAX_POINTS_PER_BATCH, n_total - start)
        pts = read_points(las_path, start, count)
        x, y, z, color = pts.x, pts.y, pts.z, pts.color
        pad = (-len(x)) % POINTS_PER_WORKGROUP
        if pad:
            x = np.concatenate([x, np.full(pad, x[-1], x.dtype)])
            y = np.concatenate([y, np.full(pad, y[-1], y.dtype)])
            z = np.concatenate([z, np.full(pad, z[-1], z.dtype)])
            color = np.concatenate([color, np.full(pad, color[-1], color.dtype)])
        if sort:
            order = morton_order(x, y, z)
            x, y, z, color = x[order], y[order], z[order], color[order]
        for s in range(0, len(x), POINTS_PER_WORKGROUP):
            sl = slice(s, s + POINTS_PER_WORKGROUP)
            batches.append(encode(x[sl], y[sl], z[sl]))
            colors.append(encode_bc1(color[sl]))
        if verbose:
            print(f"tpc chunk {start // MAX_POINTS_PER_BATCH}: {len(batches)} batches")
    write_tpc(
        out_path, batches, colors, header.scale, header.offset,
        header.cmin, header.cmax, color_fmt=color_fmt,
    )
    if verbose:
        total_words = sum(nb.total_words for nb in batches)
        n = len(batches) * POINTS_PER_WORKGROUP
        geo = 4 * total_words + (12 + 4 * 384 * 8 // 1024) * WORKGROUP_SIZE * len(batches)
        print(f"Number of Points: {n}")
        print(f"Number of Batches: {len(batches)}")
        print(f"Geometry Compression Ratio: {12.0 * n / geo:.3f}")
    return out_path


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    sort = bool(int(argv[2])) if len(argv) > 2 else True
    codec = argv[3] if len(argv) > 3 else "fixed"
    preprocess_las_tpc(argv[0], argv[1], sort, codec=codec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
