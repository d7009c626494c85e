"""Take the first N points of a LAS file (reference: tools/crop_las.mjs).

A copy of `pcrhpg24_tpu/tools/crop_las.py`.

Usage: python -m pcrhpg24_tpu_torch.tools.crop_las in.las out.las N
"""

from __future__ import annotations

import sys

import numpy as np

from ..formats.las import read_header, read_points, write_las


def crop_las(src: str, dst: str, n: int) -> str:
    h = read_header(src)
    pts = read_points(src, 0, min(n, h.num_points))
    rgb = np.stack(
        [pts.color & 255, (pts.color >> 8) & 255, (pts.color >> 16) & 255], 1
    )
    write_las(dst, pts.x, pts.y, pts.z, rgb, scale=h.scale, offset=h.offset)
    return dst


def main(argv=None):
    argv = argv or sys.argv[1:]
    crop_las(argv[0], argv[1], int(argv[2]))


if __name__ == "__main__":
    main()
