"""Per-batch scene statistics dump.

Role-equivalent of the source system's readBatches debug dump to
misc.txt (modules/compute_loop_las/compute_loop_las.h:134-220): batch
count, point totals, extent, and per-batch bbox diagonal distribution,
plus compression accounting.  A copy of
`pcrhpg24_tpu/utils/batch_stats.py`.
"""

from __future__ import annotations

import numpy as np


def scene_stats(path: str) -> str:
    if path.endswith(".tpc"):
        from ..formats.native_file import read_tpc_batch, read_tpc_header

        hdr = read_tpc_header(path)
        diags, words = [], 0
        for i in range(hdr.num_batches):
            nb, _c = read_tpc_batch(path, hdr, i)
            bmin = nb.bbox_min_i.astype(np.float64) * hdr.scale
            bmax = nb.bbox_max_i.astype(np.float64) * hdr.scale
            diags.append(np.linalg.norm(bmax - bmin))
            words += nb.total_words
        extent = hdr.las_max - hdr.las_min
        geo_bytes = 4 * words + hdr.num_batches * (12 * 1024 + 4 * 384 * 8)
        lines = [
            f"file: {path}",
            f"#batches: {hdr.num_batches}",
            f"#points: {hdr.num_points}",
            f"extent: {extent[0]:.1f} x {extent[1]:.1f} x {extent[2]:.1f}",
            f"batch diagonal: min {np.min(diags):.2f} median {np.median(diags):.2f} max {np.max(diags):.2f}",
            f"geometry bytes/point: {geo_bytes / hdr.num_points:.2f} (raw 12)",
            f"geometry compression: {12 * hdr.num_points / geo_bytes:.2f}x",
        ]
        return "\n".join(lines)

    from ..formats.huffman_file import read_batch, read_file_header

    hdr = read_file_header(path)
    diags = []
    geo_bytes = 0
    first = last = None
    for i in range(hdr.num_batches):
        b = read_batch(path, hdr, i)
        bmin = np.asarray(b.bbox_min, np.float64)
        bmax = np.asarray(b.bbox_max, np.float64)
        diags.append(np.linalg.norm(bmax - bmin))
        geo_bytes += 4 * (
            len(b.encoding) + len(b.separate) + 2 * len(b.decoder_values)
            + len(b.cluster_sizes) + len(b.separate_sizes)
        ) + 12 * 1024
        if first is None:
            first = b.las_min
            last = b.las_max
    extent = np.asarray(last) - np.asarray(first)
    lines = [
        f"file: {path}",
        f"#batches: {hdr.num_batches}",
        f"#points: {hdr.num_points}",
        f"extent: {extent[0]:.1f} x {extent[1]:.1f} x {extent[2]:.1f}",
        f"batch diagonal: min {np.min(diags):.2f} median {np.median(diags):.2f} max {np.max(diags):.2f}",
        f"geometry bytes/point: {geo_bytes / hdr.num_points:.2f} (raw 12)",
        f"geometry compression: {12 * hdr.num_points / geo_bytes:.2f}x",
    ]
    return "\n".join(lines)


def main(argv=None):
    import sys

    argv = argv or sys.argv[1:]
    out = scene_stats(argv[0])
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            f.write(out + "\n")
    print(out)


if __name__ == "__main__":
    main()
