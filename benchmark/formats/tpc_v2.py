"""A `.tpc` v2 scene through the port's own preprocessing path.

What `preprocess.preprocess_las_tpc` does to a LAS file, on the
generated points: each chunk of up to 100 batches Morton-sorted
(`codec.morton.morton_order`), each batch's geometry encoded as fbatch
(`codec.fixed.encode_fixed_batch`) and its colours as BC1
(`codec.bc1.encode_bc1`), then `formats.native_file.write_tpc` with the
LAS header's scale, offset and box.  The chunks are encoded in parallel
by the harness's worker processes.
"""

from __future__ import annotations

import os

import numpy as np

SUFFIX = ".tpc"


def encode_chunk(args):
    """(x, y, z, colour) of one chunk -> ([FixedBatch], [BC1 words])."""
    x, y, z, color = args
    from pcrhpg24_tpu_torch.codec.bc1 import encode_bc1
    from pcrhpg24_tpu_torch.codec.fixed import encode_fixed_batch
    from pcrhpg24_tpu_torch.codec.morton import morton_order
    from pcrhpg24_tpu_torch.constants import POINTS_PER_WORKGROUP

    order = morton_order(x, y, z)
    x, y, z, color = x[order], y[order], z[order], color[order]
    batches, colors = [], []
    for s in range(0, len(x), POINTS_PER_WORKGROUP):
        sl = slice(s, s + POINTS_PER_WORKGROUP)
        batches.append(encode_fixed_batch(x[sl], y[sl], z[sl]))
        colors.append(encode_bc1(color[sl]))
    return batches, colors


def chunks(points):
    """The preprocessor's IO chunks of the points: (x, y, z, colour) each."""
    from pcrhpg24_tpu_torch.constants import MAX_POINTS_PER_BATCH

    g, c = points.grid, points.color
    for s in range(0, points.n, MAX_POINTS_PER_BATCH):
        sl = slice(s, s + MAX_POINTS_PER_BATCH)
        yield (np.ascontiguousarray(g[sl, 0]), np.ascontiguousarray(g[sl, 1]),
               np.ascontiguousarray(g[sl, 2]), c[sl])


def write(points, directory: str, pmap=map) -> dict:
    """Encode and write the scene -> {"path", "stream_words" (per batch)}."""
    from pcrhpg24_tpu_torch.formats.native_file import write_tpc

    batches, colors = [], []
    for b, c in pmap(encode_chunk, chunks(points)):
        batches += b
        colors += c
    path = os.path.join(directory, "scene.tpc")
    write_tpc(path, batches, colors, points.scale, points.offset, points.cmin, points.cmax)
    return dict(path=path, stream_words=[int(fb.streams.size) for fb in batches])


def kernel_bytes(info: dict, ref, views, hqs: bool) -> dict:
    """Least bytes a frame's launches of each port kernel move, by C
    symbol, averaged over `views` (the bounds of `chip_smoke.py`): each
    input read once, each output written once, at the frame's shapes.
    A 64-batch chunk is decoded (B1) and projected (B2) when a batch of it
    is in view, `points` per chain (the LOD bucket); B3 (and in HQS B4)
    read every chunk's stream and write the plane once."""
    from benchmark.roofline import CHUNK, swizzled_size

    words = np.asarray(info["stream_words"], np.int64)
    words = np.concatenate([words, np.zeros(-len(words) % CHUNK, np.int64)])
    chunk_words = words.reshape(-1, CHUNK).sum(axis=1)
    size = swizzled_size(views[0].width, views[0].height)
    total = dict(pcr_decode_fixed=0, pcr_project=0, pcr_u64_min=0)
    if hqs:
        total["pcr_hqs_sums"] = 0
    for v in views:
        live, points = ref.live(v)
        entries = CHUNK * points * 1024 * len(live)  # a live chunk's chains, `points` each
        coords = 12 * entries  # 3 i32 a point
        tables = (2 * 3 * 1024 * 4 + 64 * 4) * CHUNK * len(live)  # widths, starts, ptrs
        total["pcr_decode_fixed"] += tables + 4 * int(chunk_words[live].sum()) + coords
        # colours, anchor, translation and LOD of each batch; the 12 frame words
        small = ((4 * 2 * 1024 * 4 + 3 * 4 + 4 * 4 + 4) * CHUNK + 12 * 4) * len(live)
        total["pcr_project"] += 2 * coords + small
        total["pcr_u64_min"] += coords + 8 * size
        if hqs:
            total["pcr_hqs_sums"] += coords + 4 * size + 16 * size
    return {k: t / len(views) for k, t in total.items()}
