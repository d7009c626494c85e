"""Potree-2 -> "wg" nodewise-compressed format converter.

Role-equivalent of the reference's tools/potree2_to_wg.js /
potree2_to_wg_blockwise.mjs: each octree node's points are re-encoded
as node-relative fixed point with a per-node bit width (the coarser the
node, the fewer bits needed for its spacing), bit-packed back to back.

Our `.wg` container (single file instead of the reference's three
ProgressiveFileBuffers):

  header = magic 'WGT1' | i64 num_nodes | i64 total_points
  node   = i32 num_points | i32 bits | i64 word_offset | i64 color_offset
         | f32 bbox_min[3] | f32 bbox_max[3]          (40 B)
  then u32 packed_words[] | u32 colors[]

Usage: python -m pcrhpg24_tpu_torch.tools.potree_to_wg potree_dir out.wg [precision]

A copy of `pcrhpg24_tpu/tools/potree_to_wg.py`: its `.wg` files are
byte-identical to the reference's.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from ..formats.potree import parse_hierarchy, read_metadata, read_node_points

MAGIC = b"WGT1"


def pack_bits(vals: np.ndarray, bits: int) -> np.ndarray:
    """(n,3) u32 -> MSB-first packed u32 words, 3*bits per point."""
    n = len(vals)
    total = n * 3 * bits
    nw = (total + 31) // 32
    out = np.zeros(nw + 2, np.uint64)
    flat = vals.reshape(-1).astype(np.uint64)
    pos = np.arange(n * 3, dtype=np.int64) * bits
    w0 = pos // 32
    sh = 64 - (pos % 32) - bits
    chunk = flat << sh.astype(np.uint64)
    np.bitwise_or.at(out, w0, chunk >> np.uint64(32))
    np.bitwise_or.at(out, w0 + 1, chunk & np.uint64(0xFFFFFFFF))
    return out[:nw].astype(np.uint32)


def unpack_bits(words: np.ndarray, bits: int, count: int) -> np.ndarray:
    """inverse of pack_bits -> (count, 3) u32 (reference bit unpacker,
    compute_loop_compress_nodewise/render.cs:268-320 semantics)."""
    w = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    pos = np.arange(count * 3, dtype=np.int64) * bits
    w0 = pos // 32
    off = pos % 32
    window = (w[w0] << np.uint64(32)) | w[w0 + 1]
    sh = (64 - off - bits).astype(np.uint64)
    vals = (window >> sh) & ((np.uint64(1) << np.uint64(bits)) - np.uint64(1))
    return vals.reshape(count, 3).astype(np.uint32)


def convert(potree_dir: str, out_path: str, precision: float = 0.001) -> str:
    meta = read_metadata(potree_dir)
    nodes = [n for n in parse_hierarchy(potree_dir, meta) if n.num_points > 0]

    records = []
    word_blobs, color_blobs = [], []
    wcur = ccur = 0
    total_points = 0
    for nd in nodes:
        world, rgba = read_node_points(potree_dir, meta, nd)
        span = float((nd.bbox_max - nd.bbox_min).max())
        bits = int(np.clip(np.ceil(np.log2(max(span / precision, 2.0))), 1, 30))
        q = np.clip(
            ((world - nd.bbox_min) / max(span, 1e-12) * (1 << bits)).astype(np.int64),
            0, (1 << bits) - 1,
        ).astype(np.uint32)
        words = pack_bits(q, bits)
        records.append(
            (nd.num_points, bits, wcur, ccur,
             (nd.bbox_min).astype(np.float32), (nd.bbox_max).astype(np.float32))
        )
        word_blobs.append(words)
        color_blobs.append(rgba.astype(np.uint32))
        wcur += len(words)
        ccur += len(rgba)
        total_points += nd.num_points

    with open(out_path, "wb") as f:
        f.write(MAGIC)
        f.write(np.asarray([len(records), total_points], np.int64).tobytes())
        for npts, bits, woff, coff, bmin, bmax in records:
            f.write(struct.pack("<iiqq", npts, bits, woff, coff))
            f.write(bmin.tobytes())
            f.write(bmax.tobytes())
        for wb in word_blobs:
            f.write(wb.tobytes())
        for cb in color_blobs:
            f.write(cb.tobytes())
    return out_path


def read_wg(path: str):
    """-> (records list, words u32[], colors u32[])."""
    with open(path, "rb") as f:
        assert f.read(4) == MAGIC
        num_nodes, total_points = np.frombuffer(f.read(16), np.int64)
        records = []
        for _ in range(num_nodes):
            npts, bits, woff, coff = struct.unpack("<iiqq", f.read(24))
            bmin = np.frombuffer(f.read(12), np.float32)
            bmax = np.frombuffer(f.read(12), np.float32)
            records.append((npts, bits, woff, coff, bmin, bmax))
        rest = np.frombuffer(f.read(), np.uint32)
    total_words = records[-1][2] + (
        (records[-1][0] * 3 * records[-1][1] + 31) // 32
    )
    words = rest[:total_words]
    colors = rest[total_words : total_words + int(total_points)]
    return records, words, colors


def main(argv=None):
    argv = argv or sys.argv[1:]
    precision = float(argv[2]) if len(argv) > 2 else 0.001
    convert(argv[0], argv[1], precision)


if __name__ == "__main__":
    main()
