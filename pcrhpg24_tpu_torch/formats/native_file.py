"""`.tpc` — the TPU-native scene file format.

Same role as the reference's `.huffman` container (include/BatchDumpData.h)
but carrying TPU-native streams.  Two on-disk versions:

v1 ('TPC1', codec/native.py bucket-Huffman tbatch):
  file  = magic 'TPC1' | i64 num_points | i64 num_batches | i64 max_group_words
        | 3 x f64 scale | 3 x f64 offset | 3 x f64 las_min | 3 x f64 las_max
        | i64 blob_size[num_batches] | blob[num_batches]
  blob  = i32 bbox_min[3] | i32 bbox_max[3]
        | i32 n_code_symbols | i32 length_counts[13]
        | i32 symbols[n_code_symbols]
        | i32 group_len[8]
        | i32 round_ptrs[384*8]
        | i32 start_values[1024*3]
        | u32 stream[sum(group_len)]
        | u32 color_bc1[num_points/8]

v2 ('TPC2', codec/fixed.py fixed-width fbatch — the flagship decode
format; same file header, different blobs):
  blob  = i32 bbox_min[3] | i32 bbox_max[3]
        | i32 nwords (per group)
        | u8  widths[1024*3]
        | i32 round_ptrs[64]
        | i32 start_values[1024*3]
        | u32 stream[8*nwords]
        | u32 color_bc1[num_points/8]

'TPC3' carries a color-format field (reference compile-time option
COLOR_COMPRESSION 0|1|7, modules/compute/Resources.h:15; GPU decoders
render.cu:67-154): header gains i64 color_fmt (0 raw RGBA, 1 BC1,
7 BC7 mode 6) after max_group_words; blobs are v2 blobs whose color
array is num_points u32 (raw) or num_points/4 u32 (BC7 blocks).
Plain BC1 files keep the TPC1/TPC2 magic — fully back-compatible.

The port's copy of `pcrhpg24_tpu/formats/native_file.py`.
"""

from __future__ import annotations

import struct

import numpy as np

from ..codec.fixed import FixedBatch
from ..codec.native import CanonicalCode, NativeBatch, encode_native_batch
from ..constants import (
    POINTS_PER_THREAD,
    POINTS_PER_WORKGROUP,
    TPU_GROUPS_PER_BATCH,
    WORKGROUP_SIZE,
)

MAGIC = b"TPC1"
MAGIC2 = b"TPC2"
MAGIC3 = b"TPC3"
COLOR_FMT_CODES = {"raw": 0, "bc1": 1, "bc7": 7}
COLOR_FMT_NAMES = {v: k for k, v in COLOR_FMT_CODES.items()}
# u32 color words per 65536-point batch, by format
COLOR_WORDS = {"raw": 65536, "bc1": 8192, "bc7": 16384}


def batch_to_blob(nb: NativeBatch, color_bc1: np.ndarray) -> bytes:
    parts = [
        np.asarray(nb.bbox_min_i, np.int32).tobytes(),
        np.asarray(nb.bbox_max_i, np.int32).tobytes(),
        struct.pack("<i", len(nb.code.symbols)),
        np.asarray(nb.code.length_counts, np.int32).tobytes(),
        np.asarray(nb.code.symbols, np.int32).tobytes(),
        np.asarray([len(s) for s in nb.streams], np.int32).tobytes(),
        np.asarray(nb.round_ptrs, np.int32).tobytes(),
        np.asarray(nb.start_values, np.int32).tobytes(),
        np.concatenate([s.astype(np.uint32) for s in nb.streams]).tobytes(),
        np.asarray(color_bc1, np.uint32).tobytes(),
    ]
    return b"".join(parts)


def blob_to_batch(buf: bytes) -> tuple[NativeBatch, np.ndarray]:
    off = 0

    def take(n, dtype):
        nonlocal off
        a = np.frombuffer(buf, dtype, count=n, offset=off)
        off += 4 * n
        return a

    bbox_min = take(3, np.int32)
    bbox_max = take(3, np.int32)
    (nsym,) = struct.unpack_from("<i", buf, off)
    off += 4
    length_counts = take(13, np.int32).astype(np.int64)
    symbols = take(nsym, np.int32).astype(np.int64)
    group_len = take(TPU_GROUPS_PER_BATCH, np.int32)
    round_ptrs = take(384 * TPU_GROUPS_PER_BATCH, np.int32).reshape(384, TPU_GROUPS_PER_BATCH)
    start_values = take(WORKGROUP_SIZE * 3, np.int32).reshape(WORKGROUP_SIZE, 3)
    streams = []
    for g in range(TPU_GROUPS_PER_BATCH):
        streams.append(take(int(group_len[g]), np.uint32))
    color = take((len(buf) - off) // 4, np.uint32)  # width set by color_fmt
    assert off == len(buf), f"tpc blob size mismatch {off} != {len(buf)}"

    lengths = np.repeat(np.arange(13), length_counts)
    code = CanonicalCode(length_counts, symbols, lengths.astype(np.int64))
    nb = NativeBatch(
        streams=streams,
        code=code,
        start_values=start_values,
        bbox_min_i=bbox_min,
        bbox_max_i=bbox_max,
        round_ptrs=round_ptrs,
    )
    return nb, color


def batch_to_blob_v2(fb: FixedBatch, color_bc1: np.ndarray) -> bytes:
    nwords = fb.streams.shape[1]
    parts = [
        np.asarray(fb.bbox_min_i, np.int32).tobytes(),
        np.asarray(fb.bbox_max_i, np.int32).tobytes(),
        struct.pack("<i", nwords),
        np.asarray(fb.widths, np.uint8).tobytes(),
        np.asarray(fb.round_ptrs, np.int32).tobytes(),
        np.asarray(fb.start_values, np.int32).tobytes(),
        np.asarray(fb.streams, np.uint32).tobytes(),
        np.asarray(color_bc1, np.uint32).tobytes(),
    ]
    return b"".join(parts)


def blob_to_batch_v2(buf: bytes) -> tuple[FixedBatch, np.ndarray]:
    off = 0

    def take(n, dtype):
        nonlocal off
        a = np.frombuffer(buf, dtype, count=n, offset=off)
        off += a.nbytes
        return a

    bbox_min = take(3, np.int32)
    bbox_max = take(3, np.int32)
    (nwords,) = struct.unpack_from("<i", buf, off)
    off += 4
    widths = take(WORKGROUP_SIZE * 3, np.uint8).reshape(WORKGROUP_SIZE, 3)
    round_ptrs = take(POINTS_PER_THREAD, np.int32)
    start_values = take(WORKGROUP_SIZE * 3, np.int32).reshape(WORKGROUP_SIZE, 3)
    streams = take(TPU_GROUPS_PER_BATCH * nwords, np.uint32).reshape(
        TPU_GROUPS_PER_BATCH, nwords
    )
    color = take((len(buf) - off) // 4, np.uint32)  # width set by color_fmt
    assert off == len(buf), f"tpc2 blob size mismatch {off} != {len(buf)}"
    fb = FixedBatch(
        streams=streams, widths=widths, start_values=start_values,
        bbox_min_i=bbox_min, bbox_max_i=bbox_max, round_ptrs=round_ptrs,
    )
    return fb, color


class TpcHeader:
    def __init__(self, num_points, num_batches, max_group_words, scale, offset,
                 las_min, las_max, batch_sizes, batch_offsets, version=1,
                 color_fmt="bc1"):
        self.num_points = num_points
        self.num_batches = num_batches
        self.max_group_words = max_group_words
        self.scale = scale
        self.offset = offset
        self.las_min = las_min
        self.las_max = las_max
        self.batch_sizes = batch_sizes
        self.batch_offsets = batch_offsets
        self.version = version
        self.color_fmt = color_fmt


def write_tpc(path, batches, colors, scale, offset, las_min, las_max,
              color_fmt="bc1"):
    v2 = batches and isinstance(batches[0], FixedBatch)
    if v2:
        blobs = [batch_to_blob_v2(fb, c) for fb, c in zip(batches, colors)]
        max_group_words = max(fb.streams.shape[1] for fb in batches)
    else:
        blobs = [batch_to_blob(nb, c) for nb, c in zip(batches, colors)]
        max_group_words = max(max(len(s_) for s_ in nb.streams) for nb in batches)
    num_points = len(batches) * POINTS_PER_WORKGROUP
    if color_fmt != "bc1" and not v2:
        raise ValueError("raw/BC7 colors require v2 (fbatch) blobs")
    with open(path, "wb") as f:
        if color_fmt == "bc1":
            f.write(MAGIC2 if v2 else MAGIC)
            f.write(np.asarray([num_points, len(batches), max_group_words],
                               np.int64).tobytes())
        else:
            f.write(MAGIC3)
            f.write(np.asarray(
                [num_points, len(batches), max_group_words,
                 COLOR_FMT_CODES[color_fmt]], np.int64).tobytes())
        for v in (scale, offset, las_min, las_max):
            f.write(np.asarray(v, np.float64).tobytes())
        f.write(np.asarray([len(b) for b in blobs], np.int64).tobytes())
        for b in blobs:
            f.write(b)


def read_tpc_header(path) -> TpcHeader:
    with open(path, "rb") as f:
        magic = f.read(4)
        assert magic in (MAGIC, MAGIC2, MAGIC3), f"not a TPC file: {magic!r}"
        cfmt = "bc1"
        extra = 0
        if magic == MAGIC3:
            num_points, num_batches, max_gw, code = np.frombuffer(
                f.read(32), np.int64)
            cfmt = COLOR_FMT_NAMES[int(code)]
            extra = 8
        else:
            num_points, num_batches, max_gw = np.frombuffer(
                f.read(24), np.int64)
        vals = np.frombuffer(f.read(8 * 12), np.float64)
        sizes = np.frombuffer(f.read(8 * num_batches), np.int64)
    base = 4 + 24 + extra + 96 + 8 * num_batches
    offsets = base + np.concatenate([[0], np.cumsum(sizes[:-1])])
    return TpcHeader(
        int(num_points), int(num_batches), int(max_gw), vals[0:3], vals[3:6],
        vals[6:9], vals[9:12], sizes, offsets,
        version=1 if magic == MAGIC else 2,
        color_fmt=cfmt,
    )


def read_tpc_batch(path, header: TpcHeader, index: int):
    with open(path, "rb") as f:
        f.seek(int(header.batch_offsets[index]))
        buf = f.read(int(header.batch_sizes[index]))
    return blob_to_batch_v2(buf) if header.version == 2 else blob_to_batch(buf)


def decode_tpc_batch_coords(batch) -> np.ndarray:
    """Version-generic CPU decode of a `.tpc` batch -> (65536,3) i32."""
    from ..codec.fixed import decode_fixed_batch
    from ..codec.native import decode_native_batch

    if isinstance(batch, FixedBatch):
        return decode_fixed_batch(batch)
    return decode_native_batch(batch)


def transcode_huffman_to_tpc(huffman_path: str, tpc_path: str, verbose=True,
                             codec: str = "fixed", workers: int | None = None):
    """Reference `.huffman` -> `.tpc`: decode each batch with the CPU
    codec and re-encode in the TPU-native layout (decoded coordinates
    are bit-identical; colors are passed through unchanged).

    Batches are independent, so the transcode runs on a thread pool
    (the C++ codec core releases the GIL across its ctypes calls) and
    blobs append to the output file as their turn comes — O(workers)
    memory at any scene size; the header's size table is backfilled at
    the end.  Reference ingest analogue: HuffmanLasLoader.cpp:81-149.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ..codec.batch_codec import decode_batch, deltas_to_coords
    from ..codec.fixed import encode_fixed_batch
    from ..formats.huffman_file import read_batch, read_file_header
    from .. import native as _ncore

    encode = encode_fixed_batch if codec == "fixed" else encode_native_batch
    v2 = codec == "fixed"
    hdr = read_file_header(huffman_path)
    nb = hdr.num_batches
    workers = workers or min(8, os.cpu_count() or 1)

    meta = {}

    def one(i: int):
        b = read_batch(huffman_path, hdr, i)
        if v2 and _ncore.available():
            # fused C++ decode + fbatch re-encode (the decoded reference
            # deltas ARE the fixed codec's chain deltas): 6.4 -> 16.8
            # Mpts/s per core on the bench scene
            from ..codec.fixed import FixedBatch

            st, wdt, pt, mn, mx = _ncore.transcode_ref_batch(b)
            fb = FixedBatch(
                streams=st, widths=wdt,
                start_values=np.asarray(b.start_values,
                                        np.int32).reshape(-1, 3),
                bbox_min_i=mn, bbox_max_i=mx, round_ptrs=pt)
        else:
            if _ncore.available():
                deltas = _ncore.decode_ref_batch_deltas(
                    b.encoding, b.cluster_sizes, b.separate,
                    b.separate_sizes, b.decoder_values, b.decoder_cw_len,
                )
            else:
                deltas = decode_batch(
                    b.encoding, b.cluster_sizes, b.separate,
                    b.separate_sizes, b.decoder_values, b.decoder_cw_len,
                )
            coords = deltas_to_coords(deltas, b.start_values)
            fb = encode(coords[:, 0], coords[:, 1], coords[:, 2])
        color = np.asarray(b.color, np.uint32)
        blob = batch_to_blob_v2(fb, color) if v2 else batch_to_blob(fb, color)
        gw = (fb.streams.shape[1] if v2
              else max(len(s_) for s_ in fb.streams))
        if i == 0:
            meta.update(scale=b.las_scale, offset=b.las_offset,
                        las_min=b.las_min, las_max=b.las_max)
        return blob, gw

    sizes = np.zeros(nb, np.int64)
    max_gw = 0
    magic = MAGIC2 if v2 else MAGIC
    hdr_fixed = 4 + 24 + 96  # magic + 3 i64 + 12 f64
    with open(tpc_path, "wb") as f:
        f.seek(hdr_fixed + 8 * nb)  # blobs start after the size table
        with ThreadPoolExecutor(max_workers=workers) as pool:
            # bounded submission window: completed-but-unwritten blobs
            # never exceed ~2x workers, whatever the scene size
            from collections import deque

            window: deque = deque()
            nxt = 0
            for i in range(nb):
                while nxt < min(nb, i + 2 * workers):
                    window.append(pool.submit(one, nxt))
                    nxt += 1
                blob, gw = window.popleft().result()
                f.write(blob)
                sizes[i] = len(blob)
                max_gw = max(max_gw, gw)
                if verbose and i % 200 == 0:
                    print(f"transcode {i}/{nb}")
        f.seek(0)
        f.write(magic)
        f.write(np.asarray([nb * POINTS_PER_WORKGROUP, nb, max_gw],
                           np.int64).tobytes())
        for k in ("scale", "offset", "las_min", "las_max"):
            f.write(np.asarray(meta[k], np.float64).tobytes())
        f.write(sizes.tobytes())
    return tpc_path
