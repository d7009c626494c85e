"""`.huffman` file format: header + concatenated per-batch blobs.

Byte-compatible with the reference (reference: include/BatchDumpData.h:15-256,
src/preprocess.cpp:1205-1234):

  file   = i64 num_points | i64 num_batches | i64 encoding_bytes
         | i64 separate_bytes | i64 cluster_bytes
         | i64 blob_size[num_batches]
         | blob[num_batches]
  blob   = 5 x i32 (point_offset, num_points, num_threads,
                    points_per_thread, clusters_per_thread)
         | 3 x f64 las_scale | 3 x f64 las_offset
         | 3 x f32 bbox_min | 3 x f32 bbox_max
         | 3 x f32 las_min  | 3 x f32 las_max
         | i32 dt_size | i32 num_clusters
         | i32 start_values[num_threads*cpt*3]
         | i32 separate_sizes[num_threads*cpt]
         | i32 decoder_values[dt_size] | i32 decoder_cw_len[dt_size]
         | i32 cluster_sizes[num_clusters]
         | u32 encoding[cluster_sizes[-1]]
         | i32 separate[separate_sizes[-1]]
         | u32 color[num_points/8]            (BC1)

The port's copy of `pcrhpg24_tpu/formats/huffman_file.py`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..constants import (
    CLUSTERS_PER_THREAD,
    COLOR_COMPRESSION,
    HUFFMAN_TABLE_SIZE,
    POINTS_PER_THREAD,
    WORKGROUP_SIZE,
)

_HDR_FMT = "<5i6d12f2i"
_HDR_SIZE = struct.calcsize(_HDR_FMT)  # 4*19 + 8*6 = 124
assert _HDR_SIZE == 4 * 19 + 8 * 6


@dataclass
class BatchDump:
    point_offset: int
    num_points: int
    num_threads: int
    points_per_thread: int
    clusters_per_thread: int
    las_scale: np.ndarray  # (3,) f64
    las_offset: np.ndarray  # (3,) f64
    bbox_min: np.ndarray  # (3,) f32, world coords
    bbox_max: np.ndarray
    las_min: np.ndarray  # (3,) f32
    las_max: np.ndarray
    start_values: np.ndarray  # i32
    separate_sizes: np.ndarray  # i32 inclusive prefix
    decoder_values: np.ndarray  # i32
    decoder_cw_len: np.ndarray  # i32
    cluster_sizes: np.ndarray  # i32 inclusive prefix
    encoding: np.ndarray  # u32
    separate: np.ndarray  # i32
    color: np.ndarray  # u32

    def to_bytes(self) -> bytes:
        hdr = struct.pack(
            _HDR_FMT,
            self.point_offset,
            self.num_points,
            self.num_threads,
            self.points_per_thread,
            self.clusters_per_thread,
            *np.asarray(self.las_scale, np.float64),
            *np.asarray(self.las_offset, np.float64),
            *np.asarray(self.bbox_min, np.float32),
            *np.asarray(self.bbox_max, np.float32),
            *np.asarray(self.las_min, np.float32),
            *np.asarray(self.las_max, np.float32),
            len(self.decoder_values),
            len(self.cluster_sizes),
        )
        parts = [
            hdr,
            np.asarray(self.start_values, np.int32).tobytes(),
            np.asarray(self.separate_sizes, np.int32).tobytes(),
            np.asarray(self.decoder_values, np.int32).tobytes(),
            np.asarray(self.decoder_cw_len, np.int32).tobytes(),
            np.asarray(self.cluster_sizes, np.int32).tobytes(),
            np.asarray(self.encoding, np.uint32).tobytes(),
            np.asarray(self.separate, np.int32).tobytes(),
            np.asarray(self.color, np.uint32).tobytes(),
        ]
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "BatchDump":
        vals = struct.unpack_from(_HDR_FMT, buf, 0)
        (po, npts, nthreads, ppt, cpt) = vals[:5]
        las_scale = np.array(vals[5:8])
        las_offset = np.array(vals[8:11])
        bbox_min = np.array(vals[11:14], np.float32)
        bbox_max = np.array(vals[14:17], np.float32)
        las_min = np.array(vals[17:20], np.float32)
        las_max = np.array(vals[20:23], np.float32)
        dt_size, num_clusters = vals[23:25]

        off = _HDR_SIZE
        nchains = nthreads * cpt

        def take(n, dtype):
            nonlocal off
            arr = np.frombuffer(buf, dtype, count=n, offset=off)
            off += 4 * n
            return arr

        start_values = take(nchains * 3, np.int32)
        separate_sizes = take(nchains, np.int32)
        decoder_values = take(dt_size, np.int32)
        decoder_cw_len = take(dt_size, np.int32)
        cluster_sizes = take(num_clusters, np.int32)
        encoding = take(int(cluster_sizes[-1]), np.uint32)
        separate = take(int(separate_sizes[-1]), np.int32)
        if COLOR_COMPRESSION == 0:
            color = take(npts, np.uint32)
        elif COLOR_COMPRESSION == 1:
            color = take(npts // 8, np.uint32)
        else:
            color = take(npts // 4, np.uint32)
        assert off == len(buf), f"batch blob size mismatch: {off} != {len(buf)}"
        return cls(
            po, npts, nthreads, ppt, cpt, las_scale, las_offset,
            bbox_min, bbox_max, las_min, las_max, start_values,
            separate_sizes, decoder_values, decoder_cw_len, cluster_sizes,
            encoding, separate, color,
        )


@dataclass
class HuffmanFileHeader:
    num_points: int
    num_batches: int
    encoding_bytes: int
    separate_bytes: int
    cluster_bytes: int
    batch_sizes: np.ndarray  # (num_batches,) i64
    batch_offsets: np.ndarray  # (num_batches,) i64, absolute file offsets


def read_file_header(path: str) -> HuffmanFileHeader:
    """Mirror of HuffmanLasData::loadHeader (HuffmanLasLoader.h:57-85)."""
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(40), np.int64)
        num_points, num_batches, eb, sb, cb = (int(v) for v in head)
        sizes = np.frombuffer(f.read(8 * num_batches), np.int64)
    offsets = 40 + 8 * num_batches + np.concatenate([[0], np.cumsum(sizes[:-1])])
    return HuffmanFileHeader(num_points, num_batches, eb, sb, cb, sizes, offsets)


def read_batch(path: str, header: HuffmanFileHeader, index: int) -> BatchDump:
    with open(path, "rb") as f:
        f.seek(int(header.batch_offsets[index]))
        buf = f.read(int(header.batch_sizes[index]))
    return BatchDump.from_bytes(buf)


def write_huffman_file(path: str, batches: list[BatchDump]) -> None:
    blobs = [b.to_bytes() for b in batches]
    num_points = sum(b.num_points for b in batches)
    encoding_bytes = sum(4 * len(b.encoding) for b in batches)
    separate_bytes = sum(4 * len(b.separate) for b in batches)
    cluster_bytes = sum(4 * len(b.cluster_sizes) for b in batches)
    with open(path, "wb") as f:
        f.write(
            np.array(
                [num_points, len(batches), encoding_bytes, separate_bytes, cluster_bytes],
                np.int64,
            ).tobytes()
        )
        f.write(np.array([len(b) for b in blobs], np.int64).tobytes())
        for blob in blobs:
            f.write(blob)
