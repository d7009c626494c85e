"""LAS point-cloud file IO (reader mirrors the reference's field usage,

reference: src/preprocess.cpp:74-171).  Also a minimal LAS 1.2 writer
used for synthetic test data.  The port's copy of
`pcrhpg24_tpu/formats/las.py`; LAZ files read through `formats/laz.py`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_RGB_OFFSET = {2: 20, 3: 28, 7: 30, 8: 30}


@dataclass
class LasHeader:
    version: tuple[int, int]
    point_format: int
    record_length: int
    offset_to_points: int
    num_points: int
    scale: np.ndarray
    offset: np.ndarray
    cmin: np.ndarray
    cmax: np.ndarray
    compressed: bool = False  # LAZ (laszip) stream


@dataclass
class LasPoints:
    """XYZ as raw int32 grid coords + packed u32 color (R | G<<8 | B<<16)."""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    color: np.ndarray
    header: LasHeader


def read_header(path: str) -> LasHeader:
    with open(path, "rb") as f:
        hdr = f.read(375)
    version = (hdr[24], hdr[25])
    offset_to_points = struct.unpack_from("<I", hdr, 96)[0]
    point_format = hdr[104] & 0x3F
    record_length = struct.unpack_from("<H", hdr, 105)[0]
    if version[0] == 1 and version[1] <= 3:
        num_points = struct.unpack_from("<I", hdr, 107)[0]
    else:
        num_points = struct.unpack_from("<q", hdr, 247)[0]
    scale = np.array(struct.unpack_from("<3d", hdr, 131))
    offset = np.array(struct.unpack_from("<3d", hdr, 155))
    max_x, min_x, max_y, min_y, max_z, min_z = struct.unpack_from("<6d", hdr, 179)
    return LasHeader(
        version,
        point_format,
        record_length,
        offset_to_points,
        num_points,
        scale,
        offset,
        np.array([min_x, min_y, min_z]),
        np.array([max_x, max_y, max_z]),
        compressed=bool(hdr[104] & 0x80),
    )


def read_points(path: str, first: int = 0, count: int | None = None) -> LasPoints:
    """Read [first, first+count) points into int32 XYZ + u32 color.

    16-bit RGB samples are divided by 256 when any channel exceeds 255
    (the reference's per-channel heuristic, preprocess.cpp:150-152).
    """
    h = read_header(path)
    if h.compressed:
        from .laz import read_laz_points

        return read_laz_points(path, first, count)
    n = h.num_points - first if count is None else min(count, h.num_points - first)
    rl = h.record_length
    with open(path, "rb") as f:
        f.seek(h.offset_to_points + first * rl)
        raw = np.frombuffer(f.read(n * rl), np.uint8).reshape(n, rl)

    xyz = raw[:, 0:12].copy().view(np.int32).reshape(n, 3)
    ro = _RGB_OFFSET.get(h.point_format)
    if ro is not None and rl >= ro + 6:
        rgb16 = raw[:, ro : ro + 6].copy().view(np.uint16).reshape(n, 3).astype(np.uint32)
        rgb = np.where(rgb16 > 255, rgb16 // 256, rgb16)
    else:
        rgb = np.zeros((n, 3), np.uint32)
    color = rgb[:, 0] | (rgb[:, 1] << 8) | (rgb[:, 2] << 16)
    return LasPoints(xyz[:, 0], xyz[:, 1], xyz[:, 2], color, h)


def write_las(
    path: str,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    rgb: np.ndarray,
    scale=(0.001, 0.001, 0.001),
    offset=(0.0, 0.0, 0.0),
) -> None:
    """Write LAS 1.2 point-format-2 (int32 grid coords, 8-bit-in-16 RGB)."""
    n = len(x)
    scale = np.asarray(scale, np.float64)
    offset = np.asarray(offset, np.float64)
    record_length = 26
    header_size = 227

    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24] = 1
    hdr[25] = 2
    struct.pack_into("<B", hdr, 94, header_size & 0xFF)
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<I", hdr, 96, header_size)
    hdr[104] = 2
    struct.pack_into("<H", hdr, 105, record_length)
    struct.pack_into("<I", hdr, 107, n)
    struct.pack_into("<3d", hdr, 131, *scale)
    struct.pack_into("<3d", hdr, 155, *offset)
    wx = x.astype(np.float64) * scale[0] + offset[0]
    wy = y.astype(np.float64) * scale[1] + offset[1]
    wz = z.astype(np.float64) * scale[2] + offset[2]
    struct.pack_into(
        "<6d", hdr, 179, wx.max(), wx.min(), wy.max(), wy.min(), wz.max(), wz.min()
    )

    rec = np.zeros((n, record_length), np.uint8)
    rec[:, 0:12] = (
        np.stack([x, y, z], axis=1).astype(np.int32).view(np.uint8).reshape(n, 12)
    )
    rgb16 = np.asarray(rgb, np.uint16)  # 8-bit values stored as-is (<=255)
    rec[:, 20:26] = rgb16.view(np.uint8).reshape(n, 6)

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(rec.tobytes())
