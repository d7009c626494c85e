"""Minimal single-channel float32 EXR writer (no compression).

A copy of `pcrhpg24_tpu/utils/exr.py`, the counterpart of the
reference's tinyexr depth dump (reference:
modules/huffman_mem_iter_cuda/huffman_mem_iter_cuda.h:67-110
saveSingleChannelEXR): one "Z" float channel, scanline storage.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_VERSION = 2


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr_z(path: str, depth: np.ndarray) -> None:
    """depth: (H, W) float32 -> uncompressed single-channel EXR."""
    h, w = depth.shape
    depth = np.ascontiguousarray(depth, np.float32)

    # channel list: one channel "Z", float (2), sampling 1,1
    chan = b"Z\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1) + b"\x00"
    header = b"".join(
        [
            _attr(b"channels", b"chlist", chan),
            _attr(b"compression", b"compression", b"\x00"),  # none
            _attr(b"dataWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)),
            _attr(b"displayWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)),
            _attr(b"lineOrder", b"lineOrder", b"\x00"),  # increasing y
            _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
            _attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0)),
            _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        # offset table: one entry per scanline
        table_pos = f.tell()
        line_data_start = table_pos + 8 * h
        line_size = 8 + 4 * w  # y + size + pixels
        offsets = [line_data_start + i * line_size for i in range(h)]
        f.write(np.asarray(offsets, np.uint64).tobytes())
        for y in range(h):
            f.write(struct.pack("<ii", y, 4 * w))
            f.write(depth[y].tobytes())


def read_exr_z(path: str) -> np.ndarray:
    """Read back a file written by write_exr_z (validation helper)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, _ver = struct.unpack_from("<ii", buf, 0)
    assert magic == _MAGIC
    # find dataWindow for dims
    i = buf.index(b"dataWindow")
    i = buf.index(b"box2i", i) + 6
    (size,) = struct.unpack_from("<I", buf, i)
    x0, y0, x1, y1 = struct.unpack_from("<4i", buf, i + 4)
    w, h = x1 - x0 + 1, y1 - y0 + 1
    # header ends at double NUL; find the offset table by scanning from
    # the end of the last attribute: simpler — offsets point at lines
    # whose first int is y; locate first line by its known layout
    # (offset table entries are increasing u64 past EOF-h*linesize)
    line_size = 8 + 4 * w
    data_start = len(buf) - h * line_size
    out = np.empty((h, w), np.float32)
    for yy in range(h):
        y, sz = struct.unpack_from("<ii", buf, data_start + yy * line_size)
        out[y] = np.frombuffer(
            buf, np.float32, w, data_start + yy * line_size + 8
        )
    return out
