"""Minimal dependency-free PNG writer (replaces the reference's stb

screenshot path, Renderer.cpp:94-107).  A copy of
`pcrhpg24_tpu/utils/png.py`."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png_bytes(rgb: np.ndarray, level: int = 6) -> bytes:
    """rgb: (H, W, 3) u8 -> PNG file contents.

    `level` is the zlib effort: 6 for screenshots on disk, 1 for the
    interactive viewer (encode is on the frame's critical path there).
    """
    h, w, _ = rgb.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(rgb).reshape(h, -1)],
        axis=1,
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb: (H, W, 3) u8."""
    with open(path, "wb") as f:
        f.write(write_png_bytes(rgb))
