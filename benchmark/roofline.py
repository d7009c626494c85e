"""The card's peaks and the shapes the kernels' byte counts are made of."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet (700 W)
CHUNK = 64  # batches a decode and projection launch covers (`huffman_tpu.CHUNK`)
TILE_PX = 32


def swizzled_size(width: int, height: int) -> int:
    """Pixels of the 32x32-tiled plane the chain layout resolves into."""
    return -(-width // TILE_PX) * -(-height // TILE_PX) * TILE_PX * TILE_PX


def share(bytes_per_frame: float, seconds_per_frame: float) -> float:
    """Percent of the memory roofline: the least time the bytes take at
    the peak over the time the kernel took."""
    return 100.0 * bytes_per_frame / HBM_BYTES_PER_S / seconds_per_frame
