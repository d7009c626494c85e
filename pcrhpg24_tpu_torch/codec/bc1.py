"""BC1 (DXT1) color block codec, NumPy-vectorized.

The decoder is a bit-exact mirror of the reference GPU decoder
(reference: modules/huffman_mem_iter_cuda/render.cu:23-65): 565 endpoint
expansion r8 = (r5<<3)|(r5>>2) etc. and integer (2a+b)/3 interpolation,
always in 4-color mode.  The encoder is our own (the reference vendors
rgbcx, src/rgbcx.cpp); any encoder producing c0 > c1 blocks decodable by
that decoder is format-compatible — quality differs, semantics don't.

Block layout: 16 RGBA8 pixels -> 8 bytes = u16 color0 | u16 color1 |
4 selector bytes (2 bits/pixel, LSB-first).

A copy of `pcrhpg24_tpu/codec/bc1.py`.
"""

from __future__ import annotations

import numpy as np


def _expand565(c: np.ndarray) -> np.ndarray:
    """(B,) u16 -> (B,3) u8-range ints, reference expansion."""
    r5 = (c >> 11) & 31
    g6 = (c >> 5) & 63
    b5 = c & 31
    r = (r5 << 3) | (r5 >> 2)
    g = (g6 << 2) | (g6 >> 4)
    b = (b5 << 3) | (b5 >> 2)
    return np.stack([r, g, b], axis=-1).astype(np.int32)


def _quant565(rgb: np.ndarray) -> np.ndarray:
    """(B,3) int -> (B,) u16 565."""
    r = np.clip(rgb[..., 0], 0, 255).astype(np.uint32) >> 3
    g = np.clip(rgb[..., 1], 0, 255).astype(np.uint32) >> 2
    b = np.clip(rgb[..., 2], 0, 255).astype(np.uint32) >> 3
    return ((r << 11) | (g << 5) | b).astype(np.uint16)


def _palette(c0: np.ndarray, c1: np.ndarray) -> np.ndarray:
    """(B,) u16 x2 -> (B,4,3) int palette with reference interpolation."""
    p0 = _expand565(c0.astype(np.uint32))
    p1 = _expand565(c1.astype(np.uint32))
    p2 = (p0 * 2 + p1) // 3
    p3 = (p0 + p1 * 2) // 3
    return np.stack([p0, p1, p2, p3], axis=1)


def encode_bc1(colors_rgba: np.ndarray) -> np.ndarray:
    """Encode (N, ) u32 RGBA (R | G<<8 | B<<16) -> (N/16 * 2,) u32 blocks.

    Endpoints: extremal pixels along the block's dominant color axis.
    """
    n = len(colors_rgba)
    assert n % 16 == 0
    nb = n // 16
    c = colors_rgba.astype(np.uint32)
    rgb = np.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], axis=-1)
    blocks = rgb.reshape(nb, 16, 3).astype(np.int32)

    lo = blocks.min(axis=1)
    hi = blocks.max(axis=1)
    axis = (hi - lo).astype(np.float64)
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(norm > 0, axis / np.maximum(norm, 1e-9), 1.0)
    proj = np.einsum("bpc,bc->bp", blocks.astype(np.float64), axis)
    imax = np.argmax(proj, axis=1)
    imin = np.argmin(proj, axis=1)
    bi = np.arange(nb)
    c0 = _quant565(blocks[bi, imax])
    c1 = _quant565(blocks[bi, imin])

    # 4-color mode requires c0 > c1 (the reference decoder assumes it)
    swap = c0 < c1
    c0s = np.where(swap, c1, c0)
    c1s = np.where(swap, c0, c1)

    pal = _palette(c0s, c1s)  # (nb,4,3)
    d = blocks[:, :, None, :] - pal[:, None, :, :]
    dist = (d * d).sum(-1)  # (nb,16,4)
    sel = np.argmin(dist, axis=-1).astype(np.uint32)  # (nb,16)
    sel = np.where((c0s == c1s)[:, None], 0, sel)

    shifts = np.arange(16, dtype=np.uint32) * 2
    selword = (sel << shifts[None, :]).astype(np.uint64).sum(axis=1).astype(np.uint32)

    word0 = c0s.astype(np.uint32) | (c1s.astype(np.uint32) << 16)
    out = np.empty(nb * 2, np.uint32)
    out[0::2] = word0
    out[1::2] = selword
    return out


def decode_bc1(blocks: np.ndarray, point_ids: np.ndarray) -> np.ndarray:
    """Decode colors for point indices, mirror of render.cu:23-65.

    `blocks` is the packed u32 array (2 words/block); returns u32 colors
    R | G<<8 | B<<16.
    """
    pid = np.asarray(point_ids, np.int64)
    block_id = pid // 16
    local = pid % 16
    w0 = blocks[block_id * 2].astype(np.uint32)
    w1 = blocks[block_id * 2 + 1].astype(np.uint32)
    c0 = (w0 & 0xFFFF).astype(np.uint32)
    c1 = (w0 >> 16).astype(np.uint32)
    pal = _palette(c0, c1)  # (N,4,3)
    sel = (w1 >> (2 * local).astype(np.uint32)) & 3
    rgb = pal[np.arange(len(pid)), sel]
    return (
        rgb[:, 0].astype(np.uint32)
        | (rgb[:, 1].astype(np.uint32) << 8)
        | (rgb[:, 2].astype(np.uint32) << 16)
    )
