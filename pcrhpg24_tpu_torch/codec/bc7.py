"""BC7 mode-6 colour block codec, NumPy-vectorized.

The decoder mirrors the reference GPU decoder bit-for-bit
(reference: modules/huffman_mem_iter_cuda/render.cu:67-154 decode_bc7):
7-bit endpoints + shared p-bits, 4-bit indices with weight
round(idx * 64 / 15), including its anchor-index quirk (index 0 is read
as `(hi >> 0) & 0xF` = p1 | s00 << 1, i.e. the 3-bit anchor arrives
doubled).  The encoder accounts for that quirk by storing s00 = idx0 >> 1.

Block: 16 bytes = u64 lo | u64 hi
  lo: mode(7)=0x40 | r0:7 r1:7 g0:7 g1:7 b0:7 b1:7 a0:7 a1:7 | p0:1
  hi: p1:1 | s00:3 | s10:4 ... s33:4

A copy of `pcrhpg24_tpu/codec/bc7.py`.  `decode_bc7` is the reference's
as it stands; `encode_bc7` computes every block at once where the
reference loops over blocks in Python (`bc7.py:47-84`), and writes the
same words: the same endpoints, majority p-bit, palette and first-minimum
index per point (integer squared distances, exact in either).
"""

from __future__ import annotations

import numpy as np

_W = np.round(np.arange(16) * 64.0 / 15.0).astype(np.int64)  # linspace_idx


def encode_bc7(colors_rgba: np.ndarray) -> np.ndarray:
    """(N,) u32 R|G<<8|B<<16 -> (N/16 * 4,) u32 blocks (mode 6)."""
    n = len(colors_rgba)
    assert n % 16 == 0
    nb = n // 16
    c = colors_rgba.astype(np.uint32)
    rgb = np.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], -1)
    blocks = rgb.reshape(nb, 16, 3).astype(np.float64)

    lo = blocks.min(axis=1)
    hi = blocks.max(axis=1)
    axis = hi - lo
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(norm > 0, axis / np.maximum(norm, 1e-9), 1.0)
    proj = np.einsum("bpc,bc->bp", blocks, axis)
    bi = np.arange(nb)
    e0 = blocks[bi, np.argmin(proj, axis=1)]
    e1 = blocks[bi, np.argmax(proj, axis=1)]

    v0 = np.clip(np.round(e0), 0, 255).astype(np.int64)  # (nb, 3)
    v1 = np.clip(np.round(e1), 0, 255).astype(np.int64)
    c0_7, c1_7 = v0 >> 1, v1 >> 1
    # the shared p bit is the majority of e0's three low bits; p1 = 0
    p0 = ((v0 & 1).sum(axis=1) >= 2).astype(np.int64)  # (nb,)
    x0 = (c0_7 << 1) | p0[:, None]
    x1 = c1_7 << 1
    pal = (x0[:, None, :] * (64 - _W)[None, :, None]
           + x1[:, None, :] * _W[None, :, None] + 32) >> 6  # (nb, 16 weights, 3)
    pts = rgb.reshape(nb, 16, 3).astype(np.int32)
    pal = pal.astype(np.int32)
    dist = np.zeros((nb, 16, 16), np.int32)  # (block, point, weight)
    for ch in range(3):
        d = pts[:, :, None, ch] - pal[:, None, :, ch]
        dist += d * d
    idx = np.argmin(dist, axis=2).astype(np.uint64)  # the first minimum

    lo64 = np.full(nb, 0x40, np.uint64)  # mode 6
    for k, v in enumerate((c0_7[:, 0], c1_7[:, 0], c0_7[:, 1], c1_7[:, 1],
                           c0_7[:, 2], c1_7[:, 2])):
        lo64 |= v.astype(np.uint64) << np.uint64(7 + 7 * k)
    lo64 |= p0.astype(np.uint64) << np.uint64(63)
    # anchor quirk: the stored 3 bits decode as idx0 = 2*s00, so store
    # the nearest even index (max weight error: 1/15 step)
    hi64 = (idx[:, 0] >> np.uint64(1)) << np.uint64(1)
    for i in range(1, 16):
        hi64 |= idx[:, i] << np.uint64(4 * i)

    out = np.empty((nb, 4), np.uint32)
    mask = np.uint64(0xFFFFFFFF)
    out[:, 0] = lo64 & mask
    out[:, 1] = lo64 >> np.uint64(32)
    out[:, 2] = hi64 & mask
    out[:, 3] = hi64 >> np.uint64(32)
    return out.reshape(-1)


def decode_bc7(blocks: np.ndarray, point_ids: np.ndarray) -> np.ndarray:
    """Mirror of render.cu:122-154 (incl. the anchor doubling quirk)."""
    pid = np.asarray(point_ids, np.int64)
    block_id = pid // 16
    local = pid % 16
    w = blocks.astype(np.uint64)
    lo = w[block_id * 4] | (w[block_id * 4 + 1] << np.uint64(32))
    hi = w[block_id * 4 + 2] | (w[block_id * 4 + 3] << np.uint64(32))

    def fld(x, off, n):
        return ((x >> np.uint64(off)) & np.uint64((1 << n) - 1)).astype(np.int64)

    p0 = fld(lo, 63, 1)
    p1 = fld(hi, 0, 1)
    r0 = (fld(lo, 7, 7) << 1) | p0
    r1 = (fld(lo, 14, 7) << 1) | p1
    g0 = (fld(lo, 21, 7) << 1) | p0
    g1 = (fld(lo, 28, 7) << 1) | p1
    b0 = (fld(lo, 35, 7) << 1) | p0
    b1 = (fld(lo, 42, 7) << 1) | p1

    idx = ((hi >> (np.uint64(4) * local.astype(np.uint64))) & np.uint64(0xF)).astype(np.int64)
    idx = np.where(idx == 0, idx >> 1, idx)  # render.cu:143 (no-op quirk)
    wgt = _W[idx]
    iw = 64 - wgt

    r = (r0 * iw + r1 * wgt + 32) >> 6
    g = (g0 * iw + g1 * wgt + 32) >> 6
    b = (b0 * iw + b1 * wgt + 32) >> 6
    return (
        (r & 0xFF).astype(np.uint32)
        | ((g & 0xFF).astype(np.uint32) << 8)
        | ((b & 0xFF).astype(np.uint32) << 16)
    )
