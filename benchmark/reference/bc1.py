"""Frozen copy of the BC1 colour codec a `.tpc` scene's reference needs
(encoder: extremal pixels along the block's colour axis, 4-colour mode;
decoder: the reference system's render.cu:23-65), in NumPy alone, so
that the worker processes that run it load nothing else."""

from __future__ import annotations

import numpy as np

BATCH = 65536


def _expand565(c):
    r5 = (c >> 11) & 31
    g6 = (c >> 5) & 63
    b5 = c & 31
    return np.stack([(r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)],
                    axis=-1).astype(np.int32)


def _quant565(rgb):
    r = np.clip(rgb[..., 0], 0, 255).astype(np.uint32) >> 3
    g = np.clip(rgb[..., 1], 0, 255).astype(np.uint32) >> 2
    b = np.clip(rgb[..., 2], 0, 255).astype(np.uint32) >> 3
    return ((r << 11) | (g << 5) | b).astype(np.uint16)


def _palette(c0, c1):
    p0 = _expand565(c0.astype(np.uint32))
    p1 = _expand565(c1.astype(np.uint32))
    return np.stack([p0, p1, (p0 * 2 + p1) // 3, (p0 + p1 * 2) // 3], axis=1)


def bc1_colors(colors):
    """(N,) u32 R|G<<8|B<<16, N a multiple of 16 -> each point's colour
    after a BC1 round trip, blocks of 16 consecutive points."""
    nb = len(colors) // 16
    c = colors.astype(np.uint32)
    blocks = np.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], axis=-1)
    blocks = blocks.reshape(nb, 16, 3).astype(np.int32)
    lo = blocks.min(axis=1)
    hi = blocks.max(axis=1)
    axis = (hi - lo).astype(np.float64)
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(norm > 0, axis / np.maximum(norm, 1e-9), 1.0)
    proj = np.einsum("bpc,bc->bp", blocks.astype(np.float64), axis)
    bi = np.arange(nb)
    c0 = _quant565(blocks[bi, np.argmax(proj, axis=1)])
    c1 = _quant565(blocks[bi, np.argmin(proj, axis=1)])
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    pal = _palette(c0, c1)
    d = blocks[:, :, None, :] - pal[:, None, :, :]
    sel = np.argmin((d * d).sum(-1), axis=-1)
    sel = np.where((c0 == c1)[:, None], 0, sel)
    rgb = pal[bi[:, None], sel]  # (nb, 16, 3)
    out = rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16)
    return out.reshape(-1).astype(np.uint32)


def bc1_batches(colors):
    """Each point's colour after its batch's BC1 round trip, for a run of
    whole 65,536-point batches."""
    return np.concatenate([bc1_colors(colors[s:s + BATCH]) for s in range(0, len(colors), BATCH)])
