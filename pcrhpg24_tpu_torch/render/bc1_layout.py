"""The colour payloads of the `.tpc` formats, in B2's colour layouts.

Counterpart of `pcrhpg24_tpu/render/bc1_layout.py`: the payload
R | G<<8 | B<<16 of every point (C, points, 8, 128), in the reference's
arithmetic, for the three colour formats of a `.tpc` file (the
reference's COLOR_COMPRESSION 0|1|7, GPU decoders render.cu:23-154).
The reference reads each format from its flat per-batch row; here each
format has a kernel layout of its own, in which the 128 chains of a
group lie side by side, so that B2's warps read consecutive words:

* bc1: (C, 4 blocks, 2 words, 8, 128) — `colors_kernel_layout(c, "bc1")`;
* bc7: (C, 4 blocks, 4 words, 8, 128) — mode 6, `codec/bc7.py`;
* raw: (C, 64 points, 8, 128) — point-major, one word per point.

A row's word order (the files'): point (g, l, i) of a batch is chain
g*128 + l, point i; its block is i // 16.  The `*_payload` functions are
B2's plain versions of each format, on the kernel layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TPU_GROUPS_PER_BATCH
from ..u32 import widen

G = TPU_GROUPS_PER_BATCH  # 8
LANES = 128

# the kernel layout of one batch's colours, by format
COLOR_K_SHAPE = {"bc1": (4, 2, G, LANES), "bc7": (4, 4, G, LANES), "raw": (64, G, LANES)}


def colors_kernel_layout(colors: np.ndarray, color_fmt: str = "bc1") -> np.ndarray:
    """(B, words) u32 rows of `color_fmt` -> (B, *COLOR_K_SHAPE[color_fmt])."""
    B = colors.shape[0]
    if color_fmt == "raw":
        return np.ascontiguousarray(colors.reshape(B, G, LANES, 64).transpose(0, 3, 1, 2))
    words = {"bc1": 2, "bc7": 4}[color_fmt]
    return np.ascontiguousarray(
        colors.reshape(B, G, LANES, 4, words).transpose(0, 3, 4, 1, 2))


def _expand565(c):
    r5 = (c >> 11) & 31
    g6 = (c >> 5) & 63
    b5 = c & 31
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def _block_words(colors_k, points: int):
    """(C, 4, words, 8, 128) u32 bits -> each point's block words, int64
    (C, points, words, 8, 128): point i reads block i // 16."""
    blk = torch.arange(points, device=colors_k.device) >> 4
    return widen(colors_k)[:, blk]


def bc1_payload(colors_k, points: int):
    """(C,4,2,8,128) u32 bits -> (C,points,8,128) int64 R|G<<8|B<<16
    (`bc1_layout.py:19-65`)."""
    words = _block_words(colors_k, points)
    w0, w1 = words[:, :, 0], words[:, :, 1]
    r0, g0, b0 = _expand565(w0 & 0xFFFF)
    r1, g1, b1 = _expand565(w0 >> 16)
    i = torch.arange(points, device=colors_k.device)[None, :, None, None]
    sel = (w1 >> (2 * (i & 15))) & 3

    def chan(a, b):
        return torch.where(
            sel == 0, a,
            torch.where(sel == 1, b,
                        torch.where(sel == 2, (a * 2 + b) // 3, (a + b * 2) // 3)))

    return chan(r0, r1) | (chan(g0, g1) << 8) | (chan(b0, b1) << 16)


def bc7_payload(colors_k, points: int):
    """(C,4,4,8,128) u32 bits of BC7 mode-6 blocks -> (C,points,8,128)
    int64 R|G<<8|B<<16 (`bc1_layout.py:68-98`): the p-bit endpoints,
    the 4-bit index of point i % 16 (the anchor's read with p1 in its low
    bit, render.cu:122-154), its weight (idx*128 + 15) // 30."""
    words = _block_words(colors_k, points)
    w0, w1, w2, w3 = (words[:, :, q] for q in range(4))
    p0 = w1 >> 31
    p1 = w2 & 1
    r0 = (((w0 >> 7) & 0x7F) << 1) | p0
    r1 = (((w0 >> 14) & 0x7F) << 1) | p1
    g0 = (((w0 >> 21) & 0x7F) << 1) | p0
    g1 = ((((w0 >> 28) | (w1 << 4)) & 0x7F) << 1) | p1
    b0 = (((w1 >> 3) & 0x7F) << 1) | p0
    b1 = (((w1 >> 10) & 0x7F) << 1) | p1
    j = (torch.arange(points, device=colors_k.device) & 15)[None, :, None, None]
    idx = (torch.where(j < 8, w2, w3) >> (4 * (j & 7))) & 0xF
    wgt = (idx * 128 + 15) // 30
    iw = 64 - wgt
    r = (r0 * iw + r1 * wgt + 32) >> 6
    g = (g0 * iw + g1 * wgt + 32) >> 6
    b = (b0 * iw + b1 * wgt + 32) >> 6
    return (r & 0xFF) | ((g & 0xFF) << 8) | ((b & 0xFF) << 16)


def raw_payload(colors_k, points: int):
    """(C,64,8,128) u32 bits -> (C,points,8,128) int64 R|G<<8|B<<16
    (`bc1_layout.py:101-106`: the word's low 24 bits)."""
    return widen(colors_k[:, :points]) & 0xFFFFFF


PAYLOAD = {"bc1": bc1_payload, "bc7": bc7_payload, "raw": raw_payload}
