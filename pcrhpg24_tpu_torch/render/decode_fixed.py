"""fbatch (`.tpc` v2) geometry decode: kernel B1 and its plain version.

Counterpart of `pcrhpg24_tpu/render/pallas_decode_fixed.py`.  The CUDA
kernel (`csrc/decode_fixed.cu`) replaces `_decode_fixed_kernel`;
`decode_fixed_plain` mirrors the portable XLA decoder
`native_decode_xla.decode_fixed_xla` op for op.  Layouts are the
reference's: u32 stream words travel as int32 bits (`u32.from_u32`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import POINTS_PER_THREAD, TPU_GROUPS_PER_BATCH
from ..kernels.build import I, P, Kernel, check_cuda
from ..u32 import MASK32, widen

G = TPU_GROUPS_PER_BATCH  # 8
LANES = 128
PTS = POINTS_PER_THREAD  # 64

DECODE_FIXED = Kernel("pcr_decode_fixed", [P, P, P, P, P, I, I, I])


def pack_fixed_batches(batches, maxt: int | None = None):
    """[FixedBatch] -> dict of kernel input arrays (NumPy), as
    `pallas_decode_fixed.pack_fixed_batches`: widths (B,3,8,128) i32,
    streams (B,maxt,8,128) u32 tile-transposed, ptrs (B,1,64) i32,
    starts (B,3,8,128) i32.  `maxt` defaults to the widest stream's
    tiles + 4 (the reference kernel's overread pad)."""
    B = len(batches)
    if maxt is None:
        nw = max(fb.streams.shape[1] for fb in batches)
        maxt = -(-nw // LANES) + 4
    widths = np.zeros((B, 3, G, LANES), np.int32)
    streams = np.zeros((B, maxt, G, LANES), np.uint32)
    ptrs = np.zeros((B, 1, PTS), np.int32)
    starts = np.zeros((B, 3, G, LANES), np.int32)
    for i, fb in enumerate(batches):
        widths[i] = fb.widths.reshape(G, LANES, 3).astype(np.int32).transpose(2, 0, 1)
        nw = fb.streams.shape[1]
        nt = -(-nw // LANES)
        padded = np.zeros((G, nt * LANES), np.uint32)
        padded[:, :nw] = fb.streams
        streams[i, :nt] = padded.reshape(G, nt, LANES).transpose(1, 0, 2)
        ptrs[i, 0] = fb.round_ptrs
        starts[i] = fb.start_values.reshape(G, LANES, 3).transpose(2, 0, 1)
    return dict(widths=widths, streams=streams, ptrs=ptrs, starts=starts)


def _extract(win, off, w):
    """Bits [off, off+w) of the 4-word window (int64 words < 2**32)."""
    w0, w1, w2, w3 = win
    word = off >> 5
    sh = off & 31
    lo = torch.where(word == 0, w0, torch.where(word == 1, w1, w2))
    hi = torch.where(word == 0, w1, torch.where(word == 1, w2, w3))
    top = ((lo << sh) & MASK32) | ((hi >> 1) >> (31 - sh))
    v = top >> ((32 - w) & 31)
    return torch.where(w > 0, v, torch.zeros_like(v))


def _unzigzag(z):
    return (z >> 1) ^ -(z & 1)


def decode_fixed_plain(widths, streams, ptrs, starts, points: int = PTS):
    """Pure-torch mirror of `decode_fixed_xla` on any device.

    widths (B,3,8,128) i32, streams (B,maxt,8,128) i32 (u32 bits),
    ptrs (B,1,64) i32, starts (B,3,8,128) i32 -> (B, points, 3, 8, 128)
    i32 absolute coords.  Words are widened to int64 so that shifts are
    logical; coordinate sums wrap mod 2**32 like the reference's int32.
    """
    B = widths.shape[0]
    wx, wy, wz = (widths[:, k].to(torch.int64) for k in range(3))
    W = wx + wy + wz
    sflat = widen(streams).permute(0, 2, 1, 3).reshape(B, G, -1)
    nmax = sflat.shape[2]
    zero = torch.zeros((B, G, LANES), dtype=torch.int64, device=widths.device)
    w0 = w1 = w2 = w3 = zero
    bp = ve = bits = zero
    deltas = []
    for i in range(points):
        bits_next = bits + W
        cnt = ((bits_next + 31) >> 5) - ((bits + 31) >> 5)
        rank = torch.cumsum(cnt, dim=-1) - cnt
        idx0 = ptrs[:, 0, i].to(torch.int64)[:, None, None] + rank
        for j in range(3):
            idx = (idx0 + j).clamp(0, nmax - 1)
            vj = torch.gather(sflat, 2, idx)
            take = cnt > j
            slot = ve + j
            w0 = torch.where(take & (slot == 0), vj, w0)
            w1 = torch.where(take & (slot == 1), vj, w1)
            w2 = torch.where(take & (slot == 2), vj, w2)
            w3 = torch.where(take & (slot == 3), vj, w3)
        ve = ve + cnt
        win = (w0, w1, w2, w3)
        zx = _extract(win, bp, wx)
        zy = _extract(win, bp + wx, wy)
        zz = _extract(win, bp + wx + wy, wz)
        deltas.append(torch.stack([_unzigzag(zx), _unzigzag(zy), _unzigzag(zz)], 1))
        bpn = bp + W
        k = bpn >> 5
        bp = bpn & 31
        ve = ve - k
        w0, w1, w2 = (
            torch.where(k == 0, w0, torch.where(k == 1, w1, torch.where(k == 2, w2, w3))),
            torch.where(k == 0, w1, torch.where(k == 1, w2, w3)),
            torch.where(k == 0, w2, w3),
        )
        bits = bits_next
    d = torch.stack(deltas, 1)  # (B, points, 3, 8, 128) int64
    coords = torch.cumsum(d, dim=1) + starts[:, None].to(torch.int64)
    return coords.to(torch.int32)  # wraps mod 2**32, as int32 sums do


def decode_fixed_batches(widths, streams, ptrs, starts, points: int = PTS):
    """B1: (B,3,8,128) widths, (B,maxt,8,128) stream bits, (B,1,64) ptrs,
    (B,3,8,128) starts -> (B, points, 3, 8, 128) i32 absolute coords.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    `points` < 64 decodes only the LOD prefix of every chain.  The
    kernel stages the stream's 512-byte rows in shared memory with bulk
    copies, so the stream must start 16-byte aligned.
    """
    if not widths.is_cuda:
        return decode_fixed_plain(widths, streams, ptrs, starts, points)
    if not 0 < points <= PTS:
        raise ValueError(f"points must be in 1..{PTS}, got {points}")
    B, maxt = streams.shape[0], streams.shape[1]
    check_cuda("widths", widths, torch.int32, (B, 3, G, LANES))
    check_cuda("streams", streams, torch.int32, (B, maxt, G, LANES))
    check_cuda("ptrs", ptrs, torch.int32, (B, 1, PTS))
    check_cuda("starts", starts, torch.int32, (B, 3, G, LANES))
    if streams.data_ptr() % 16:  # the kernel's bulk copies of 512-byte rows
        raise ValueError("streams must start 16-byte aligned")
    out = torch.empty((B, points, 3, G, LANES), dtype=torch.int32,
                      device=widths.device)
    if B:
        DECODE_FIXED.launch(widths.data_ptr(), streams.data_ptr(),
                            ptrs.data_ptr(), starts.data_ptr(),
                            out.data_ptr(), B, maxt, points)
    return out
