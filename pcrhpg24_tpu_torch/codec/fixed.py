"""TPU-native fixed-width geometry codec ("fbatch", `.tpc` v2).

Round-2 successor of the bucket-Huffman tbatch codec (codec/native.py),
trading ~13% compression (44.8 vs 39.7 bits/pt on the bench terrain,
experiments/r2_codec_ratio.py) for a decode loop with NO data-dependent
bit lengths: every chain stores its three per-component zigzag deltas at
a fixed per-chain width (the max bit-length over the chain's 64 deltas),
so the Pallas kernel needs no canonical-code compare ladder, no
bucket-LUT gather, and only ONE refill round per point instead of six
(reference decode equivalent: modules/huffman_mem_iter_cuda/
render.cu:428-466; its per-symbol table decode becomes a fixed-shift
field extract here).

Per-chain layout (width w_x + w_y + w_z = W <= 96 bits per point):

  point i occupies bits [i*W, (i+1)*W) of the chain's bitstream,
  components in x,y,z order, MSB-first within each 32-bit word.

Group interleave (the TPU analogue of the reference's warp interleave,
preprocess.cpp:540-587): the 128 chains of a group share one u32 word
stream, ordered by decode-consumption rounds.  Round i (= point i) takes
for every lane, in lane order, the lane's words
[ceil(i*W/32), ceil((i+1)*W/32)) — a "lazy" refill: exactly the words
whose bits point i reads, so padded tails cost nothing.

All 8 group streams share UNIFORM round boundaries: round i of every
group starts at word round_ptrs[i] (each group's round is zero-padded to
the widest group's count, +3.8% size on the bench terrain,
experiments/r2_codec_ratio.py).  This lets the kernel load refill
windows as whole (8, 128) tiles at one scalar base — 4 aligned tile
loads per point instead of 8 groups x 4 per-row loads.

Decode protocol (must match the Pallas kernel bit-for-bit):
  state: window w0..w3 (u32), bp in [0,32) bit offset into w0,
         ve = valid words in window.
  per point: refill (take count_i = ceil((i+1)W/32)-ceil(iW/32) words
  from the group stream at round_ptrs[i] + lane-rank, placing them at
  window slots [ve, ve+count)); extract x,y,z at bit offsets bp,
  bp+w_x, bp+w_x+w_y; bp += W; shift window down by bp>>5 words;
  bp &= 31.

A copy of `pcrhpg24_tpu/codec/fixed.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import POINTS_PER_THREAD, TPU_GROUP_SIZE, TPU_GROUPS_PER_BATCH

GROUP = TPU_GROUP_SIZE  # 128 lanes per group stream
NGROUPS = TPU_GROUPS_PER_BATCH  # 8
P = POINTS_PER_THREAD  # 64 points per chain


def zigzag32(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int32)
    return ((v.astype(np.uint32) << np.uint32(1)) ^ (v >> 31).astype(np.uint32))


def unzigzag32(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint32)
    return ((z >> np.uint32(1)).astype(np.int32)) ^ -(z & np.uint32(1)).astype(
        np.int32
    )


def _bitlen32(z: np.ndarray) -> np.ndarray:
    out = np.zeros(z.shape, np.int32)
    tmp = z.astype(np.uint32).copy()
    for shift in (16, 8, 4, 2, 1):
        big = tmp >= (np.uint32(1) << np.uint32(shift))
        out += big * shift
        tmp = np.where(big, tmp >> np.uint32(shift), tmp)
    return out + (z != 0)


@dataclass
class FixedBatch:
    """Encoded fbatch geometry."""

    streams: np.ndarray  # (8, nwords) u32 interleaved group streams
    widths: np.ndarray  # (1024, 3) u8 per-chain component bit widths
    start_values: np.ndarray  # (1024, 3) i32
    bbox_min_i: np.ndarray
    bbox_max_i: np.ndarray
    round_ptrs: np.ndarray  # (P,) i32 uniform round base word index

    @property
    def total_words(self) -> int:
        return self.streams.size


def encode_fixed_batch(x, y, z) -> "FixedBatch":
    from .batch_codec import chain_deltas

    deltas, starts = chain_deltas(x, y, z)  # (1024, 192) i64, (1024, 3)

    # fast path: byte-identical C++ core (native/codec_core.cpp)
    from .. import native as _ncore

    if _ncore.available():
        maxw = 16384
        out = None
        while out is None:
            out = _ncore.encode_fixed_batch_streams(
                deltas.astype(np.int32), maxw
            )
            maxw *= 2
        streams_c, widths_c, ptrs_c = out
        return FixedBatch(
            streams=streams_c,
            widths=widths_c,
            start_values=starts.astype(np.int32),
            bbox_min_i=np.array([x.min(), y.min(), z.min()], np.int32),
            bbox_max_i=np.array([x.max(), y.max(), z.max()], np.int32),
            round_ptrs=ptrs_c,
        )

    zz = zigzag32(deltas.astype(np.int32)).reshape(1024, P, 3)
    widths = _bitlen32(zz).max(axis=1)  # (1024, 3)
    W = widths.sum(axis=1)  # (1024,) bits per point, <= 96

    # --- pack each lane's bitstream (vectorized over all symbols) ---
    wx = widths[:, 0:1]
    wy = widths[:, 1:2]
    comp_off = np.concatenate(
        [np.zeros_like(wx), wx, wx + wy], axis=1
    )  # (1024, 3)
    pt = np.arange(P, dtype=np.int64)
    bitpos = (pt[None, :, None] * W[:, None, None] + comp_off[:, None, :])
    nwords = (P * W.astype(np.int64) + 31) // 32  # (1024,)
    maxw = int(nwords.max()) + 1
    words64 = np.zeros((1024, maxw + 1), np.uint64)
    wsym = np.broadcast_to(widths[:, None, :], zz.shape).astype(np.int64)
    lane_idx = np.broadcast_to(np.arange(1024)[:, None, None], zz.shape)
    w0 = (bitpos >> 5).astype(np.int64)
    sh = (bitpos & 31).astype(np.int64)
    # value contributes to words w0 and w0+1: place in a 64-bit window
    chunk = zz.astype(np.uint64) << (64 - sh - wsym).astype(np.uint64)
    np.bitwise_or.at(words64, (lane_idx, w0), chunk >> np.uint64(32))
    np.bitwise_or.at(words64, (lane_idx, w0 + 1), chunk & np.uint64(0xFFFFFFFF))
    words = words64[:, :maxw].astype(np.uint32)

    # --- lazy-refill interleave, uniform round boundaries across groups ---
    i1 = np.arange(1, P + 1, dtype=np.int64)
    cume = -(-(i1[None, :] * W[:, None]) // 32)  # ceil((i+1)W/32) (1024, P)
    counts = np.diff(np.concatenate([np.zeros((1024, 1), np.int64), cume], 1), axis=1)
    first = cume - counts  # word start per (lane, round)
    gcounts = counts.reshape(NGROUPS, GROUP, P)
    round_words = gcounts.sum(axis=1).max(axis=0)  # (P,) padded round width
    round_ptrs = np.concatenate([[0], np.cumsum(round_words[:-1])]).astype(np.int64)
    nwords = int(round_ptrs[-1] + round_words[-1])
    streams = np.zeros((NGROUPS, nwords), np.uint32)
    for g in range(NGROUPS):
        lanes = slice(g * GROUP, (g + 1) * GROUP)
        cg = counts[lanes]  # (128, P)
        wg = words[lanes]  # (128, maxw)
        for i in range(P):
            c = cg[:, i]
            ln = np.repeat(np.arange(GROUP), c)
            wi = first[lanes][:, i].repeat(c) + _ramp(c)
            streams[g, round_ptrs[i] : round_ptrs[i] + len(ln)] = wg[ln, wi]

    return FixedBatch(
        streams=streams,
        widths=widths.astype(np.uint8),
        start_values=starts.astype(np.int32),
        bbox_min_i=np.array([x.min(), y.min(), z.min()], np.int32),
        bbox_max_i=np.array([x.max(), y.max(), z.max()], np.int32),
        round_ptrs=round_ptrs.astype(np.int32),
    )


def _ramp(c: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (for np.repeat-style indexing)."""
    total = int(c.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(c)
    r = np.arange(total, dtype=np.int64)
    return r - np.repeat(ends - c, c)


def decode_fixed_group(stream, widths, round_ptrs, num_points=P):
    """NumPy mirror of the Pallas fbatch group decoder.

    stream: (nwords,) u32; widths: (128, 3); round_ptrs: (P,) uniform
    round bases.  Returns (128, num_points, 3) i32 deltas.  Implements
    the exact window/refill protocol above.
    """
    widths = widths.astype(np.int64)
    W = widths.sum(axis=1)
    s = np.concatenate([stream.astype(np.uint32), np.zeros(4 * GROUP, np.uint32)])
    win = np.zeros((GROUP, 4), np.uint32)
    bp = np.zeros(GROUP, np.int64)
    ve = np.zeros(GROUP, np.int64)
    out = np.zeros((GROUP, num_points, 3), np.int32)
    i1 = np.arange(1, num_points + 1, dtype=np.int64)
    cume = -(-(i1[None, :] * W[:, None]) // 32)
    counts = np.diff(
        np.concatenate([np.zeros((GROUP, 1), np.int64), cume], 1), axis=1
    )
    for i in range(num_points):
        # refill: lanes take counts[:, i] consecutive words in lane order
        c = counts[:, i]
        rank = np.cumsum(c) - c
        ptr = int(round_ptrs[i])
        for j in range(3):
            take = c > j
            w = s[np.minimum(ptr + rank + j, len(s) - 1)]
            slot = ve + j
            for sl in range(4):
                m = take & (slot == sl)
                win[m, sl] = w[m]
        ve += c
        # extract x, y, z
        w64_01 = (win[:, 0].astype(np.uint64) << np.uint64(32)) | win[:, 1]
        w64_12 = (win[:, 1].astype(np.uint64) << np.uint64(32)) | win[:, 2]
        w64_23 = (win[:, 2].astype(np.uint64) << np.uint64(32)) | win[:, 3]
        off = bp.copy()
        for comp in range(3):
            w = widths[:, comp]
            word = off >> 5
            sh = off & 31  # in [0, 31]
            pair = np.select(
                [word == 0, word == 1], [w64_01, w64_12], w64_23
            )
            # bits [sh, sh+32) of the 64-bit pair
            top32 = ((pair >> (np.uint64(32) - sh.astype(np.uint64)))
                     & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            v = np.where(
                w > 0,
                top32 >> ((32 - w) & 31).astype(np.uint32),
                np.uint32(0),
            )
            out[:, i, comp] = unzigzag32(v)
            off = off + w
        # advance / shift window
        bp = bp + W
        k = bp >> 5
        bp &= 31
        ve -= k
        for sl in range(4):
            src = sl + k
            valid = src < 4
            win[:, sl] = np.where(valid, win[np.arange(GROUP), np.minimum(src, 3)], 0)
    return out


def decode_fixed_batch(fb: FixedBatch) -> np.ndarray:
    """-> (65536, 3) i32 absolute coords in chain layout."""
    from .batch_codec import deltas_to_coords

    deltas = np.zeros((1024, P, 3), np.int32)
    for g in range(NGROUPS):
        deltas[g * GROUP : (g + 1) * GROUP] = decode_fixed_group(
            fb.streams[g], fb.widths[g * GROUP : (g + 1) * GROUP],
            fb.round_ptrs,
        )
    return deltas_to_coords(
        deltas.reshape(1024, P * 3), fb.start_values.reshape(-1)
    )
