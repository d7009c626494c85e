"""Warp-cooperative stream interleave of the `.huffman` format.

The reference GPU decoder lets the 32 threads of a warp share one word
stream: each thread holds a two-word lookahead window and refills it in
ballot order (reference: modules/huffman_mem_iter_cuda/render.cu:428-451).
The preprocessor therefore interleaves the 32 chains' words in exact
future-consumption order with a sliding-window sort on the per-word
cumulative codeword counts (reference: src/preprocess.cpp:540-587,
"encode_decode_bernhard").

This module implements that interleave (encode side) and a faithful
simulation of the warp decode protocol (decode side) on the CPU.  The
port's copy of `pcrhpg24_tpu/codec/warp_interleave.py`.
"""

from __future__ import annotations

import numpy as np

from ..constants import WARP_SIZE

U32 = np.uint32
I32 = np.int32


def interleave_warp(
    words_per_lane: list[np.ndarray],
    num_cw_per_lane: list[np.ndarray],
    bits_per_symbol: list[np.ndarray] | None = None,
) -> np.ndarray:
    """Pack 32 lanes' word streams into consumption order.

    Word i of lane t is consumed by the GPU once the lane has decoded
    `num_cw[i-2]` symbols (its window has moved past word i-2); words 0
    and 1 are the initial lookahead, keyed -1 and 0.  Sort keys are the
    lexicographic triples (key, lane, word_idx) like the reference's
    `pairs` sort (preprocess.cpp:552-565).

    Protocol exactness: the GPU's two-word lookahead issues 1-2 "phantom"
    refills per lane *past* the lane's final word (render.cu:443-450
    refills whenever `cur_bits <= 0`, including while consuming the last
    word).  The reference encoder does not allocate stream slots for
    those requests, so up to ~3 tail symbols per lane decode from the
    wrong words (a latent reference defect: its ASSERT_DECOMPRESSION
    checks the *pre*-interleave stream, preprocess.cpp:576-581).  When
    `bits_per_symbol` is given (one int array per lane of |code length|
    per symbol) we simulate the exact request schedule and insert dummy
    words at phantom positions, which makes decode bit-exact — including
    on the reference's own GPU decoder.
    """
    assert len(words_per_lane) == WARP_SIZE
    keys = []
    for tid in range(WARP_SIZE):
        n = len(words_per_lane[tid])
        assert n >= 2, "each lane stream must have at least 2 words"
        keys.append((-1, tid, 0))
        keys.append((0, tid, 1))
        if bits_per_symbol is None:
            step_idx = num_cw_per_lane[tid]
            for i in range(2, n):
                keys.append((int(step_idx[i - 2]), tid, i))
        else:
            consumed = np.cumsum(np.asarray(bits_per_symbol[tid], np.int64))
            total = int(consumed[-1])
            assert n == (total + 31) // 32
            n_requests = total // 32  # boundaries 32j, j = 1..n_requests
            # word j+1 is requested at the first symbol k with
            # consumed[k] >= 32*j; words >= n are phantoms.
            trigger = np.searchsorted(consumed, 32 * np.arange(1, n_requests + 1))
            for j in range(1, n_requests + 1):
                keys.append((int(trigger[j - 1]) + 1, tid, j + 1))
    keys.sort()
    out = np.empty(len(keys), U32)
    for pos, (_, tid, widx) in enumerate(keys):
        lane_words = words_per_lane[tid]
        out[pos] = lane_words[widx] if widx < len(lane_words) else 0
    return out


def decode_warp(
    packed: np.ndarray,
    separate: np.ndarray,
    sep_offsets: np.ndarray,
    table_values: np.ndarray,
    table_cw_len: np.ndarray,
    symbols_per_lane: int,
) -> np.ndarray:
    """Simulate the GPU warp decode of one interleaved stream.

    `packed` is one warp's interleaved words; `sep_offsets[t]` is the
    starting index of lane t in `separate`.  Returns (32, symbols_per_lane)
    int32 symbols.  Mirrors render.cu:415-451 including the ballot-order
    refill (`already_read + popc(mask << (32 - tid))`).
    """
    max_cw = int(np.log2(len(table_values)))
    mask_shift = 32 - max_cw

    # pad generously: GPU overreads NextHuffman past the end
    pad = np.zeros(WARP_SIZE * 2, U32)
    stream = np.concatenate([np.asarray(packed, U32), pad]).astype(np.uint64)

    cur = stream[np.arange(WARP_SIZE)].copy()
    nxt = stream[WARP_SIZE + np.arange(WARP_SIZE)].copy()
    already_read = 2 * WARP_SIZE
    cur_bits = np.full(WARP_SIZE, 32, np.int64)
    sep_ptr = np.asarray(sep_offsets, np.int64).copy()

    out = np.empty((WARP_SIZE, symbols_per_lane), I32)
    sep = np.asarray(separate, I32)
    tv = np.asarray(table_values, I32)
    tl = np.asarray(table_cw_len, I32)

    for i in range(symbols_per_lane):
        # window = L | R  (two-word sliding window per lane)
        lsh = (32 - cur_bits).astype(np.uint64)
        rsh = np.maximum(cur_bits, 1).astype(np.uint64)
        L = np.where(cur_bits == 32, cur, (cur << lsh) & 0xFFFFFFFF)
        R = np.where(cur_bits == 32, 0, nxt >> rsh)
        window = (L | R) & 0xFFFFFFFF
        key = (window >> mask_shift).astype(np.int64)
        slen = tl[key]
        lit = slen > 0
        vals = np.where(lit, tv[key], sep[np.minimum(sep_ptr, len(sep) - 1)])
        out[:, i] = vals
        sep_ptr += ~lit
        cur_bits -= np.abs(slen)

        need = cur_bits <= 0
        if need.any():
            # ballot order: lane t reads word already_read + (#needy lanes < t)
            offs = np.cumsum(need) - need  # exclusive prefix count
            idx = already_read + offs
            refill = stream[np.minimum(idx, len(stream) - 1)]
            cur = np.where(need, nxt, cur)
            nxt = np.where(need, refill, nxt)
            cur_bits = np.where(need, cur_bits + 32, cur_bits)
            already_read += int(need.sum())
    return out
