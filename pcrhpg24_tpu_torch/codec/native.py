"""TPU-native geometry stream codec ("tbatch").

A from-scratch re-design of the reference's per-batch compression for
TPU decode.  Same information content (per-chain delta streams of
Morton-sorted 65 536-point batches, reference: src/preprocess.cpp), but
the code construction is chosen so the hot decode loop needs *no*
4096-entry table gather (TPUs have no fast random gather — see
experiments/NOTES.md):

* symbols are zigzag **bit-length buckets** (0..32) of the interleaved
  deltas; a symbol is followed inline by `bucket-1` raw extra bits.
  Decoding a bucket only needs the canonical-code compare ladder
  (12 scalar limits) plus a 33-entry arithmetic bit-plane LUT — all
  vectorizable on the VPU.
* codes are canonical, depth-limited to 12 bits (Kraft repair).
* the 1024 chains are grouped as 8 groups x 128 lanes — one (8,128)
  VREG row per group.  Each group has its own word stream, interleaved
  in exact decoder-consumption order (the TPU analogue of the
  reference's warp interleave, preprocess.cpp:540-587): per decode
  round, refilling lanes take consecutive words in lane order, so the
  kernel reads a dense 128-word window and distributes it with a lane
  shuffle (`tpu.dynamic_gather`) — no per-lane address divergence.

The decode protocol (must match the Pallas kernel bit-for-bit):
  state: cur, nxt (u32 words), bitpos in [0,32) consumed bits of cur.
  initial: cur = stream[lane], nxt = stream[128+lane], already = 256.
  per symbol:
    1. peek 12 bits -> canonical decode -> (bucket, L); consume L
    2. refill round A: lanes with bitpos >= 32 shift nxt->cur and take
       consecutive words stream[already + rank] in lane order
    3. peek bucket-1 bits -> extra; consume
    4. refill round B (same rule)
    5. delta = unzigzag((1 << (bucket-1)) | extra), bucket 0 -> 0

A copy of `pcrhpg24_tpu/codec/native.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    POINTS_PER_THREAD,
    TPU_GROUP_SIZE,
    TPU_GROUPS_PER_BATCH,
    TPU_MAX_CODE_LEN,
    WORKGROUP_SIZE,
)
from .huffman import huffman_code_lengths

U32 = np.uint32
I64 = np.int64
SYMS_PER_LANE = POINTS_PER_THREAD * 3
GROUP = TPU_GROUP_SIZE
MAXL = TPU_MAX_CODE_LEN


def zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    return ((z >> np.uint64(1)).astype(np.int64)) ^ -(z & np.uint64(1)).astype(np.int64)


def _bitlen(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    out = np.zeros(z.shape, np.int64)
    tmp = z.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = tmp >= (np.uint64(1) << np.uint64(shift))
        out += big * shift
        tmp = np.where(big, tmp >> np.uint64(shift), tmp)
    return out + (z != 0)


def limit_lengths(lengths: np.ndarray, counts: np.ndarray, max_len: int) -> np.ndarray:
    """Depth-limit code lengths, repairing the Kraft sum (<= 1)."""
    lengths = np.minimum(lengths.astype(np.int64), max_len)
    def kraft(l):
        return np.sum(2.0 ** (max_len - l))
    budget = 2.0**max_len
    # increase lengths of rarest symbols until Kraft holds
    order = np.argsort(counts)  # rarest first
    while kraft(lengths) > budget:
        for i in order:
            if lengths[i] < max_len:
                lengths[i] += 1
                break
        else:
            raise AssertionError("cannot repair Kraft inequality")
    return lengths


@dataclass
class CanonicalCode:
    """Canonical bucket code: description small enough to live in SMEM."""

    length_counts: np.ndarray  # (MAXL+1,) number of symbols per length
    symbols: np.ndarray  # symbols sorted by (length, symbol)
    lengths: np.ndarray  # per symbol in `symbols` order

    @classmethod
    def from_frequencies(cls, values: np.ndarray, counts: np.ndarray) -> "CanonicalCode":
        lengths = huffman_code_lengths(counts)
        lengths = limit_lengths(lengths, counts, MAXL)
        order = np.lexsort((values, lengths))
        sym = values[order].astype(np.int64)
        lens = lengths[order].astype(np.int64)
        lc = np.bincount(lens, minlength=MAXL + 1).astype(np.int64)
        return cls(lc, sym, lens)

    def encode_table(self):
        """{symbol: (code, len)} dict for the encoder."""
        out = {}
        code = 0
        prev = 0
        for s, l in zip(self.symbols, self.lengths):
            l = int(l)
            code <<= l - prev
            prev = l
            out[int(s)] = (int(code), l)
            code += 1
        return out

    def decode_tables(self):
        """(lj_limit[1..MAXL], base_idx[1..MAXL], first_code[1..MAXL]).

        lj_limit[L] = (first_code[L] + count[L]) << (MAXL - L): a symbol
        of length L* is detected as the first L with window12 < lj_limit.
        """
        lj_limit = np.zeros(MAXL + 1, np.int64)
        base_idx = np.zeros(MAXL + 1, np.int64)
        first_code = np.zeros(MAXL + 1, np.int64)
        code = 0
        idx = 0
        for L in range(1, MAXL + 1):
            code <<= 1
            first_code[L] = code
            base_idx[L] = idx
            c = int(self.length_counts[L])
            code += c
            idx += c
            lj_limit[L] = code << (MAXL - L)
        return lj_limit[1:], base_idx[1:], first_code[1:]


@dataclass
class NativeBatch:
    """Encoded tbatch geometry."""

    streams: list[np.ndarray]  # 8 x (W_g,) u32 interleaved group streams
    code: CanonicalCode
    start_values: np.ndarray  # (1024, 3) i32
    bbox_min_i: np.ndarray
    bbox_max_i: np.ndarray
    # (384, 8) i32 per-round window pointers (cumulative words consumed),
    # emitted by the interleave simulation for the kernel's refill loads
    round_ptrs: np.ndarray | None = None

    @property
    def total_words(self) -> int:
        return sum(len(s) for s in self.streams)


def _lane_bitstream(buckets: np.ndarray, extras: np.ndarray, enc_table) -> tuple[np.ndarray, np.ndarray]:
    """One lane's symbols -> (words u32, bits-per-symbol)."""
    bits_list = np.empty(len(buckets), np.int64)
    total = 0
    for i, b in enumerate(buckets):
        code, L = enc_table[int(b)]
        e = max(int(b) - 1, 0)
        bits_list[i] = L + e
        total += L + e
    nw = (total + 31) // 32
    words = [0] * (nw + 2)
    pos = 0
    for i, b in enumerate(buckets):
        code, L = enc_table[int(b)]
        e = max(int(b) - 1, 0)
        val = (int(code) << e) | int(extras[i])
        n = L + e  # up to 43 bits: may span 3 words
        w0, off = pos // 32, pos % 32
        chunk = val << (96 - off - n)
        words[w0] |= (chunk >> 64) & 0xFFFFFFFF
        words[w0 + 1] |= (chunk >> 32) & 0xFFFFFFFF
        words[w0 + 2] |= chunk & 0xFFFFFFFF
        pos += n
    return np.asarray(words[:nw], U32), bits_list


def encode_native_batch(x, y, z) -> NativeBatch:
    from .batch_codec import chain_deltas

    deltas, starts = chain_deltas(x, y, z)  # (1024, 192), (1024, 3)
    zz = zigzag(deltas)
    buckets = _bitlen(zz)  # (1024,192) in [0, 33)
    # extra bits drop the implicit leading 1: extra = z - 2^(bucket-1)
    extras = np.where(
        buckets > 0,
        zz - (np.uint64(1) << np.maximum(buckets - 1, 0).astype(np.uint64)),
        np.uint64(0),
    )

    values, counts = np.unique(buckets, return_counts=True)
    code = CanonicalCode.from_frequencies(values, counts)
    enc_table = code.encode_table()

    # fast path: byte-identical C++ core (native/codec_core.cpp)
    from .. import native as _ncore

    if _ncore.available():
        codes_arr = np.zeros(33, np.uint32)
        lens_arr = np.zeros(33, np.int32)
        for sym, (c, l) in enc_table.items():
            codes_arr[sym] = c
            lens_arr[sym] = l
        maxw = 16384
        out = None
        while out is None:
            out = _ncore.encode_native_batch_streams(
                deltas.astype(np.int32), codes_arr, lens_arr, maxw
            )
            maxw *= 2
        streams_c, ptrs_c = out
        return NativeBatch(
            streams=streams_c,
            code=code,
            start_values=starts.astype(np.int32),
            bbox_min_i=np.array([x.min(), y.min(), z.min()], np.int32),
            bbox_max_i=np.array([x.max(), y.max(), z.max()], np.int32),
            round_ptrs=ptrs_c,
        )

    streams = []
    round_ptrs = np.zeros((2 * SYMS_PER_LANE, TPU_GROUPS_PER_BATCH), np.int32)
    for g in range(TPU_GROUPS_PER_BATCH):
        lane_words = []
        lane_bits = []
        for lane in range(GROUP):
            li = g * GROUP + lane
            w, bits = _lane_bitstream(buckets[li], extras[li], enc_table)
            lane_words.append(w)
            lane_bits.append(bits)
        stream, ptrs = _interleave_group(
            lane_words, lane_bits, buckets[g * GROUP : (g + 1) * GROUP], enc_table
        )
        streams.append(stream)
        round_ptrs[:, g] = ptrs

    return NativeBatch(
        streams=streams,
        code=code,
        start_values=starts.astype(np.int32),
        bbox_min_i=np.array([x.min(), y.min(), z.min()], np.int32),
        bbox_max_i=np.array([x.max(), y.max(), z.max()], np.int32),
        round_ptrs=round_ptrs,
    )


def _interleave_group(lane_words, lane_bits, buckets, enc_table):
    """Simulate the 2-round decode protocol; allocate words in request order."""
    G = GROUP
    n_words = np.array([len(w) for w in lane_words])
    # per-lane consume sequence: (L, e) per symbol -> 2 consumes
    consumes = np.zeros((G, SYMS_PER_LANE, 2), np.int64)
    for lane in range(G):
        for i, b in enumerate(buckets[lane]):
            L = enc_table[int(b)][1]
            consumes[lane, i, 0] = L
            consumes[lane, i, 1] = max(int(b) - 1, 0)

    out = [lane_words[l][0] for l in range(G)] + [
        lane_words[l][1] if n_words[l] > 1 else 0 for l in range(G)
    ]
    ptrs = np.zeros(2 * SYMS_PER_LANE, np.int32)
    bitpos = np.zeros(G, np.int64)
    widx = np.full(G, 2, np.int64)  # next word index to request per lane
    t = 0
    for i in range(SYMS_PER_LANE):
        for r in range(2):
            ptrs[t] = len(out)
            t += 1
            bitpos += consumes[:, i, r]
            need = bitpos >= 32
            for lane in np.nonzero(need)[0]:
                w = widx[lane]
                out.append(lane_words[lane][w] if w < n_words[lane] else 0)
                widx[lane] += 1
            bitpos = np.where(need, bitpos - 32, bitpos)
    return np.asarray(out, U32), ptrs


def decode_native_group(stream, code: CanonicalCode, num_symbols=SYMS_PER_LANE):
    """NumPy mirror of the Pallas group decoder.  Returns (G, num_symbols) i64 deltas."""
    lj_limit, base_idx, first_code = code.decode_tables()
    lut = code.symbols  # sym_idx -> bucket

    s = np.concatenate([stream.astype(np.uint64), np.zeros(2 * GROUP, np.uint64)])
    cur = s[np.arange(GROUP)].copy()
    nxt = s[GROUP + np.arange(GROUP)].copy()
    bitpos = np.zeros(GROUP, np.int64)
    already = 2 * GROUP

    out = np.zeros((GROUP, num_symbols), np.int64)

    def peek(n):
        w64 = (cur << np.uint64(32)) | nxt
        sh = (64 - bitpos - n).astype(np.uint64)
        return (w64 >> sh) & ((np.uint64(1) << n.astype(np.uint64)) - np.uint64(1))

    def refill(need):
        nonlocal cur, nxt, already
        rank = np.cumsum(need) - need
        idx = already + rank
        w = s[np.minimum(idx, len(s) - 1)]
        cur[:] = np.where(need, nxt, cur)
        nxt[:] = np.where(need, w, nxt)
        already += int(need.sum())

    for i in range(num_symbols):
        win = peek(np.full(GROUP, MAXL, np.int64)).astype(np.int64)
        L = 1 + np.sum(win[:, None] >= lj_limit[None, :-1], axis=1)
        code_L = win >> (MAXL - L)
        sym_idx = base_idx[L - 1] + code_L - first_code[L - 1]
        bucket = lut[sym_idx]
        bitpos += L
        need = bitpos >= 32
        bitpos = np.where(need, bitpos - 32, bitpos)
        refill(need)

        e = np.maximum(bucket - 1, 0)
        extra = peek(e).astype(np.uint64)
        bitpos += e
        need = bitpos >= 32
        bitpos = np.where(need, bitpos - 32, bitpos)
        refill(need)

        z = np.where(
            bucket == 0,
            np.uint64(0),
            (np.uint64(1) << np.maximum(bucket - 1, 0).astype(np.uint64)) | extra,
        )
        out[:, i] = unzigzag(z)
    return out


def decode_native_batch(nb: NativeBatch) -> np.ndarray:
    """-> (65536, 3) i32 absolute coords."""
    from .batch_codec import deltas_to_coords

    deltas = np.zeros((WORKGROUP_SIZE, SYMS_PER_LANE), np.int32)
    for g in range(TPU_GROUPS_PER_BATCH):
        d = decode_native_group(nb.streams[g], nb.code)
        deltas[g * GROUP : (g + 1) * GROUP] = d.astype(np.int32)
    return deltas_to_coords(deltas, nb.start_values.reshape(-1))
