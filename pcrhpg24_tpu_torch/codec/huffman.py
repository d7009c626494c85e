"""Reference-compatible clipped ("pjn") Huffman codec, CPU/NumPy.

Implements the exact on-disk bitstream semantics of the reference codec
(reference: include/huffman.h) so `.huffman` files are interchangeable:

* Huffman tree over int32 delta symbols (huffman.h:94-113).
* "pjn" clipped dictionary: codewords longer than MAX_CW_LEN (12) are
  truncated to their first 12 bits and marked with a *negative* length;
  their true value is stored in a side stream ("separate data")
  (huffman.h:180-218).
* Flat 4096-entry decoder table, every slot filled by prefix fan-out
  (huffman.h:221-240).
* MSB-first bit-packing into uint32 words, plus a per-word cumulative
  codeword count (`num_cw`, a.k.a. step_idx) used by the warp interleave
  (huffman.h:242-300).
* Sliding two-word-window decoder (huffman.h:433-477).

Note the decoder table is serialized *into* each batch of the `.huffman`
file, so only decode semantics must match the reference bit-for-bit; the
tree construction itself only needs to produce a valid prefix code.

The port's copy of `pcrhpg24_tpu/codec/huffman.py`.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from ..constants import HUFFMAN_TABLE_SIZE, MAX_CW_LEN

U32 = np.uint32
I32 = np.int32


def symbol_frequencies(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distinct symbols and their counts (huffman.h:46-56)."""
    values, counts = np.unique(np.asarray(data, dtype=np.int64), return_counts=True)
    return values.astype(np.int64), counts.astype(np.int64)


def huffman_code_lengths(counts: np.ndarray) -> np.ndarray:
    """Code length per symbol from a min-heap Huffman tree.

    Mirrors generate_huffman_tree_priority_queue (huffman.h:94-113);
    tie-breaking differs (insertion order) which is fine because the
    resulting table is stored in the file.
    """
    n = len(counts)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.ones(1, np.int32)  # degenerate: force 1-bit code
    # heap items: (freq, uid, node); nodes: leaf=int idx, internal=[l,r]
    heap = [(int(c), i, i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    uid = n
    children: list[tuple[int, int]] = []
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        node_id = uid
        uid += 1
        children.append((a, b))
        heapq.heappush(heap, (fa + fb, node_id, node_id))
    lengths = np.zeros(n, np.int32)
    # children[k] are the children of internal node n+k
    stack = [(heap[0][2], 0)]
    while stack:
        node, d = stack.pop()
        if node < n:
            lengths[node] = d
            continue
        l, r = children[node - n]
        stack.append((l, d + 1))
        stack.append((r, d + 1))
    return lengths


def canonical_codes(values: np.ndarray, lengths: np.ndarray) -> dict[int, tuple[int, int]]:
    """Assign canonical codewords given lengths; returns {sym: (code, len)}.

    Codes are assigned in (length, symbol) order — any prefix-free
    assignment is valid for the stored-table format.
    """
    order = np.lexsort((values, lengths))
    code = 0
    prev_len = 0
    out: dict[int, tuple[int, int]] = {}
    for idx in order:
        length = int(lengths[idx])
        code <<= length - prev_len
        prev_len = length
        out[int(values[idx])] = (code, length)
        code += 1
    return out


@dataclass
class PjnDictionary:
    """Clipped dictionary: {symbol: (codeword, signed_len)}.

    signed_len > 0: literal; signed_len == -MAX_CW_LEN: escape, the
    codeword is the first 12 bits of the true (longer) code and the
    value lives in the separate stream (huffman.h:195-207).
    """

    codes: dict[int, tuple[int, int]]
    max_cw_len: int = MAX_CW_LEN

    def table(self) -> tuple[np.ndarray, np.ndarray]:
        """Flat decoder table (values, signed lengths), huffman.h:221-240."""
        size = 1 << self.max_cw_len
        values = np.zeros(size, I32)
        cw_len = np.zeros(size, I32)
        touched = np.zeros(size, bool)
        for sym, (cw, slen) in self.codes.items():
            rem = self.max_cw_len - abs(slen)
            base = cw << rem
            values[base : base + (1 << rem)] = sym
            cw_len[base : base + (1 << rem)] = slen
            touched[base : base + (1 << rem)] = True
        if not touched.all():
            # Degenerate single-symbol code: the tree is one leaf with a
            # forced 1-bit code, leaving the '1' half of the table
            # unfilled; fill it with the same entry (harmless: decoder
            # only ever sees '0' bits).
            assert len(self.codes) == 1, "decoder table has unfilled slots"
            ((sym, (_, slen)),) = self.codes.items()
            values[~touched] = sym
            cw_len[~touched] = slen
        return values, cw_len


def build_pjn_dictionary(data: np.ndarray) -> PjnDictionary:
    """Full pipeline: frequencies -> tree -> clipped dict (huffman.h path

    used by Batch::calculate, reference: src/preprocess.cpp:765-770).
    """
    values, counts = symbol_frequencies(data)
    lengths = huffman_code_lengths(counts)
    full = canonical_codes(values, lengths)
    codes: dict[int, tuple[int, int]] = {}
    for sym, (cw, length) in full.items():
        if length <= MAX_CW_LEN:
            codes[sym] = (cw, length)
        else:
            codes[sym] = (cw >> (length - MAX_CW_LEN), -MAX_CW_LEN)
    return PjnDictionary(codes)


def encode_stream(
    symbols: np.ndarray, dictionary: PjnDictionary
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MSB-first pack symbols into u32 words.

    Returns (words u32[], separate i32[], num_cw i32[]) where num_cw[w] is
    the cumulative count of codewords already *started* when word w was
    flushed (huffman.h:242-300).
    """
    words: list[int] = []
    separate: list[int] = []
    num_cw: list[int] = []
    chunk = 0
    chunk_rem = 32
    cnt = 0
    codes = dictionary.codes
    for sym in np.asarray(symbols, dtype=np.int64):
        s = int(sym)
        cw, slen = codes[s]
        if slen < 0:
            separate.append(s)
        nbits = abs(slen)
        cnt += 1
        while nbits:
            take = min(chunk_rem, nbits)
            part = (cw >> (nbits - take)) & ((1 << take) - 1)
            chunk |= part << (chunk_rem - take)
            nbits -= take
            chunk_rem -= take
            if chunk_rem == 0:
                words.append(chunk)
                num_cw.append(cnt)
                chunk = 0
                chunk_rem = 32
    if chunk_rem < 32:
        words.append(chunk)
        num_cw.append(cnt)
    return (
        np.asarray(words, U32),
        np.asarray(separate, I32),
        np.asarray(num_cw, I32),
    )


def decode_stream(
    words: np.ndarray,
    separate: np.ndarray,
    table_values: np.ndarray,
    table_cw_len: np.ndarray,
    count: int,
) -> np.ndarray:
    """Two-word sliding-window decode, exact mirror of the GPU loop

    (huffman.h:433-477 / modules/huffman_mem_iter_cuda/render.cu:428-451).
    """
    max_cw = int(np.log2(len(table_values)))
    out = np.empty(count, I32)
    w = np.concatenate([np.asarray(words, U32), np.zeros(1, U32)])
    ptr = 0
    bitpos = 0  # bits consumed inside word `ptr`
    sep_ptr = 0
    for i in range(count):
        window = ((int(w[ptr]) << 32) | int(w[ptr + 1])) >> (32 - bitpos) if bitpos else (
            (int(w[ptr]) << 32) | int(w[ptr + 1])
        ) >> 32
        window &= 0xFFFFFFFF
        key = window >> (32 - max_cw)
        slen = int(table_cw_len[key])
        assert slen != 0
        if slen > 0:
            out[i] = table_values[key]
        else:
            out[i] = separate[sep_ptr]
            sep_ptr += 1
        bitpos += abs(slen)
        if bitpos >= 32:
            bitpos -= 32
            ptr += 1
    return out
