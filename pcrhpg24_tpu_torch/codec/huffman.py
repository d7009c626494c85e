"""Huffman code lengths for the tbatch bucket code.

The port's copy of `huffman_code_lengths` from
`pcrhpg24_tpu/codec/huffman.py`, the one function of that module the
`.tpc` codecs reach.  The reference-format (`.huffman`) dictionary and
stream codec stay with ROADMAP A7.
"""

from __future__ import annotations

import heapq

import numpy as np


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
