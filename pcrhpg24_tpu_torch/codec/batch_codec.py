"""Per-chain deltas of a 65 536-point batch, and back.

A batch is 65 536 Morton-sorted points split into 1024 chains of 64
(reference: src/preprocess.cpp:202-227).  Per chain the coordinates are
delta-encoded against the previous point with the first point as start
value (preprocess.cpp:318-329), deltas interleaved x0 y0 z0 x1 y1 z1 ...
(preprocess.cpp:331-343).  The port's copy of `chain_deltas` and
`deltas_to_coords` from `pcrhpg24_tpu/codec/batch_codec.py`; that
module's `.huffman` stream codec stays with ROADMAP A7.
"""

from __future__ import annotations

import numpy as np

from ..constants import POINTS_PER_THREAD, WORKGROUP_SIZE

I32 = np.int32
SYMS_PER_LANE = POINTS_PER_THREAD * 3  # 192


def chain_deltas(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """(65536,) coords -> (1024,192) interleaved deltas + (1024,3) starts."""
    pts = np.stack([x, y, z], axis=-1).astype(np.int64).reshape(WORKGROUP_SIZE, POINTS_PER_THREAD, 3)
    deltas = np.zeros_like(pts)
    deltas[:, 1:] = pts[:, 1:] - pts[:, :-1]
    # int32 wraparound semantics
    deltas = deltas.astype(np.int64)
    deltas = ((deltas + 2**31) % 2**32 - 2**31).astype(I32)
    starts = pts[:, 0, :].astype(I32)
    return deltas.reshape(WORKGROUP_SIZE, SYMS_PER_LANE), starts


def deltas_to_coords(deltas: np.ndarray, start_values: np.ndarray):
    """(1024,192) interleaved deltas + (1024*3,) starts -> (65536,3) i32."""
    d = deltas.reshape(WORKGROUP_SIZE, POINTS_PER_THREAD, 3).astype(np.int64)
    s = np.asarray(start_values, np.int64).reshape(WORKGROUP_SIZE, 1, 3)
    # delta[0] == 0 and cur = prev + delta starting from start value
    coords = s + np.cumsum(d, axis=1)
    coords = (coords + 2**31) % 2**32 - 2**31
    return coords.reshape(-1, 3).astype(I32)
