"""96-bit Morton ordering of int32 coordinates, NumPy-vectorized.

Replicates the reference's key layout exactly (reference: src/mymorton.h:12-58),
including its quirks: bit 2 of the high word is never set, and X's bit 31
is dropped (the C++ shifts it to bit 32 of a uint32).  Coordinates are
shifted by -INT_MIN to unsigned before interleaving.

A copy of `pcrhpg24_tpu/codec/morton.py`.
"""

from __future__ import annotations

import numpy as np

_U = np.uint64


def _spread21(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so bit i lands at bit 3*i."""
    x = x.astype(_U) & _U(0x1FFFFF)
    x = (x | (x << _U(32))) & _U(0x1F00000000FFFF)
    x = (x | (x << _U(16))) & _U(0x1F0000FF0000FF)
    x = (x | (x << _U(8))) & _U(0x100F00F00F00F00F)
    x = (x | (x << _U(4))) & _U(0x10C30C30C30C30C3)
    x = (x | (x << _U(2))) & _U(0x1249249249249249)
    return x


def _spread_hi(x: np.ndarray, base_shift: int) -> np.ndarray:
    """Bits 22..31 of x to bits 3*(i-21)+base_shift of the high word."""
    out = np.zeros_like(x, dtype=_U)
    for i in range(22, 32):
        out |= ((x >> _U(i)) & _U(1)) << _U(3 * (i - 21) + base_shift)
    return out


def morton_keys(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hi u32-as-u64, lo u64) morton keys (mymorton.h:12-37)."""
    ux = (x.astype(np.int64) - np.iinfo(np.int32).min).astype(_U)
    uy = (y.astype(np.int64) - np.iinfo(np.int32).min).astype(_U)
    uz = (z.astype(np.int64) - np.iinfo(np.int32).min).astype(_U)

    lo = _spread21(ux) | (_spread21(uy) << _U(1)) | (_spread21(uz) << _U(2))
    lo |= ((ux >> _U(21)) & _U(1)) << _U(63)

    hi = ((uy >> _U(21)) & _U(1)) | (((uz >> _U(21)) & _U(1)) << _U(1))
    hi |= _spread_hi(uy, 0) | _spread_hi(uz, 1) | _spread_hi(ux, 2)
    # the reference ORs X's bit 31 into bit 32 of a uint32 => dropped
    hi &= _U(0xFFFFFFFF)
    return hi, lo


def morton_order(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Stable sort permutation by (hi, lo) (mymorton.h:39-58)."""
    hi, lo = morton_keys(x, y, z)
    return np.lexsort((lo, hi))
