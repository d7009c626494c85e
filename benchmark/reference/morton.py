"""Frozen copy of the 96-bit Morton order a `.tpc` scene's reference
needs (the reference system's src/mymorton.h:12-58, quirks included), in
exact int64 torch ops on the device."""

from __future__ import annotations

import torch

INT64_MIN = -(2**63)


def _spread21(x):
    """Bits 0..20 of x to bits 0, 3, ..., 60."""
    x = x & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _spread_hi(x, base_shift: int):
    out = torch.zeros_like(x)
    for i in range(22, 32):
        out |= ((x >> i) & 1) << (3 * (i - 21) + base_shift)
    return out


def morton_order(x, y, z):
    """Stable sort permutation (int64 tensor) of int32 coordinate tensors
    by the (hi, lo) Morton key: hi first, then lo as unsigned, equal keys
    in their first order."""
    ux, uy, uz = (a.to(torch.int64) + 2**31 for a in (x, y, z))
    lo = _spread21(ux) | (_spread21(uy) << 1) | (_spread21(uz) << 2)
    lo |= ((ux >> 21) & 1) << 63
    hi = ((uy >> 21) & 1) | (((uz >> 21) & 1) << 1)
    hi |= _spread_hi(uy, 0) | _spread_hi(uz, 1) | _spread_hi(ux, 2)
    hi &= 0xFFFFFFFF  # X's bit 31 lands on bit 32 of a uint32: dropped
    by_lo = torch.sort(lo ^ INT64_MIN, stable=True).indices  # unsigned order
    return by_lo[torch.sort(hi[by_lo], stable=True).indices]
