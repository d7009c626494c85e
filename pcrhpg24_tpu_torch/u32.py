"""u32 words and u64 keys in the dtypes torch can compute with.

torch has no shifts, comparisons, add or `minimum` on `uint32`, so:

* a u32 word travels as an `int32` tensor holding the same bits
  (numpy `.view(np.int32)`); arithmetic that needs the unsigned value
  widens it to `int64` with `widen`;
* the resolve key `(depth << 32) | payload` is an `int64`.  The CUDA
  kernel keeps it as an `unsigned long long` plane that starts at all
  ones (EMPTY in both halves); the CPU `scatter_reduce("amin")` keeps it
  biased by `^ INT64_MIN` so that signed order is u64 order and EMPTY is
  `INT64_MAX`.  `split_key` maps either back to the two u32 planes;
  `key_views` gives the kernel's plane's halves without a copy.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INT32_MIN = -(2**31)
INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


def from_u32(a: np.ndarray) -> torch.Tensor:
    """numpy u32 array -> int32 tensor (a copy) with the same bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor holding u32 bits -> numpy u32 array."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 u32 bits -> int64 unsigned value in [0, 2**32)."""
    return t.to(torch.int64) & MASK32


def f32_bits(t: torch.Tensor) -> torch.Tensor:
    """f32 tensor -> int32 tensor of its IEEE bits."""
    return t.contiguous().view(torch.int32)


def biased_key(dep: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """u32 bits (int32) -> int64 `((dep << 32) | pay) ^ INT64_MIN`.

    The bias makes signed int64 order equal u64 order for every
    (dep, pay), so `scatter_reduce("amin")` picks the u64-min winner.
    """
    return ((widen(dep) << 32) | widen(pay)) ^ INT64_MIN


def unbias_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of the bias: int64 holding the u64 key's bits."""
    return key ^ INT64_MIN


def split_key(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 holding u64 `(dep << 32) | pay` bits -> (dep, pay) int32 bits.

    All-ones (the kernel's initial value) splits to EMPTY in both.
    """
    return (plane >> 32).to(torch.int32), plane.to(torch.int32)


def key_views(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous int64 plane of u64 `(dep << 32) | pay` bits -> (dep,
    pay) as strided int32 views of it (the bits of `split_key`, no copy;
    little-endian: the payload is the low word)."""
    words = plane.view(torch.int32)
    return words[1::2], words[0::2]
