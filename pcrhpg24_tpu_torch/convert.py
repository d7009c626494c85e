"""Carry device state between the reference and the port.

The reference's `NativeLasData.dev` and `HuffmanLasData.dev` hold u32
arrays (`streams`, `encoding`, `colors`, `colors_k`) beside i32 and f32
ones; the port holds the u32 ones as int32 bit views.  `dev_from_numpy` turns the reference's arrays
(as numpy) into the port's tensors on `device`; `dev_to_numpy` goes
back, so tests can feed both packages identical state and compare it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device_of
from .u32 import from_u32, to_u32

U32_KEYS = frozenset({"streams", "encoding", "colors", "colors_k"})


def dev_from_numpy(dev: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    device = device_of(device)
    out = {}
    for k, v in dev.items():
        v = np.asarray(v)
        if k in U32_KEYS:
            if v.dtype != np.uint32:
                raise TypeError(f"{k}: expected uint32, got {v.dtype}")
            t = from_u32(v)
        else:
            t = torch.from_numpy(np.array(v))
        out[k] = t.to(device)
    return out


def dev_to_numpy(dev: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: to_u32(t) if k in U32_KEYS else t.detach().cpu().numpy()
            for k, t in dev.items()}
