"""Resource state machine and the in-place row upload.

Counterpart of `pcrhpg24_tpu/engine/resource.py:30-58`.  The reference
updates preallocated jax arrays with a donated `dynamic_update_slice`;
torch tensors are mutable, so `upload_rows` copies into a slice of the
preallocated device tensor in place and streaming never reallocates.
The `.huffman` resource (`HuffmanLasData`) is ROADMAP A11.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch


class ResourceState(Enum):
    UNLOADED = 0
    LOADING = 1
    LOADED = 2
    UNLOADING = 3


class Resource:
    state: ResourceState = ResourceState.UNLOADED

    def load(self, renderer):  # pragma: no cover - interface
        raise NotImplementedError

    def unload(self, renderer):
        raise NotImplementedError

    def process(self, renderer):
        raise NotImplementedError


def upload_rows(buf: torch.Tensor, start: int, vals: np.ndarray) -> None:
    """buf[start:start+len(vals)] = vals, in place (host -> device copy).

    u32 arrays arrive as their int32 bit views (`u32.from_u32`)."""
    src = torch.from_numpy(np.ascontiguousarray(vals))
    if src.dtype != buf.dtype:
        raise TypeError(f"upload of {src.dtype} into a {buf.dtype} buffer")
    buf[start:start + src.shape[0]].copy_(src)
