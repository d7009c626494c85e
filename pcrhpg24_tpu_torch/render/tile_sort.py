"""Per-tile 3-key sort: kernel B10 and its plain version.

Counterpart of `pcrhpg24_tpu/render/pallas_raster.py`: every
1024-entry (8, 128) tile of three int32 key planes is sorted on its own,
ascending by (k0, k1, k2) compared as SIGNED int32 (callers bias u32
keys themselves).  The reference built it as a verified building block
of a fragment compaction it never wired into a frame; no method calls
it.  The kernel (`csrc/tile_sort.cu`) keeps each tile's keys in one
warp's registers and runs a bitonic network there (shuffles between
lanes, no shared-memory stages, no barrier); the plain version sorts
each tile with three stable `torch.sort` passes (k2, then k1, then k0).
"""

from __future__ import annotations

import torch

from ..kernels.build import L, P, Kernel, check_cuda

SUBL, LANES = 8, 128
TILE = SUBL * LANES

TILE_SORT3 = Kernel("pcr_tile_sort3", [P, P, P, P, P, P, L])


def tile_sort3_plain(pid, dep, pay):
    """(T, 8, 128) int32 key planes -> the same, each tile sorted."""
    T = pid.shape[0]
    keys = [k.reshape(T, TILE) for k in (pid, dep, pay)]
    order = torch.arange(TILE, device=pid.device).expand(T, TILE)
    for k in reversed(keys):  # least significant key first, stable after
        _, idx = torch.sort(torch.gather(k, 1, order), dim=1, stable=True)
        order = torch.gather(order, 1, idx)
    return tuple(torch.gather(k, 1, order).reshape(T, SUBL, LANES) for k in keys)


def tile_sort3(pid, dep, pay):
    """B10: `tile_sort3_plain`, one launch over every tile.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if not pid.is_cuda:
        return tile_sort3_plain(pid, dep, pay)
    shape = (pid.shape[0], SUBL, LANES)
    for name, t in (("pid", pid), ("dep", dep), ("pay", pay)):
        check_cuda(name, t, torch.int32, shape)
        if t.data_ptr() % 16:  # the kernel moves 16 B a lane
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    outs = tuple(torch.empty_like(pid) for _ in range(3))
    if pid.shape[0]:
        TILE_SORT3.launch(pid.data_ptr(), dep.data_ptr(), pay.data_ptr(),
                          *(o.data_ptr() for o in outs), pid.shape[0])
    return outs
