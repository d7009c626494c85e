"""Swizzled pixel ids, the exact u64-min resolve (kernel B3) and the image.

Counterpart of `pcrhpg24_tpu/render/raster.py`.  The reference resolves
a frame's (pid, depth, payload) stream by sorting it and merging the
sorted rows (`pallas_merge._merge_matscatter_kernel`), because the TPU
has no atomics.  Here the CUDA kernel (`csrc/raster.cu`) does one u64
`atomicMin((depth << 32) | payload)` per live entry into a dense plane
in the swizzled id space, unsorted; `u64_min_planes_plain` gets the same
planes from `scatter_reduce("amin")` on biased int64 keys.  Planes and
images are int32 tensors holding the reference's u32 bits.
"""

from __future__ import annotations

import torch

from ..kernels.build import I, L, P, Kernel, check_cuda
from ..u32 import INT64_MAX, biased_key, split_key, unbias_key

EMPTY = -1  # reference raster.EMPTY (0xFFFFFFFF) as int32 bits
BACKGROUND = 0x00443322  # resolve.cu:166
TILE_PX = 32

U64_MIN = Kernel("pcr_u64_min", [P, P, P, P, L, I])


def swizzle_dims(width: int, height: int):
    """-> (tiles_x, tiles_y, swizzled id space size)."""
    wt = -(-width // TILE_PX)
    ht = -(-height // TILE_PX)
    return wt, ht, wt * ht * TILE_PX * TILE_PX


def swizzle_pid(px, py, width: int):
    """Pixel coords -> swizzled id ((ty*wt+tx)<<10 | ly<<5 | lx)."""
    wt = -(-width // TILE_PX)
    return (((py >> 5) * wt + (px >> 5)) << 10) | ((py & 31) << 5) | (px & 31)


def unswizzle_plane(fb, width: int, height: int):
    """Swizzled (wt*ht*1024,) plane -> linear (height*width,) plane."""
    wt, ht, _ = swizzle_dims(width, height)
    img = fb.reshape(ht, wt, TILE_PX, TILE_PX).permute(0, 2, 1, 3)
    return img.reshape(ht * TILE_PX, wt * TILE_PX)[:height, :width].reshape(-1)


def u64_min_planes_plain(parts, size: int):
    """Exact per-pixel u64 (dep<<32|pay) min over every (pid, dep, pay)
    stream in `parts` -> (fb_depth, fb_payload), each (size,) int32 u32
    bits, EMPTY where no entry landed; pids outside [0, size) drop.

    Equal to `raster.scatter_u64_min` (tie-break by payload included):
    the biased key orders like the u64 key and EMPTY is INT64_MAX.
    """
    device = parts[0][0].device
    plane = torch.full((size + 1,), INT64_MAX, dtype=torch.int64, device=device)
    for pid, dep, pay in parts:
        pid = pid.reshape(-1).to(torch.int64)
        live = (pid >= 0) & (pid < size)
        idx = torch.where(live, pid, torch.full_like(pid, size))
        plane.scatter_reduce_(0, idx, biased_key(dep.reshape(-1), pay.reshape(-1)),
                              reduce="amin", include_self=True)
    return split_key(unbias_key(plane[:size]))


def u64_min_planes(parts, size: int):
    """B3: the planes of `u64_min_planes_plain`, one kernel launch per
    (pid, dep, pay) part into one u64 plane, then the split.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Each part's tensors are int32 (u32 bits) of one shape.
    """
    if not parts[0][0].is_cuda:
        return u64_min_planes_plain(parts, size)
    device = parts[0][0].device
    plane = torch.full((size,), -1, dtype=torch.int64, device=device)
    for pid, dep, pay in parts:
        for name, t in (("pid", pid), ("dep", dep), ("pay", pay)):
            check_cuda(name, t, torch.int32, pid.shape)
        if pid.numel():
            U64_MIN.launch(pid.data_ptr(), dep.data_ptr(), pay.data_ptr(),
                           plane.data_ptr(), pid.numel(), size)
    return split_key(plane)


def resolve(fb_payload, width: int, height: int):
    """Framebuffer -> (H, W) int32 RGBA image (resolve.cu:149-191)."""
    color = torch.where(fb_payload != EMPTY, fb_payload,
                        torch.full_like(fb_payload, BACKGROUND))
    return color.reshape(height, width)


def image_to_rgb8(image):
    """(H,W) int32 (R | G<<8 | B<<16) -> (H,W,3) uint8, flipped to y-down."""
    img = image.flip(0)
    return torch.stack([(img >> s) & 0xFF for s in (0, 8, 16)], -1).to(torch.uint8)
