"""HQS blend sums: kernels B4 and B9 and their plain version.

Counterpart of `pcrhpg24_tpu/render/pallas_hqs.py`.  High-quality
shading averages, per pixel, the colour of every point whose depth lies
within 1 % of the pixel's nearest depth.  For each (pid, dep, pay) entry
of a frame's stream:

    accept = (0 <= pid < size) & (w <= old * 1.01f)
    w = f32(dep bits), old = f32(fb_depth[pid] bits)

and an accepted entry adds `pay & 255`, `(pay >> 8) & 255`,
`(pay >> 16) & 255` and 1 into four u32 planes (r, g, b, n), which wrap
mod 2**32.  The reference gets the planes from pid-sorted rows through
one-hot bf16 matmuls (`_hqs_matscatter_kernel`), because the TPU has no
atomics; the CUDA kernel (`csrc/hqs.cu`) sums the unsorted stream of
every part in one launch into one interleaved (size, 4) accumulator,
and integer sums do not depend on the order.  In the chain layout (the
`.tpc` and `.huffman` streams) the lanes of a warp that share a pixel
are combined before one set of `atomicAdd`s; in the flat layout (the
`.las` and Potree parts, one entry a point) four lanes add one entry's
four sums into its 16-byte row.  `hqs_sums_from_sorted[_multi]` (B9, counterpart of
`pallas_hqs.hqs_sums_from_sorted[_multi]`, a segmented suffix-sum over
1024-entry windows on the TPU) take streams sorted by pid: the kernel
(`csrc/hqs.cu`) sums each run segment of a warp first and does four
atomics per (warp, pixel).  Planes are int32 tensors holding u32 bits.
"""

from __future__ import annotations

import torch

from ..kernels.build import I, L, P, Kernel, check_cuda, part_groups
from ..u32 import widen
from .raster import BACKGROUND

HQS_SUMS = Kernel("pcr_hqs_sums", [P, P, P, P, I, P, P, I])
HQS_SUMS_FLAT = Kernel("pcr_hqs_sums_flat", [P, P, P, P, I, P, P, I])
# B4's kernel for each layout of a part, as `raster.U64_MIN_LAYOUTS`
HQS_SUMS_LAYOUTS = {"chain": HQS_SUMS, "flat": HQS_SUMS_FLAT}
HQS_SORTED = Kernel("pcr_hqs_sorted", [P, P, P, P, P, L, I])
TOLERANCE = 1.01  # huffman_tpu_hqs.py:153, multiplied in f32


def hqs_sums_plain(parts, fb_depth, size: int, acc=None):
    """(r, g, b, n) planes, each (size,) int32 u32 bits, from every
    (pid, dep, pay) part (int32 u32 bits, any shape) and the dense
    (size,) min-depth plane `fb_depth` in the same swizzled pid space.
    With `acc`, a running (size, 4) int32 accumulator, the sums are
    added into it (mod 2**32) and the planes are its columns."""
    device = fb_depth.device
    tol = torch.tensor(TOLERANCE, dtype=torch.float32, device=device)
    old_all = fb_depth.contiguous().view(torch.float32)
    planes = torch.zeros((4, size + 1), dtype=torch.int64, device=device)
    for pid, dep, pay in parts:
        q = widen(pid.reshape(-1))
        live = q < size
        w = dep.reshape(-1).contiguous().view(torch.float32)
        old = old_all[torch.clamp(q, max=size - 1)]
        accept = live & (w <= old * tol)
        idx = torch.where(accept, q, torch.full_like(q, size))
        p = widen(pay.reshape(-1))
        for k, v in enumerate((p & 255, (p >> 8) & 255, (p >> 16) & 255,
                               torch.ones_like(p))):
            planes[k].index_add_(0, idx, v)
    if acc is not None:
        acc.copy_((widen(acc) + planes[:, :size].t()).to(torch.int32))
        return tuple(acc[:, k] for k in range(4))
    out = planes[:, :size].to(torch.int32)  # wraps mod 2**32, as u32 sums do
    return tuple(out[k] for k in range(4))


def resolve_hqs(acc_r, acc_g, acc_b, acc_n, width: int, height: int):
    """(H, W) int32 image of the averaged colours (resolve.cu:29-41):
    unsigned divides of the linear (H*W,) planes, the background where
    no point was accepted.  A wrapped u32 sum is negative as int32, so
    the planes are widened first."""
    n = torch.clamp(widen(acc_n), min=1)
    color = ((widen(acc_r) // n) | ((widen(acc_g) // n) << 8)
             | ((widen(acc_b) // n) << 16)).to(torch.int32)
    img = torch.where(acc_n != 0, color, torch.full_like(color, BACKGROUND))
    return img.reshape(height, width)


def _launch_sums(kernel: Kernel, parts, fb_depth, size: int):
    """(4, size) planes from one launch of `kernel` (B9) per part."""
    check_cuda("fb_depth", fb_depth, torch.int32, (size,))
    planes = torch.zeros((4, size), dtype=torch.int32, device=fb_depth.device)
    for pid, dep, pay in parts:
        for name, t in (("pid", pid), ("dep", dep), ("pay", pay)):
            check_cuda(name, t, torch.int32, pid.shape)
        if pid.numel():
            kernel.launch(pid.data_ptr(), dep.data_ptr(), pay.data_ptr(),
                          fb_depth.data_ptr(), planes.data_ptr(), pid.numel(), size)
    return tuple(planes[k] for k in range(4))


def hqs_sums(parts, fb_depth, size: int, acc=None, layout: str = "chain"):
    """B4: the planes of `hqs_sums_plain`, one kernel launch for up to 64
    parts.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Each part's tensors are int32 (u32 bits) of one shape; `fb_depth` is
    a (size,) int32 plane on the same card.  On the card the planes are
    strided views (stride 4) of one (size, 4) accumulator: `acc`, a
    running one that the parts are added into (a frame's parts in
    groups), or a new one.  `layout` ("chain" or "flat",
    `HQS_SUMS_LAYOUTS`) picks the kernel for the parts' order; the sums
    do not depend on it.
    """
    kernel = HQS_SUMS_LAYOUTS[layout]  # a KeyError for any other layout
    if not fb_depth.is_cuda:
        return hqs_sums_plain(parts, fb_depth, size, acc)
    check_cuda("fb_depth", fb_depth, torch.int32, (size,))
    if acc is None:
        acc = torch.zeros((size, 4), dtype=torch.int32, device=fb_depth.device)
    check_cuda("acc", acc, torch.int32, (size, 4))
    for group in part_groups(parts):
        kernel.launch(*group, fb_depth.data_ptr(), acc.data_ptr(), size)
    return tuple(acc[:, k] for k in range(4))


def hqs_sums_from_sorted(spid, sdep, spay, fb_depth, size: int):
    """B9 on one pid-sorted stream (`pallas_hqs.py:307`)."""
    return hqs_sums_from_sorted_multi([(spid, sdep, spay)], fb_depth, size)


def hqs_sums_from_sorted_multi(parts, fb_depth, size: int):
    """B9: the planes of `hqs_sums_plain` from independently pid-sorted
    parts (`pallas_hqs.py:428`), one launch per part.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    An unsorted part still sums exactly, with more atomics.
    """
    if not fb_depth.is_cuda:
        return hqs_sums_plain(parts, fb_depth, size)
    return _launch_sums(HQS_SORTED, parts, fb_depth, size)
