"""Dense planes from pid-sorted streams: kernels B6 and B8.

Counterpart of the stream entry points of
`pcrhpg24_tpu/render/pallas_merge.py`.  Each turns a (pid, depth,
payload) stream, sorted ascending by pid with out-of-range pids
(>= size) at the tail, into the EMPTY-filled depth and payload planes
of the exact u64 (depth << 32 | payload) min per pixel:

* `dense_from_sorted_nk1[_multi]` (B6, `csrc/merge.cu`) takes streams
  sorted by pid alone: (depth, payload) may be in any order inside a
  run.  The kernel folds each run segment of a warp to its min and does
  one `atomicMin` per (warp, pixel); the plain version is B3's
  `scatter_reduce("amin")` on biased keys (`raster.u64_min_planes_plain`).
* `dense_from_sorted` (B8, `csrc/merge.cu`) takes one stream sorted by
  (pid, depth, payload): the first entry of each run is the pixel's
  winner and lands with a plain store.

The reference's window tables, stream groups and SMEM budgets exist for
the TPU's scalar memory and (8, 128) tiling and have no counterpart
here.  Tensors are int32 holding u32 bits.
"""

from __future__ import annotations

import torch

from ..kernels.build import I, L, P, Kernel, check_cuda
from ..u32 import key_views, widen
from .raster import EMPTY, u64_min_planes_plain

MERGE_NK1 = Kernel("pcr_merge_nk1", [P, P, P, P, L, I])
MERGE_HEADS = Kernel("pcr_merge_heads", [P, P, P, P, P, L, I])


def dense_from_sorted_nk1(spid, sdep, spay, size: int, need_depth: bool = True):
    """B6 on one pid-sorted stream -> (fb_d or None, fb_p), (size,) each."""
    return dense_from_sorted_nk1_multi([(spid, sdep, spay)], size, need_depth)


def dense_from_sorted_nk1_multi(parts, size: int, need_depth: bool = True,
                                ilp: bool = True):
    """B6: the u64-min planes of every independently pid-sorted
    (spid, sdep, spay) part, one launch per part into one plane.

    `ilp` is the reference's choice between two TPU kernels of one
    function (how many windows a loop body interleaves); it changes
    nothing here.  CUDA tensors launch the kernel; CPU tensors take the
    plain version.  fb_d is None when `need_depth` is False.  On the card
    the planes are strided views (stride 2) of the u64 plane, as B3's.
    """
    del ilp
    if not parts[0][0].is_cuda:
        fb_d, fb_p = u64_min_planes_plain(parts, size)
        return (fb_d if need_depth else None), fb_p
    plane = torch.full((size,), -1, dtype=torch.int64, device=parts[0][0].device)
    for pid, dep, pay in parts:
        for name, t in (("spid", pid), ("sdep", dep), ("spay", pay)):
            check_cuda(name, t, torch.int32, pid.shape)
        if pid.numel():
            MERGE_NK1.launch(pid.data_ptr(), dep.data_ptr(), pay.data_ptr(),
                             plane.data_ptr(), pid.numel(), size)
    fb_d, fb_p = key_views(plane)
    return (fb_d if need_depth else None), fb_p


def dense_from_sorted_plain(spid, sdep, spay, size: int, need_depth: bool = True):
    """Planes from the head (first entry) of every pid run of a
    (pid, depth, payload)-sorted stream; pids >= size drop."""
    q = widen(spid.reshape(-1))
    head = q < size
    head[1:] &= q[1:] != q[:-1]
    idx = q[head]

    def plane(vals):
        out = torch.full((size,), EMPTY, dtype=torch.int32, device=q.device)
        out[idx] = vals.reshape(-1)[head]
        return out

    return (plane(sdep) if need_depth else None), plane(spay)


def dense_from_sorted(spid, sdep, spay, size: int, need_depth: bool = True):
    """B8: the planes of `dense_from_sorted_plain`, one launch.

    CUDA tensors launch the kernel (which reads no depth when
    `need_depth` is False); CPU tensors take the plain version.
    """
    if not spid.is_cuda:
        return dense_from_sorted_plain(spid, sdep, spay, size, need_depth)
    for name, t in (("spid", spid), ("sdep", sdep), ("spay", spay)):
        check_cuda(name, t, torch.int32, spid.shape)
    fb_p = torch.full((size,), EMPTY, dtype=torch.int32, device=spid.device)
    fb_d = torch.full_like(fb_p, EMPTY) if need_depth else None
    if spid.numel():
        MERGE_HEADS.launch(spid.data_ptr(), sdep.data_ptr() if need_depth else None,
                           spay.data_ptr(), fb_d.data_ptr() if need_depth else None,
                           fb_p.data_ptr(), spid.numel(), size)
    return fb_d, fb_p
