"""The flagship `.tpc` frames sharded over the ranks of a process group.

Counterpart of `pcrhpg24_tpu/parallel/mesh_native.py`, on
`torch.distributed` in place of a jax device mesh.  The ranks form a
(dp, sp) layout, `rank = dp_idx * sp + sp_idx`, with one dp group per sp
column (`Mesh`):

* each rank holds a contiguous range of the scene's batches
  (`batch_range`, `shard_dev`): uneven where dp does not divide the
  batch count, and empty where there are fewer batches than ranks (the
  reference raises unless dp divides the count and pads every shard to
  a multiple of dp * chunk, `mesh.py:52`, `mesh_native.py:139-141`:
  ROADMAP C4);
* the colour frame (`flagship_frame`): each rank runs
  `huffman_tpu.frame_streams` over its batches (B1 or B5 -> B2) and B3
  into a local u64 (depth << 32 | payload) plane, or leaves it EMPTY
  when none of its chunks is live; the planes combine in one
  `all_reduce(MIN)` over the dp group, on the biased int64 key
  (`u32.biased_key`), where the reference takes two u32 `pmin`s
  (`mesh_native.py:125-129`): one u64 min picks the same winner, since
  a point's payload is its colour from any shard.  Then each rank
  unswizzles and resolves its height / sp rows;
* the HQS frame (`flagship_hqs`): the same MIN for the depth prepass,
  then B4 against the global depth plane, one `all_reduce(SUM)` of the
  (r, g, b, n) planes (in int64, then mod 2**32, as u32 sums wrap), and
  the divide on the rank's rows (`mesh_native.py:174-257`).

The collectives take the planes where the frame left them: with the
`gloo` backend and planes on a card, `torch.distributed` stages them
through the host; with `nccl` (one card per rank) they stay on the
cards.  The kernels of the frames run on each rank's device either way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..render.hqs import hqs_sums, resolve_hqs
from ..render.methods.huffman_tpu import CHUNK, frame_streams
from ..render.raster import (key_plane, resolve, swizzle_dims, u64_min_planes,
                             unswizzle_plane)
from ..u32 import INT64_MIN, MASK32, split_key, widen


class Mesh:
    """A (dp, sp) layout over the first dp * sp ranks of the default
    process group; ranks past it hold no part of the layout (`active`
    False) and take no part in its collectives.

    Every rank of the group must construct it, in the same order as
    every other layout: `dist.new_group` is collective."""

    def __init__(self, dp: int, sp: int):
        world, rank = dist.get_world_size(), dist.get_rank()
        if dp < 1 or sp < 1 or dp * sp > world:
            raise ValueError(f"a {dp} x {sp} layout needs {dp * sp} ranks, the group "
                             f"has {world}")
        self.dp, self.sp, self.rank = dp, sp, rank
        self.active = rank < dp * sp
        self.dp_idx, self.sp_idx = divmod(rank, sp)
        self.dp_group = None
        for s in range(sp):
            group = dist.new_group([d * sp + s for d in range(dp)])
            if self.active and s == self.sp_idx:
                self.dp_group = group

    def row_range(self, height: int) -> tuple[int, int]:
        """This rank's rows of the image [start, start + height / sp)."""
        if height % self.sp:
            raise ValueError(f"height {height} not divisible by sp {self.sp}")
        rows = height // self.sp
        return self.sp_idx * rows, rows


def batch_range(batches: int, dp: int, dp_idx: int) -> tuple[int, int]:
    """Shard `dp_idx`'s batches [start, stop) of `batches` over dp shards:
    contiguous, the first `batches % dp` shards one more than the rest."""
    per, extra = divmod(batches, dp)
    start = dp_idx * per + min(dp_idx, extra)
    return start, start + per + (dp_idx < extra)


def shard_dev(dev: dict, start: int, stop: int) -> dict:
    """A resource's `dev` (every array per batch on axis 0) -> batches
    [start, stop) in arrays of their own, padded with zero batches to a
    multiple of the render chunk (64)."""
    n = stop - start
    pad = -(-n // CHUNK) * CHUNK
    out = {}
    for k, v in dev.items():
        rows = v.new_zeros((pad, *v.shape[1:]))
        rows[:n] = v[start:stop]
        out[k] = rows
    return out


def shard_frame(args: dict, dev: dict, start: int, stop: int, loaded: int) -> dict:
    """`HuffmanTpu.frame_args` of the whole scene (`loaded` batches of it
    loaded) -> the arguments of the same frame over batches [start,
    stop), whose arrays `dev` holds (`shard_dev`)."""
    n = stop - start
    out = dict(args, dev=dev, nchunks=-(-n // CHUNK))
    fp = args["frame_params"].clone()
    fp[23] = float(min(max(loaded - start, 0), n))  # this range's loaded batches
    out["frame_params"] = fp
    tb = args["tb"]
    rows = tb.new_zeros((out["nchunks"] * CHUNK, tb.shape[1]))
    rows[:n] = tb[start:stop]
    out["tb"] = rows
    return out


def all_reduce_min_u64(plane, group):
    """Per-entry u64 min over the group of a (size,) int64 plane of u64
    bits (all ones: EMPTY), in place: one int64 MIN on the biased key."""
    biased = plane ^ INT64_MIN  # signed order == u64 order
    dist.all_reduce(biased, op=dist.ReduceOp.MIN, group=group)
    torch.bitwise_xor(biased, INT64_MIN, out=plane)
    return plane


def _local_plane(args: dict, collapse: bool):
    """This rank's parts and its u64 plane of them: (parts, plane)."""
    size = swizzle_dims(args["width"], args["height"])[2]
    device = args["frame_params"].device
    plane = key_plane(size, device)
    if args["nchunks"] == 0:
        return [], plane
    parts, size, _device = frame_streams(**args, collapse=collapse)
    if parts:
        u64_min_planes(parts, size, plane=plane)
    return parts, plane


def flagship_frame(mesh: Mesh, args: dict):
    """The colour frame over every rank's batches -> this rank's rows of
    the image, (height / sp, width) int32.

    `args` are `shard_frame`'s for this rank's range; every rank of the
    layout calls it on the same frame.  Kernels dispatch on the arrays'
    device, as `huffman_tpu.render_frame_native` does."""
    W, H = args["width"], args["height"]
    row0, rows = mesh.row_range(H)
    _parts, plane = _local_plane(args, collapse=True)
    all_reduce_min_u64(plane, mesh.dp_group)
    _dep, pay = split_key(plane)
    return resolve(unswizzle_plane(pay, W, H)[row0 * W:(row0 + rows) * W], W, rows)


def flagship_hqs(mesh: Mesh, args: dict):
    """The HQS frame over every rank's batches -> this rank's rows of the
    image, (height / sp, width) int32: the depth prepass min-combined
    over dp, each rank's accepted sums against it, summed over dp, and
    the divide on the rank's rows."""
    W, H = args["width"], args["height"]
    row0, rows = mesh.row_range(H)
    size = swizzle_dims(W, H)[2]
    parts, plane = _local_plane(args, collapse=False)
    all_reduce_min_u64(plane, mesh.dp_group)
    fb_depth = split_key(plane)[0].contiguous()
    if parts:
        acc = torch.stack([widen(a) for a in hqs_sums(parts, fb_depth, size)])
    else:
        acc = torch.zeros((4, size), dtype=torch.int64, device=plane.device)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.dp_group)
    acc = (acc & MASK32).to(torch.int32)  # u32 sums wrap mod 2**32
    planes = [unswizzle_plane(a, W, H)[row0 * W:(row0 + rows) * W] for a in acc]
    return resolve_hqs(*planes, W, rows)
