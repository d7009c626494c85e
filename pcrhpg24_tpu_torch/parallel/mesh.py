"""The `.huffman`-format frame sharded over the ranks of a process group.

Counterpart of `pcrhpg24_tpu/parallel/mesh.py`, on `torch.distributed`
(the layout is `mesh_native.Mesh`): batches are data-parallel over dp,
each rank holding only its own batches' words of the flat streams;

* `shard_streams_host` splits the flat `encoding` / `separate` streams
  into one row per dp shard (rebased offsets, rows zero-padded to the
  longest shard), as the reference's does where dp divides the batch
  count; where it does not, the shards are `mesh_native.batch_range`'s
  contiguous, uneven ranges, and a shard with no batch has an empty row
  (the reference raises, `mesh.py:52`: ROADMAP C4);
* `local_raster`: a rank decodes its batches with B12
  (`decode_ref_batches`), positions them as `coords * scale + offset_rel`,
  projects them in `raster.project_points`' op order (the reference's
  `raster.project`, then `clip / w`, `mesh.py:84-103`), masks each
  chain's points past its batch's LOD count, and resolves them with B3
  into a (depth << 32 | payload) plane in linear pixel ids; the payload
  is the global batch index (`payload_base`, `mesh.py:76-90,141`), so
  ties break as in a single-process frame, and the reference's depth,
  then payload, scatter-min (`mesh.py:106-112`) is that u64 min;
* `multichip_render`: the planes combine in one `all_reduce(MIN)` over
  dp, and each rank takes its height / sp rows of the payload plane,
  the background where it is EMPTY.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import POINTS_PER_THREAD
from ..render.decode_huffman import decode_ref_batches
from ..render.raster import BACKGROUND, EMPTY, key_plane, project_points, u64_min_planes
from ..u32 import split_key
from .mesh_native import Mesh, all_reduce_min_u64, batch_range

# the scene arrays of one batch each, in `decode_ref_batches`' order
BATCH_KEYS = ("cluster_sizes", "separate_sizes", "table_values", "table_cw_len",
              "start_values")


def shard_streams_host(scene: dict, dp: int) -> dict:
    """Split the flat `encoding` / `separate` streams into per-dp-shard rows.

    `scene` maps names to numpy arrays as `batches_to_device` makes them
    (flat `encoding` (E,) u32 and `separate` (S,) i32 with per-batch
    element offsets `enc_offsets` / `sep_offsets`).  Returns a copy in
    which `encoding` is (dp, Le) and `separate` (dp, Ls), each row the
    words of shard s's batches `batch_range(B, dp, s)`, zero-padded to
    the longest shard, and the offsets are rebased to their shard's row.
    """
    enc = np.asarray(scene["encoding"])
    sep = np.asarray(scene["separate"])
    eo = np.asarray(scene["enc_offsets"]).astype(np.int64)
    so = np.asarray(scene["sep_offsets"]).astype(np.int64)
    B = eo.shape[0]
    ranges = [batch_range(B, dp, s) for s in range(dp)]

    def bounds(offsets, total):
        at = np.append(offsets, total)  # the start of batch b; at[B] = the end
        return [(int(at[a]), int(at[b])) for a, b in ranges]

    ebounds, sbounds = bounds(eo, len(enc)), bounds(so, len(sep))
    Le = max(1, max(b - a for a, b in ebounds))
    Ls = max(1, max(b - a for a, b in sbounds))
    enc_rows = np.zeros((dp, Le), enc.dtype)
    sep_rows = np.zeros((dp, Ls), sep.dtype if sep.size else np.int32)
    eo_out, so_out = eo.copy(), so.copy()
    for s, ((a, b), (ea, eb), (sa, sb)) in enumerate(zip(ranges, ebounds, sbounds)):
        enc_rows[s, :eb - ea] = enc[ea:eb]
        sep_rows[s, :sb - sa] = sep[sa:sb]
        eo_out[a:b] -= ea
        so_out[a:b] -= sa
    out = dict(scene)
    out["encoding"] = enc_rows
    out["separate"] = sep_rows
    out["enc_offsets"] = eo_out.astype(np.int32)
    out["sep_offsets"] = so_out.astype(np.int32)
    return out


def rank_scene(sharded: dict, dp: int, dp_idx: int, device) -> tuple[dict, int, int]:
    """`shard_streams_host`'s output -> (shard `dp_idx`'s arrays as int32
    tensors on `device`, and its batches' global range [start, stop))."""
    B = np.asarray(sharded["enc_offsets"]).shape[0]
    start, stop = batch_range(B, dp, dp_idx)

    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)

    out = {k: t(sharded[k][dp_idx]) for k in ("encoding", "separate")}
    for k in ("enc_offsets", "sep_offsets", *BATCH_KEYS):
        out[k] = t(np.asarray(sharded[k])[start:stop])
    return out, start, stop


def local_raster(scene: dict, start: int, lod_n, transform, scale, offset_rel,
                 width: int, height: int):
    """One rank's (size,) int64 plane of u64 (depth << 32 | payload)
    bits, all ones where nothing landed, over its batches (`rank_scene`)
    with their (B,) int32 LOD counts `lod_n`; batch b's payload is its
    global index `start + b`."""
    size = width * height
    plane = key_plane(size, scene["encoding"].device)
    B = scene["enc_offsets"].shape[0]
    if B == 0:
        return plane
    coords = decode_ref_batches(
        scene["encoding"], scene["enc_offsets"], scene["cluster_sizes"], scene["separate"],
        scene["sep_offsets"], *(scene[k] for k in BATCH_KEYS[1:]),
        points=POINTS_PER_THREAD)  # (B, points, 3, 8, 128)
    pos = [coords[:, :, k].to(torch.float32) * scale[k] + offset_rel[k] for k in range(3)]
    pid, dep = project_points(*pos, transform, width, height)
    i = torch.arange(POINTS_PER_THREAD, device=pid.device)[None, :, None, None]
    pid = torch.where(i < lod_n[:, None, None, None], pid,
                      torch.full_like(pid, size))
    pay = (start + torch.arange(B, dtype=torch.int32, device=pid.device))[:, None, None, None]
    u64_min_planes([(pid, dep, pay.expand(pid.shape).contiguous())], size, plane=plane)
    return plane


def multichip_render(mesh: Mesh, scene: dict, start: int, lod_n, transform, scale,
                     offset_rel, width: int, height: int):
    """The sharded frame -> this rank's rows of the image, (height / sp,
    width) int32: each pixel's winning global batch index, the
    background where no point landed (`mesh.py:116-150`)."""
    row0, rows = mesh.row_range(height)
    plane = local_raster(scene, start, lod_n, transform, scale, offset_rel, width, height)
    all_reduce_min_u64(plane, mesh.dp_group)
    pay = split_key(plane)[1][row0 * width:(row0 + rows) * width]
    return torch.where(pay != EMPTY, pay, torch.full_like(pay, BACKGROUND)).reshape(rows, width)
