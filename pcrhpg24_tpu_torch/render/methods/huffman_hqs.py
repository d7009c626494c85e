"""`huffman_hqs` — high-quality shading on `.huffman` scenes.

Counterpart of `pcrhpg24_tpu/render/methods/huffman_hqs.py`, the source
system's three-pass HQS method (modules/huffman_hqs/): a depth prepass
builds each pixel's nearest depth, a colour pass sums r, g, b and a
count over every point within 1 % of it (render.cu:296
`pos.w <= oldDepth * 1.01`), and a resolve divides.

Its projection is not B2's, so it runs as torch ops in the reference's
order: absolute positions `coords * scale + offset_rel`, then
`raster.project_points` (`((t0 x + t1 y) + t2 z) + t3` per row, with
the true division `c / w`), linear pixel ids.  Per frame each live
64-batch chunk is decoded (B12) and projected once, and the kept
(pid, depth, payload) streams feed both passes; the reference decodes
in both, which gives the same streams.  The prepass is B3 over them
(the depth half of the u64 min plane is the u32 min of the depths);
the sums are B4 with that plane; then the unsigned divide.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import POINTS_PER_THREAD
from ..hqs import hqs_sums, hqs_sums_plain, resolve_hqs
from ..bc1_layout import bc1_payload
from ..raster import BACKGROUND, EMPTY, project_points, u64_min_planes, u64_min_planes_plain
from .huffman_mem_iter import HuffmanMemIter, decode_chunk, live_chunks


def hqs_streams(dev, lod, transform, scale, offset_rel, width: int, height: int,
                chunks, points: int = POINTS_PER_THREAD, plain: bool = False):
    """Each live chunk's (pid, depth, payload) stream, pids linear in
    [0, width * height] (the last one: dropped)."""
    size = width * height
    parts = []
    for sl in chunks:
        coords = decode_chunk(dev, sl, points, plain)
        fx, fy, fz = (coords[:, :, k].to(torch.float32) * scale[k] + offset_rel[k]
                      for k in range(3))
        pid, dep = project_points(fx, fy, fz, transform, width, height)
        i = torch.arange(points, device=pid.device)[None, :, None, None]
        keep = i < lod[sl][:, None, None, None]
        pid = torch.where(keep, pid, torch.full_like(pid, size))
        pay = bc1_payload(dev["colors_k"][sl], points).to(torch.int32)
        parts.append((pid, dep, pay))
    return parts


def hqs_huffman_frame(dev, lod, transform, scale, offset_rel, width: int,
                      height: int, chunks, points: int = POINTS_PER_THREAD,
                      plain: bool = False):
    """One HQS frame -> (fb_depth, acc_n, image).

    dev: `HuffmanLasData.dev`; lod (B_pad,) i32 host LOD counts;
    transform (4, 4) f32 wvp; scale and offset_rel (3,) f32; chunks the
    live chunks' batch slices.  fb_depth and acc_n are (H*W,) int32 planes of
    u32 bits, the image (H, W) int32.  `plain=True` runs every stage's
    plain torch version.
    """
    size = width * height
    parts = hqs_streams(dev, lod, transform, scale, offset_rel, width, height,
                        chunks, points, plain)
    if not parts:
        device = dev["anchor"].device
        empty = torch.full((size,), EMPTY, dtype=torch.int32, device=device)
        return (empty, torch.zeros_like(empty),
                torch.full((height, width), BACKGROUND, dtype=torch.int32, device=device))
    planes, sums = ((u64_min_planes_plain, hqs_sums_plain) if plain
                    else (u64_min_planes, hqs_sums))
    fb_d = planes(parts, size)[0].contiguous()  # B4 reads a contiguous plane
    acc = sums(parts, fb_d, size)
    return fb_d, acc[3], resolve_hqs(*acc, width, height)


class HuffmanHQS(HuffmanMemIter):
    """HQS on `.huffman`: B12 -> projection -> B3 prepass -> B4."""

    def __init__(self, renderer, las):
        super().__init__(renderer, las)
        self.name = "huffman_hqs"
        self.description = "HQS: depth prepass + tolerance-blended average"

    def frame_args(self, renderer) -> dict:
        """Keyword arguments of `hqs_huffman_frame` for this frame: the
        wvp, scale, offset_rel and LOD counts (their int32 bits) in one
        packed host -> device copy."""
        las = self.las
        wvp, lod_full = self.frame_setup(renderer)
        rows = las.dev["anchor"].shape[0]
        packed = torch.from_numpy(np.concatenate([
            wvp.reshape(-1), np.asarray(las.scale, np.float32),
            np.asarray(las.offset - las.las_min, np.float32),
            lod_full[:rows].view(np.float32)])).to(las.device)
        B = las.num_batches_loaded
        return dict(
            dev=las.dev, lod=packed[22:].view(torch.int32),
            transform=packed[:16].reshape(4, 4), scale=packed[16:19],
            offset_rel=packed[19:22], width=renderer.width, height=renderer.height,
            chunks=live_chunks(lod_full, B),
            points=max(16, -(-int(lod_full[:B].max()) // 16) * 16),
        )

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        if las.num_batches_loaded == 0:
            return torch.full((H, W), BACKGROUND, dtype=torch.int32, device=las.device)
        fb_depth, acc_n, img = hqs_huffman_frame(**self.frame_args(renderer))
        renderer.last_fb = (fb_depth, acc_n)
        return img
