"""`huffman_tpu_hqs` — high-quality shading on `.tpc` scenes.

Counterpart of `pcrhpg24_tpu/render/methods/huffman_tpu_hqs.py`: a
depth prepass, then the average colour of every point whose depth lies
within 1 % of the pixel's nearest depth (reference:
modules/huffman_hqs/, huffman_hqs.h:198-259).  Per frame the live
chunks are decoded (B1 or B5) and projected (B2 with `collapse=False`:
HQS sums every point, so no run collapses) once; the kept streams feed
both passes.  The prepass is B3 over them: the depth half of the u64
(depth << 32 | payload) min plane is the min depth, since the payload
only breaks ties between equal depths.  The blend is B4 over the same
streams with that plane, then the unsigned divide.
"""

from __future__ import annotations

import torch

from ...constants import POINTS_PER_THREAD
from ..hqs import hqs_sums, hqs_sums_plain, resolve_hqs
from ..raster import BACKGROUND, EMPTY, u64_min_planes, u64_min_planes_plain, unswizzle_plane
from .huffman_tpu import HuffmanTpu, frame_streams


def hqs_frame_native(dev, frame_params, tb, scale, width: int, height: int,
                     nchunks: int, cull: bool, points: int = POINTS_PER_THREAD,
                     fmt: str = "fixed", plain: bool = False, color_fmt: str = "bc1"):
    """One HQS frame -> (fb_depth, acc_n, image).

    fb_depth and acc_n are (H*W,) int32 planes of u32 bits in linear
    pixel order; image is (H, W) int32.  Arguments as
    `huffman_tpu.frame_streams`.
    """
    parts, size, device = frame_streams(dev, frame_params, tb, scale, width,
                                        height, nchunks, cull, points, fmt,
                                        plain, collapse=False, color_fmt=color_fmt)
    if parts:
        planes, sums = ((u64_min_planes_plain, hqs_sums_plain) if plain
                        else (u64_min_planes, hqs_sums))
        fb_d, _fb_p = planes(parts, size)
        fb_d = fb_d.contiguous()  # B4 reads a contiguous plane; B3 hands on a view
        acc = sums(parts, fb_d, size)
    else:
        fb_d = torch.full((size,), EMPTY, dtype=torch.int32, device=device)
        acc = tuple(torch.zeros((size,), dtype=torch.int32, device=device)
                    for _ in range(4))
    acc = [unswizzle_plane(a, width, height) for a in acc]
    return (unswizzle_plane(fb_d, width, height), acc[3],
            resolve_hqs(*acc, width, height))


class HuffmanTpuHqs(HuffmanTpu):
    """HQS on the native format: (B1 or B5) -> B2 -> B3 prepass -> B4."""

    def __init__(self, renderer, tpc):
        super().__init__(renderer, tpc)
        self.name = "huffman_tpu_hqs"
        self.description = "HQS average blend: depth prepass + atomicAdd sums"

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        if las.num_batches_loaded == 0:
            return torch.full((H, W), BACKGROUND, dtype=torch.int32, device=las.device)
        fb_depth, acc_n, img = hqs_frame_native(**self.frame_args(renderer))
        renderer.last_fb = (fb_depth, acc_n)
        return img
