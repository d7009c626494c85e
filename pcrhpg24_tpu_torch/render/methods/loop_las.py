"""The colour lookup of the `loop_las` family.

Counterpart of `resolve_indexed` in
`pcrhpg24_tpu/render/methods/loop_las.py` (:282-287), which the `.wg`
method shares.  The `loop_las` methods themselves, their resources and
their HQS variant are ROADMAP A11.
"""

from __future__ import annotations

import torch

from ...u32 import widen
from ..raster import BACKGROUND, EMPTY


def resolve_indexed(fb_p, rgba, width: int, height: int):
    """Colour lookup by winning point index (compute_loop_las/resolve.cs).

    fb_p (H*W,) int32 u32 bits, rgba (N,) int32 -> (H, W) int32 image.
    The index clamps as an unsigned value (EMPTY, -1 in int32 bits, is
    2**32 - 1 and clamps to N - 1, as in the reference); EMPTY pixels
    take the background.
    """
    color = rgba[torch.clamp(widen(fb_p), max=rgba.shape[0] - 1)]
    img = torch.where(fb_p != EMPTY, color, torch.full_like(color, BACKGROUND))
    return img.reshape(height, width)
