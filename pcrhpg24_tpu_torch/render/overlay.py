"""Bounding-box wireframe overlay.

Counterpart of `pcrhpg24_tpu/render/overlay.py` (the reference's
drawBoundingBoxes.h / drawBoxes.h): each box's 12 edges are sampled at
64 points, projected like `raster.project_points` (true division
`cx / w`), and the samples that land on screen overwrite their pixel
with the box colour.  A few thousand samples: torch ops, no kernel.
Duplicate samples write the same colour, so the order of the writes
does not matter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .raster import project_points

_EDGES = np.array(
    [
        (0, 1), (1, 3), (3, 2), (2, 0),  # bottom
        (4, 5), (5, 7), (7, 6), (6, 4),  # top
        (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
    ]
)
# corner k = (x, y, z) bits of k, x the highest
_SEL = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)

SAMPLES = 64  # points per edge
BOX_COLOR = 0x0000FFFF


def edge_steps() -> np.ndarray:
    """`jnp.linspace(0, 1, SAMPLES)` as XLA computes it: i * f32(1 / 63)
    (the division by a constant becomes a multiply by its reciprocal),
    then the end point 1."""
    i = np.arange(SAMPLES - 1, dtype=np.float32)
    return np.append(i * (np.float32(1) / np.float32(SAMPLES - 1)), np.float32(1))


@functools.lru_cache(maxsize=None)
def _constants(device):
    """The corner selectors, their complements, the edges' corner indices
    and the sample steps on `device` (copied there once)."""
    put = lambda a: torch.from_numpy(a).to(device)
    return (put(_SEL), put(1 - _SEL), put(_EDGES[:, 0]), put(_EDGES[:, 1]),
            put(edge_steps()))


def draw_bounding_boxes(image, bbox_min, bbox_max, transform, width: int, height: int,
                        color: int = BOX_COLOR):
    """image (H, W) int32; bbox_* (B, 3) f32 in the render frame;
    transform (4, 4) f32 world-view-projection -> the image with boxes
    (a new tensor)."""
    sel, unsel, i0, i1, t = _constants(image.device)
    corners = bbox_min[:, None, :] * unsel[None] + bbox_max[:, None, :] * sel[None]
    e0 = corners[:, i0]  # (B, 12, 3)
    e1 = corners[:, i1]
    pts = (e0[:, :, None, :] + (e1 - e0)[:, :, None, :] * t[None, None, :, None]).reshape(-1, 3)
    pid, _depth = project_points(pts[:, 0], pts[:, 1], pts[:, 2], transform, width, height)
    # one slot past the image takes the samples off screen
    flat = torch.cat([image.reshape(-1), image.new_zeros(1)])
    flat[pid.to(torch.int64)] = color
    return flat[: width * height].reshape(height, width)
