"""`basic` — simplest dense method: raw int32 SoA, scale+offset, raster.

Counterpart of `pcrhpg24_tpu/render/methods/basic.py`, after the source
system's modules/basic_cuda (render.cu:96-140): position = int coords
* scale + (offset - las_min) in f32, payload = point index, colour at
the resolve.  Each 256-batch chunk of the loaded points is one part;
B3 resolves a frame's parts in one launch (`loop_las.resolve_parts`).
Also the method of `.laz` and multi-file scenes (`engine/las_sparse`).
"""

from __future__ import annotations

import numpy as np
import torch

from .loop_las import CHUNK_PTS, LasMethod, mask_pid, point_index, resolve_parts
from ..raster import project_points


def raster_chunk_basic(x, y, z, scale, offset_rel, transform, base_index: int,
                       width: int, height: int, n_valid: int):
    """(pid, depth, index) of one chunk (`basic.py:23-46`): x, y, z int32
    grid coordinates of the points from `base_index`; scale and
    offset_rel (3,) f32; points at or past `n_valid` drop."""
    pos = [a.to(torch.float32) * scale[k] + offset_rel[k] for k, a in enumerate((x, y, z))]
    pid, dep = project_points(*pos, transform, width, height)
    idx = point_index(base_index, pid.shape, pid.device)
    return mask_pid(pid, idx < n_valid, width * height), dep, idx


def basic_parts(dev, scale, offset_rel, transform, points: int, width: int, height: int):
    """The (pid, depth, index) part of each 256-batch chunk of the first
    `points` points: `dev` holds `ComputeLasDataBasic`'s (or
    `LasSparseData`'s) x, y and z; `points` is `num_points_loaded`, the
    mask's `n_valid`."""
    return [raster_chunk_basic(*(dev[k][s:s + CHUNK_PTS][:points - s] for k in "xyz"),
                               scale, offset_rel, transform, s, width, height, points)
            for s in range(0, points, CHUNK_PTS)]


def basic_frame(dev, scale, offset_rel, transform, points: int, width: int, height: int,
                plain: bool = False):
    """One frame -> (fb_depth, fb_payload, image): `basic_parts` resolved
    by B3 (`plain=True`: its plain version) and the colour lookup."""
    parts = basic_parts(dev, scale, offset_rel, transform, points, width, height)
    return resolve_parts(parts, dev["rgba"], width, height, plain=plain)


class BasicMethod(LasMethod):
    FRAME = staticmethod(basic_frame)

    def __init__(self, renderer, las, name="basic"):
        super().__init__(renderer, las, name)
        self.description = "raw int32 SoA, scale+offset, rasterize"
        self.group = "none"

    def frame_args(self, renderer) -> dict:
        """Keyword arguments of `basic_frame`: the wvp, the scale and the
        offset relative to las_min (f64, then f32) in one host -> device
        copy."""
        las = self.las
        packed = torch.from_numpy(np.concatenate([
            self.wvp(renderer).ravel(), np.asarray(las.scale, np.float32),
            np.asarray(las.offset - las.las_min, np.float32)])).to(las.device)
        return dict(dev=las.dev, scale=packed[16:19], offset_rel=packed[19:22],
                    transform=packed[:16].reshape(4, 4), points=las.num_points_loaded,
                    width=renderer.width, height=renderer.height)
