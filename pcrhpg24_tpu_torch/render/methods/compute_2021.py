"""2021-paper baseline methods over the 16 B/point standard format.

Counterpart of `pcrhpg24_tpu/render/methods/compute_2021.py`.  The
source system's five 2021 methods (modules/compute_2021_*: `early-z`,
`early-z & reduce`, `dedup`, `hqs`, `GL_POINTS`) differ only in GPU
scheduling tricks around the same math (an early depth test before the
atomic, warp-level deduplication of identical pixels, ballot
reductions) plus one classic GL_POINTS pipeline; their images are
identical.  As in the reference, `early-z`, `early-z & reduce`, `dedup`
and `GL_POINTS` are one frame registered under each name (`VARIANTS`),
and `hqs` is the average-blend variant.  Positions are the resource's
f32 planes; the projection is `raster.project_points`; B3 resolves each
frame's chunks in one launch, and HQS adds B4 with the colour as the
payload (`loop_las.resolve_parts`).
"""

from __future__ import annotations

import torch

from .loop_las import CHUNK_PTS, LasMethod, mask_pid, point_index, resolve_parts
from ..raster import project_points


def raster_chunk_f32(fx, fy, fz, transform, base_index: int, width: int, height: int,
                     n_valid: int):
    """(pid, depth, index) of one chunk (`compute_2021.py:31-52`) of f32
    render-frame positions from `base_index`; points at or past
    `n_valid` drop."""
    pid, dep = project_points(fx, fy, fz, transform, width, height)
    idx = point_index(base_index, pid.shape, pid.device)
    return mask_pid(pid, idx < n_valid, width * height), dep, idx


def compute2021_parts(dev, transform, points: int, width: int, height: int):
    """The (pid, depth, index) part of each 256-batch chunk of the first
    `points` points of `LasStandardData.dev`."""
    return [raster_chunk_f32(*(dev[k][s:s + CHUNK_PTS][:points - s] for k in ("fx", "fy", "fz")),
                             transform, s, width, height, points)
            for s in range(0, points, CHUNK_PTS)]


def compute2021_frame(dev, transform, points: int, width: int, height: int,
                      hqs: bool = False, plain: bool = False):
    """One frame -> (fb_depth, fb_payload or acc_n, image); `hqs` blends
    (`Compute2021Hqs.render`, `compute_2021.py:214-246`)."""
    parts = compute2021_parts(dev, transform, points, width, height)
    return resolve_parts(parts, dev["rgba"], width, height, hqs, plain)


class Compute2021(LasMethod):
    FRAME = staticmethod(compute2021_frame)
    VARIANTS = ("2021 early-z", "2021 early-z & reduce", "2021 dedup", "GL_POINTS")

    def __init__(self, renderer, las, name="2021 early-z"):
        super().__init__(renderer, las, name)
        self.description = "2021 baseline; standard 16 byte per point"
        self.group = "2021 method; standard 16 byte per point"

    def frame_args(self, renderer) -> dict:
        las = self.las
        return dict(dev=las.dev, transform=torch.from_numpy(self.wvp(renderer)).to(las.device),
                    points=las.num_points_loaded, width=renderer.width,
                    height=renderer.height, hqs=self.HQS)


class Compute2021Hqs(Compute2021):
    HQS = True

    def __init__(self, renderer, las):
        super().__init__(renderer, las, name="2021 hqs")
        self.description = "2021 HQS baseline (average blend)"
