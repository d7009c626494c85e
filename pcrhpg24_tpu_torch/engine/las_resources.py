"""Uncompressed / fixed-point LAS scene resources.

Counterpart of `pcrhpg24_tpu/engine/las_resources.py`: three loaders of
a `.las` file, after the source system's non-Huffman resource types:

* ComputeLasData — adaptive 10/20/30-bit batch-relative fixed point in
  three packed-u32 planes (reference: modules/compute/ComputeLasLoader.h
  + modules/compute/computeLasLoader.cs:280-345), packed on the device
  by `pack_101010`;
* ComputeLasDataBasic — raw int32 SoA + colour (ComputeLasLoader.h:
  111-223);
* LasStandardData — 16 B/point: f32 xyz + RGBA8 (the 2021 baseline,
  modules/compute/LasLoaderStandard.h:110-175).

Each `process()` call reads the next four batches on the host, pads the
last batch by repeating its last point, computes the render-frame
positions `f32(grid * scale + offset - las_min)` and the batch boxes in
f64 on the host, and uploads into device buffers preallocated to whole
256-batch chunks (`RENDER_CHUNK_BATCHES`).  u32 planes are int32
tensors holding the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_of
from ..constants import POINTS_PER_WORKGROUP, RENDER_CHUNK_BATCHES
from ..formats.las import read_header, read_points
from .resource import Resource, ResourceState, upload_rows

STEPS_30BIT = 1 << 30
MASK_10BIT = 1023


def pack_101010(pos, wg_min, wg_max):
    """computeLasLoader.cs:280-345 in torch ops (`las_resources.py:31-47`,
    whose colour plane passes through unchanged).

    pos: (..., 3) f32 render-frame positions; wg_min/wg_max: the f32
    batch box of each point, broadcastable to pos (per point, or per
    batch as (nb, 1, 3) against (nb, 65536, 3) positions).  Returns the
    (xyz4, xyz8, xyz12) planes, int32 holding the u32 bits:
    `u = (pos - min) / max(box, 1e-20) * 2**30` lies in [0, 2**30], is
    truncated and clamped to 2**30 - 1, and its three 10-bit slices
    (bits 20-29, 10-19, 0-9) pack x | y << 10 | z << 20."""
    box = wg_max - wg_min
    u = (pos - wg_min) / torch.clamp(box, min=1e-20) * float(STEPS_30BIT)
    q = torch.clamp(u.to(torch.int32), 0, STEPS_30BIT - 1)

    def plane(shift):
        p = (q >> shift) & MASK_10BIT
        return p[..., 0] | (p[..., 1] << 10) | (p[..., 2] << 20)

    return plane(20), plane(10), plane(0)


class LasResource(Resource):
    """The header, counters, boxes and synchronous chunked loading that
    the three `.las` resources share; each names its device planes
    (`PLANES`, key -> dtype) and stores a chunk's points (`_store`)."""

    PLANES: dict = {}

    def __init__(self, path: str, device):
        self.device = device_of(device)
        self.path = path
        h = read_header(path)
        self.header = h
        self.num_points = h.num_points
        self.num_batches = (h.num_points + POINTS_PER_WORKGROUP - 1) // POINTS_PER_WORKGROUP
        self.num_points_loaded = 0
        self.num_batches_loaded = 0
        self.scale = h.scale
        self.offset = h.offset
        self.las_min = h.cmin
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        self.dev: dict[str, torch.Tensor] = {}

    @classmethod
    def create(cls, path: str, device):
        return cls(path, device)

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        n_pad = (-(-self.num_batches // RENDER_CHUNK_BATCHES) * RENDER_CHUNK_BATCHES
                 * POINTS_PER_WORKGROUP)
        self.dev = {k: torch.zeros(n_pad, dtype=dt, device=self.device)
                    for k, dt in self.PLANES.items()}

    def process(self, renderer=None, chunk_points: int = 4 * POINTS_PER_WORKGROUP):
        """Read, pad and upload the next chunk of points (synchronous)."""
        if self.state in (ResourceState.LOADED, ResourceState.UNLOADED):
            return
        start = self.num_points_loaded
        if start >= self.num_points:
            self.state = ResourceState.LOADED
            return
        count = min(chunk_points, self.num_points - start)
        pts = read_points(self.path, start, count)
        pad = (-len(pts.x)) % POINTS_PER_WORKGROUP
        rep = lambda a, dt: np.concatenate([a, np.full(pad, a[-1], dt)])
        x, y, z = (rep(a, np.int32) for a in (pts.x, pts.y, pts.z))
        c = rep(pts.color, np.uint32)
        xyz = np.stack([x, y, z], 1).astype(np.int32)
        # render frame: float(double(grid)*scale + offset - las_min)
        # (computeLasLoader.cs:179-181)
        rel = (xyz.astype(np.float64) * self.scale + self.offset - self.las_min
               ).astype(np.float32)
        nb = len(x) // POINTS_PER_WORKGROUP
        wb = rel.reshape(nb, POINTS_PER_WORKGROUP, 3)
        b0 = start // POINTS_PER_WORKGROUP
        self.bbox_min[b0:b0 + nb] = wb.min(axis=1)
        self.bbox_max[b0:b0 + nb] = wb.max(axis=1)
        self._store(start, xyz, rel, c.view(np.int32))
        self.num_points_loaded = start + len(x)
        self.num_batches_loaded = self.num_points_loaded // POINTS_PER_WORKGROUP
        if self.num_points_loaded >= self.num_points:
            self.state = ResourceState.LOADED

    def _store(self, start: int, xyz: np.ndarray, rel: np.ndarray, rgba: np.ndarray):
        raise NotImplementedError

    def unload(self, renderer=None):
        self.dev = {}
        self.num_points_loaded = 0
        self.num_batches_loaded = 0
        self.state = ResourceState.UNLOADED

    def wait_loaded(self, renderer=None):
        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer)
        return self


class ComputeLasData(LasResource):
    """10-10-10 adaptive precision scene (the 2022 paper's main format):
    the positions go to the card, where `pack_101010` packs each batch
    against its box."""

    PLANES = dict(xyz4=torch.int32, xyz8=torch.int32, xyz12=torch.int32, rgba=torch.int32)

    def _store(self, start, xyz, rel, rgba):
        nb = len(rel) // POINTS_PER_WORKGROUP
        b0 = start // POINTS_PER_WORKGROUP
        packed = torch.from_numpy(np.concatenate([  # one host -> device copy
            rel.ravel(), self.bbox_min[b0:b0 + nb].ravel(),
            self.bbox_max[b0:b0 + nb].ravel()])).to(self.device)
        n3 = rel.size
        pos = packed[:n3].reshape(nb, POINTS_PER_WORKGROUP, 3)
        wmin = packed[n3:n3 + 3 * nb].reshape(nb, 1, 3)
        wmax = packed[n3 + 3 * nb:].reshape(nb, 1, 3)
        sl = slice(start, start + len(rel))
        for key, plane in zip(("xyz4", "xyz8", "xyz12"), pack_101010(pos, wmin, wmax)):
            self.dev[key][sl] = plane.reshape(-1)
        upload_rows(self.dev["rgba"], start, rgba)


class ComputeLasDataBasic(LasResource):
    """Raw int32 SoA + colour (basic_cuda's resource)."""

    PLANES = dict(x=torch.int32, y=torch.int32, z=torch.int32, rgba=torch.int32)

    def _store(self, start, xyz, rel, rgba):
        for k, key in enumerate("xyz"):
            upload_rows(self.dev[key], start, xyz[:, k])
        upload_rows(self.dev["rgba"], start, rgba)


class LasStandardData(LasResource):
    """16 B/point standard format: f32 xyz + RGBA8 (2021 baselines),
    stored as f32 planes in the render frame (world - las_min, like
    LasLoaderStandard's XYZ floats)."""

    PLANES = dict(fx=torch.float32, fy=torch.float32, fz=torch.float32, rgba=torch.int32)

    def _store(self, start, xyz, rel, rgba):
        for k, key in enumerate(("fx", "fy", "fz")):
            upload_rows(self.dev[key], start, rel[:, k])
        upload_rows(self.dev["rgba"], start, rgba)
