"""Reference frames of a `.tpc` v2 scene from its raw points.

Set-up, worked out again: each chunk of up to 100 batches (6,553,600
points) Morton-sorted, 65,536-point batches of 1024 chains of 64
consecutive points, each batch's BC1 colours, its box (the grid's min
and max, then f64 `* scale + offset - las_min`, stored f32) and its
anchor (the component-wise min of its chains' first points).  A frame:
the host's f64 LOD bucket, the device's f32 cull and LOD, each visible
batch's chains projected batch-relative with the f64-folded translation
(`(x - anchor) * scale`, `((t0 x + t1 y) + t2 z) + tb`, `inv = 1 / w`),
the exact per-pixel min of (depth bits << 32 | colour), or the HQS blend.
"""

from __future__ import annotations

import numpy as np
import torch

from .bc1 import bc1_batches
from .common import (BATCH, CHAINS, POINTS_PER_THREAD, Planes, depth_bits, device_lod, host_lod,
                     screen_pid)
from .morton import morton_order

CHUNK_POINTS = 100 * BATCH  # the preprocessor's IO chunk
BLOCK = 64  # batches projected at a time


def batch_translations(wvp, anchors, scale, offset, las_min):
    world = anchors.astype(np.float64) * np.asarray(scale, np.float64) \
        + np.asarray(offset, np.float64) - np.asarray(las_min, np.float64)
    wvp = np.asarray(wvp, np.float64)
    return (world @ wvp[:, :3].T + wvp[:, 3]).astype(np.float32)


def sorted_points(points, device):
    """The points Morton-sorted within each IO chunk: (n, 3) int32 grid on
    the device and (n,) u32 colours on the host."""
    g = torch.from_numpy(points.grid).to(device)
    order = torch.cat([s + morton_order(*g[s:s + CHUNK_POINTS].unbind(1))
                       for s in range(0, points.n, CHUNK_POINTS)])
    return g[order], points.color[order.cpu().numpy()]


class Reference:
    def __init__(self, points, traffic: dict, device, pmap=map):
        dev = self.device = torch.device(device)
        grid_d, color = sorted_points(points, dev)
        step = 16 * BATCH  # batches a worker task
        color = np.concatenate(list(pmap(bc1_batches, (color[s:s + step]
                                                       for s in range(0, len(color), step)))))
        grid = grid_d.cpu().numpy().reshape(-1, BATCH, 3)
        color = color.reshape(-1, BATCH)
        self.B = grid.shape[0]
        self.scale, self.offset, self.las_min = points.scale, points.offset, points.cmin
        self.lod = float(traffic["lod"])
        world_lo = grid.min(axis=1).astype(np.float64) * self.scale + self.offset
        world_hi = grid.max(axis=1).astype(np.float64) * self.scale + self.offset
        self.bbox_min = (world_lo - self.las_min).astype(np.float32)
        self.bbox_max = (world_hi - self.las_min).astype(np.float32)
        self.anchors = grid.reshape(self.B, CHAINS, POINTS_PER_THREAD, 3)[:, :, 0].min(axis=1)
        self.anchors = self.anchors.astype(np.int64)
        self.grid = grid_d.reshape(self.B, BATCH, 3)
        self.color = torch.from_numpy(color.view(np.int32)).to(dev)
        self.bmin_d = torch.from_numpy(self.bbox_min).to(dev)
        self.bmax_d = torch.from_numpy(self.bbox_max).to(dev)
        self.anchor_d = torch.from_numpy(self.anchors.astype(np.int32)).to(dev)
        self.scale_d = torch.tensor(np.asarray(self.scale, np.float32), device=dev)

    def visible_points(self, v) -> int:
        """The frame's work: each visible batch's chains' LOD points."""
        return int(host_lod(v, self.bbox_min, self.bbox_max, self.lod).astype(np.int64).sum()
                   * CHAINS)

    def live(self, v):
        """(indices of the live 64-batch chunks, the LOD bucket) of the
        frame, by the host rule."""
        lod = host_lod(v, self.bbox_min, self.bbox_max, self.lod)
        pad = np.zeros(-(-len(lod) // BLOCK) * BLOCK, np.int32)
        pad[:len(lod)] = lod
        live = np.nonzero(pad.reshape(-1, BLOCK).any(axis=1))[0]
        return live, max(16, -(-int(lod.max()) // 16) * 16)

    def frame(self, v, hqs: bool, dtype=torch.float32):
        """(H, W) int32 image; `dtype` the precision of the projection."""
        W, H = v.width, v.height
        lod_full = host_lod(v, self.bbox_min, self.bbox_max, self.lod)
        points = max(16, -(-int(lod_full.max()) // 16) * 16)
        wvp = v.proj @ v.view
        fp = np.zeros(40, np.float32)
        fp[0:16] = v.view.astype(np.float32).reshape(-1)
        fp[16:22] = v.proj_params.astype(np.float32)
        fp[22] = self.lod
        fp[23] = float(self.B)
        fp[24:40] = wvp.astype(np.float32).reshape(-1)
        tb = batch_translations(wvp, self.anchors, self.scale, self.offset, self.las_min)
        d = torch.from_numpy(np.concatenate([fp, tb.ravel()])).to(self.device)
        lod_n = device_lod(d[0:16].reshape(4, 4), d[16:22], self.bmin_d, self.bmax_d,
                           d[23].to(torch.int32), W, H, d[22])
        lod_n = torch.clamp(lod_n, max=points)
        t = d[24:40].reshape(4, 4)
        f12 = torch.cat([t[0, :3], t[1, :3], t[3, :3], self.scale_d]).to(dtype)
        tb_d = d[40:].reshape(self.B, 4).to(dtype)
        planes = Planes(W * H, self.device)
        passes = ("min", "blend") if hqs else ("min",)
        for what in passes:
            for b0 in range(0, self.B, BLOCK):
                sl = slice(b0, b0 + BLOCK)
                c = self.grid[sl].reshape(-1, CHAINS, POINTS_PER_THREAD, 3)
                a = self.anchor_d[sl][:, None, None, :]
                xs = (c[..., 0] - a[..., 0]).to(dtype) * f12[9]
                ys = (c[..., 1] - a[..., 1]).to(dtype) * f12[10]
                zs = (c[..., 2] - a[..., 2]).to(dtype) * f12[11]
                tb = tb_d[sl][:, None, None, :]
                cx = f12[0] * xs + f12[1] * ys + f12[2] * zs + tb[..., 0]
                cy = f12[3] * xs + f12[4] * ys + f12[5] * zs + tb[..., 1]
                w = f12[6] * xs + f12[7] * ys + f12[8] * zs + tb[..., 3]
                i = torch.arange(POINTS_PER_THREAD, device=self.device)
                keep = i[None, None, :] < lod_n[sl][:, None, None]
                pid, ok = screen_pid(cx, cy, w, W, H, keep)
                pay = self.color[sl].reshape(pid.shape).to(torch.int64)
                if what == "min":
                    planes.add_min(pid, ok, depth_bits(w), pay)
                else:
                    planes.add_blend(pid, ok, w, pay)
        return planes.image(W, H, hqs)
