"""Reference frames of a raw `.las` scene (the 10-10-10 adaptive
precision path of compute_loop_las) from its raw points.

Set-up, worked out again: each point's render-frame position
`f32(f64(grid) * scale + offset - las_min)`, each 65,536-point batch's
f32 box, the three 10-bit planes of each point against its batch's box.
A frame: the host's f64 cull and precision level of each batch
(render.cs:235-271), each point unpacked at its batch's level and
projected in f32 (`((t0 x + t1 y) + t2 z) + t3`, ndc by division), the
exact per-pixel min of (depth bits << 32 | point index) and the colour of
the winning index, or the HQS blend of the points' colours.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import BATCH, Planes, batches_in_frustum, depth_bits, frustum_planes, screen_pid

STEPS_30BIT = 1 << 30
BLOCK = 256  # batches projected at a time


def precision_levels(view, proj, bbox_min, bbox_max, width, height):
    center = 0.5 * (bbox_min + bbox_max)
    radius = np.linalg.norm(bbox_min - bbox_max, axis=1)
    ch = np.concatenate([center, np.ones((len(center), 1))], 1)
    vc = ch @ view.T
    ve = vc + np.stack([radius, *([np.zeros_like(radius)] * 3)], 1)
    pc = vc @ proj.T
    pe = ve @ proj.T
    sc = 0.5 * (pc[:, :2] / pc[:, 3:4] + 1) * [width, height]
    se = 0.5 * (pe[:, :2] / pe[:, 3:4] + 1) * [width, height]
    ps = np.linalg.norm(se - sc, axis=1)
    level = np.full(len(ps), 0, np.int32)
    level[ps < 10000] = 1
    level[ps < 500] = 2
    level[ps < 200] = 3
    level[ps < 100] = 4
    return level


def pack(pos, lo, hi):
    """The three 10-bit planes of each position against its box."""
    u = (pos - lo) / torch.clamp(hi - lo, min=1e-20) * float(STEPS_30BIT)
    q = torch.clamp(u.to(torch.int32), 0, STEPS_30BIT - 1)

    def plane(shift):
        p = (q >> shift) & 1023
        return p[..., 0] | (p[..., 1] << 10) | (p[..., 2] << 20)

    return plane(20), plane(10), plane(0)


class Reference:
    def __init__(self, points, traffic: dict, device, pmap=map):
        dev = self.device = torch.device(device)
        self.B = points.n // BATCH
        g = torch.from_numpy(points.grid).to(dev)
        f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
        pos = (g.to(torch.float64) * f64(points.scale) + f64(points.offset)
               - f64(points.cmin)).to(torch.float32).reshape(self.B, BATCH, 3)
        del g
        lo, hi = pos.amin(dim=1), pos.amax(dim=1)
        self.bbox_min, self.bbox_max = lo.cpu().numpy(), hi.cpu().numpy()
        self.planes = pack(pos, lo[:, None, :], hi[:, None, :])
        del pos
        self.lo, self.hi = lo, hi
        self.color = torch.from_numpy(points.color.view(np.int32)).to(dev).to(torch.int64)

    def visibility(self, v):
        return batches_in_frustum(frustum_planes(v.proj @ v.view), self.bbox_min, self.bbox_max)

    def visible_points(self, v) -> int:
        """The frame's work: every point of each batch in the frustum."""
        return int(self.visibility(v).sum()) * BATCH

    def frame(self, v, hqs: bool, dtype=torch.float32):
        """(H, W) int32 image; `dtype` the precision of the unpack and projection."""
        W, H = v.width, v.height
        vis = torch.from_numpy(self.visibility(v)).to(self.device)
        level = torch.from_numpy(precision_levels(v.view, v.proj, self.bbox_min, self.bbox_max,
                                                  W, H)).to(self.device)
        t = torch.from_numpy((v.proj @ v.view).astype(np.float32)).to(self.device).to(dtype)
        planes = Planes(W * H, self.device)
        for what in (("min", "blend") if hqs else ("min",)):
            for b0 in range(0, self.B, BLOCK):
                sl = slice(b0, b0 + BLOCK)
                lvl, lo = level[sl, None], level[sl, None] >= 2
                denom = torch.where(lo, 1024.0, float(STEPS_30BIT)).to(dtype)
                unpacked = [[((p[sl] >> s) & 1023) << shift for s in (0, 10, 20)]
                            for p, shift in zip(self.planes, (20, 10, 0))]
                pos = []
                for k in range(3):
                    a4, a8, a12 = (u[k] for u in unpacked)
                    a = torch.where(lvl == 0, a4 | a8 | a12, torch.where(lvl == 1, a4 | a8, a4))
                    s = torch.where(lo, a >> 20, a).to(dtype)
                    mn, mx = self.lo[sl, k:k + 1].to(dtype), self.hi[sl, k:k + 1].to(dtype)
                    pos.append(s * ((mx - mn) / denom) + mn)
                fx, fy, fz = pos
                cx = t[0, 0] * fx + t[0, 1] * fy + t[0, 2] * fz + t[0, 3]
                cy = t[1, 0] * fx + t[1, 1] * fy + t[1, 2] * fz + t[1, 3]
                w = t[3, 0] * fx + t[3, 1] * fy + t[3, 2] * fz + t[3, 3]
                pid, ok = screen_pid(cx, cy, w, W, H, vis[sl, None], divide=True)
                index = torch.arange(b0 * BATCH, b0 * BATCH + pid.numel(),
                                     device=self.device).reshape(pid.shape)
                if what == "min":
                    planes.add_min(pid, ok, depth_bits(w), index)
                else:
                    planes.add_blend(pid, ok, w, self.color[index])
        if hqs:
            return planes.image(W, H, hqs=True)
        landed = planes.key != (2**63 - 1)
        idx = torch.where(landed, planes.key & 0xFFFFFFFF, torch.zeros_like(planes.key))
        img = torch.where(landed, self.color[idx], torch.full_like(idx, 0x00443322))
        return img.to(torch.int32).reshape(H, W)
