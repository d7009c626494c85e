"""Camera, frustum, LOD and projection arithmetic shared by the
references: frozen copies of the formulas the reference system states
(include/Camera.h, include/OrbitControls.h, huffman_mem_iter_cuda/
render.cu:247-379, compute_loop_las/render.cs:235-271), in the operation
order whose rounding the port's frames keep.

Host parts are NumPy f64; device parts plain torch f32 ops (one rounding
each, never fused).
"""

from __future__ import annotations

import math

import numpy as np
import torch

BACKGROUND = 0x00443322
POINTS_PER_THREAD = 64
CHAINS = 1024
BATCH = CHAINS * POINTS_PER_THREAD
INT64_MAX = 2**63 - 1


# ---- host: the orbit camera (f64) ----

def perspective(fovy_deg, aspect, near, far):
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def rotate(angle, axis):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = axis
    C = 1 - c
    m = np.eye(4)
    m[:3, :3] = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return m


def translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


class View:
    """One frame's camera: an orbit (yaw, pitch, radius, target) and a
    60-degree perspective of (width, height), near 0.1, far 200,000."""

    FOVY, NEAR, FAR = 60.0, 0.1, 200_000.0

    def __init__(self, yaw, pitch, radius, target, width: int, height: int):
        flip = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                         [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
        world = (translate(np.asarray(target, np.float64)) @ rotate(yaw, (0, 0, 1))
                 @ rotate(pitch, (1, 0, 0)) @ flip @ translate((0, 0, radius)))
        self.width, self.height = width, height
        self.view = np.linalg.inv(world)
        self.proj = perspective(self.FOVY, width / height, self.NEAR, self.FAR)
        p = self.proj
        self.proj_params = np.array([p[0, 0], p[1, 1], p[2, 2], p[2, 3], self.NEAR, self.FAR])


def orbit(traffic: dict, config: dict, seed: int, i: int):
    """(yaw, pitch, radius, target) of frame `i` of the traffic's orbit
    around the configuration's scene: the target at a point of its extent
    (`target_of_extent`, `target_z` metres up), the radius a multiple of
    its longer side; the yaw advances one step a frame from a start drawn
    from the seed."""
    o = traffic["orbit"]
    ext = [float(e) for e in config["extent_m"]]
    start = o["yaw"] + 2 * math.pi * ((seed * 2654435761) % 2**32) / 2**32
    target = [f * e for f, e in zip(o["target_of_extent"], ext)] + [o["target_z"]]
    return (start + i * (2 * math.pi / o["steps_per_turn"]), o["pitch"],
            o["radius_per_extent"] * max(ext), target)


def view(traffic: dict, config: dict, seed: int, i: int) -> "View":
    return View(*orbit(traffic, config, seed, i), traffic["width"], traffic["height"])


def frustum_planes(m):
    rows = [m[3] - m[0], m[3] + m[0], m[3] + m[1], m[3] - m[1], m[3] - m[2], m[3] + m[2]]
    planes = np.stack(rows)
    n = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    return planes / n


def batches_in_frustum(planes, bbox_min, bbox_max):
    normals = planes[:, :3]
    consts = planes[:, 3]
    corner = np.where(normals[None, :, :] > 0, bbox_max[:, None, :], bbox_min[:, None, :])
    d = np.einsum("bpc,pc->bp", corner, normals) + consts[None, :]
    return (d >= 0).all(axis=1)


def lod_points(view, proj, bbox_min, bbox_max, width, height, lod_floor):
    """Per-batch points a chain renders (render.cu:346-379), host f64."""
    center = 0.5 * (bbox_min + bbox_max)
    radius = np.linalg.norm(bbox_min - bbox_max, axis=1)
    ch = np.concatenate([center, np.ones((len(center), 1))], axis=1)
    view_c = ch @ view.T
    view_e = view_c + np.stack(
        [radius, np.zeros_like(radius), np.zeros_like(radius), np.zeros_like(radius)], 1)
    proj_c = view_c @ proj.T
    proj_e = view_e @ proj.T
    pc = proj_c[:, :2] / proj_c[:, 3:4]
    pe = proj_e[:, :2] / proj_e[:, 3:4]
    sc = 0.5 * (pc + 1.0) * np.array([width, height])
    se = 0.5 * (pe + 1.0) * np.array([width, height])
    pixel_size = np.linalg.norm(se - sc, axis=1)
    percentage = np.clip(1.8 * pixel_size / 100.0 - 0.3, lod_floor, 1.0)
    return np.minimum((percentage * POINTS_PER_THREAD).astype(np.int32), POINTS_PER_THREAD)


def host_lod(v: View, bbox_min, bbox_max, lod_floor):
    """(B,) i32 points a chain renders, 0 where the batch is culled."""
    vis = batches_in_frustum(frustum_planes(v.proj @ v.view), bbox_min, bbox_max)
    n = lod_points(v.view, v.proj, bbox_min, bbox_max, v.width, v.height, lod_floor)
    return np.where(vis, n, 0).astype(np.int32)


# ---- device: f32, one rounding per op ----

def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def frustum_planes_device(view, pp):
    a, b, _c, d, near, far = (pp[i] for i in range(6))
    v0, v1, v2 = view[0], view[1], view[2]
    e4 = torch.zeros(4, dtype=view.dtype, device=view.device)
    e4[3] = 1.0
    one_plus_c = 2.0 * near / (near - far)
    c_minus_1 = 2.0 * far / (near - far)
    planes = torch.stack([-v2 - a * v0, -v2 + a * v0, -v2 + b * v1, -v2 - b * v1,
                          -one_plus_c * v2 - d * e4, c_minus_1 * v2 + d * e4])
    n = _norm3(planes[:, 0], planes[:, 1], planes[:, 2])[:, None]
    return planes / torch.clamp(n, min=1e-30)


def device_lod(view, pp, bbox_min, bbox_max, n_loaded, width, height, lod_floor):
    """(B,) i32 points a chain renders, cull and LOD in device f32."""
    a, b = pp[0], pp[1]
    B = bbox_min.shape[0]
    center = 0.5 * (bbox_min + bbox_max)
    e = bbox_min - bbox_max
    radius = _norm3(e[:, 0], e[:, 1], e[:, 2])

    def row(r):
        return (center[:, 0] * view[r, 0] + center[:, 1] * view[r, 1]
                + center[:, 2] * view[r, 2]) + view[r, 3]

    vc = [row(r) for r in range(4)]
    ve = [vc[0] + radius, vc[1], vc[2], vc[3]]

    def screen(v):
        w = -v[2]
        return 0.5 * (v[0] * a / w + 1.0) * width, 0.5 * (v[1] * b / w + 1.0) * height

    scx, scy = screen(vc)
    sex, sey = screen(ve)
    dx, dy = sex - scx, sey - scy
    pixel_size = torch.sqrt(dx * dx + dy * dy)
    percentage = torch.minimum(torch.maximum(1.8 * pixel_size / 100.0 - 0.3, lod_floor),
                               torch.ones_like(pixel_size))
    n = torch.clamp((percentage * POINTS_PER_THREAD).to(torch.int32), max=POINTS_PER_THREAD)
    planes = frustum_planes_device(view, pp)
    corner = torch.where(planes[None, :, :3] > 0, bbox_max[:, None, :], bbox_min[:, None, :])
    dist = (corner[..., 0] * planes[:, 0] + corner[..., 1] * planes[:, 1]
            + corner[..., 2] * planes[:, 2]) + planes[:, 3]
    n = torch.where((dist >= 0).all(dim=1), n, torch.zeros_like(n))
    loaded = torch.arange(B, device=bbox_min.device) < n_loaded
    return torch.where(loaded, n, torch.zeros_like(n))


def screen_pid(cx, cy, w, width, height, extra_ok=None, divide=False):
    """Linear pixel of each projected point and whether it lands: ndc by
    1/w products (`divide=False`, B2's) or by divisions (the torch
    projection's)."""
    if divide:
        ndc_x, ndc_y = cx / w, cy / w
    else:
        inv = torch.ones_like(w) / w
        ndc_x, ndc_y = cx * inv, cy * inv
    ok = (w > 0) & (ndc_x.abs() <= 1) & (ndc_y.abs() <= 1)
    if extra_ok is not None:
        ok = extra_ok & ok
    px = ((ndc_x * 0.5 + 0.5) * width).to(torch.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).to(torch.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    return px.to(torch.int64) + py.to(torch.int64) * width, ok


def depth_bits(w):
    """The f32 bits of each depth as int64 (>= 0 where w > 0)."""
    return w.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)


class Planes:
    """One frame's running per-pixel planes, linear pixels: the u64 min of
    (depth << 32 | payload), and for HQS the blend's four sums."""

    def __init__(self, size: int, device):
        self.size = size
        self.key = torch.full((size,), INT64_MAX, dtype=torch.int64, device=device)
        self.sums = None

    def add_min(self, pid, ok, dep, pay):
        key = (dep << 32) | (pay & 0xFFFFFFFF)
        idx = torch.where(ok, pid, torch.full_like(pid, self.size))
        full = torch.cat([self.key, self.key.new_full((1,), INT64_MAX)])
        full.scatter_reduce_(0, idx.reshape(-1), key.reshape(-1), reduce="amin")
        self.key = full[:self.size]

    def add_blend(self, pid, ok, w, pay):
        """Sums of the entries within 1% of the pixel's nearest depth (the
        `add_min` pass over every entry done first)."""
        if self.sums is None:
            self.sums = torch.zeros((4, self.size + 1), dtype=torch.int64,
                                    device=self.key.device)
        near = (self.key >> 32).to(torch.int32).view(torch.float32)
        q = torch.where(ok, pid, torch.zeros_like(pid))
        tol = torch.tensor(1.01, dtype=torch.float32, device=w.device)
        accept = ok & (w.to(torch.float32) <= near[q] * tol)
        idx = torch.where(accept, pid, torch.full_like(pid, self.size)).reshape(-1)
        p = pay.reshape(-1)
        for k, v in enumerate((p & 255, (p >> 8) & 255, (p >> 16) & 255, torch.ones_like(p))):
            self.sums[k].index_add_(0, idx, v)

    def image(self, width: int, height: int, hqs: bool):
        """(H, W) int32 image: the winner's payload, or the blend's averages."""
        if hqs:
            r, g, b, n = (self.sums[k, :self.size] for k in range(4))
            m = torch.clamp(n, min=1)
            color = (r // m) | ((g // m) << 8) | ((b // m) << 16)
            img = torch.where(n != 0, color, torch.full_like(color, BACKGROUND))
        else:
            img = torch.where(self.key != INT64_MAX, self.key & 0xFFFFFFFF,
                              torch.full_like(self.key, BACKGROUND))
        return img.to(torch.int32).reshape(height, width)
