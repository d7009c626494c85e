"""Camera, orbit controls, frustum and LOD math: host half and device half.

Numerics mirror the reference (reference: include/Camera.h:34-39,
include/OrbitControls.h:116-135, modules/huffman_mem_iter_cuda/
render.cu:247-274 frustum, :346-379 LOD).  Matrices use the glm
column-vector convention: clip = M @ p.

The host half (NumPy f64: `Camera`, `OrbitControls`, the host cull/LOD
helpers and `batch_translations`) is the port's copy of
`pcrhpg24_tpu/render/camera.py`.  The two device functions at the end
run per frame in torch f32.  Where the reference uses `@` and
`jnp.linalg.norm`, they use explicit element-wise ops in the natural
summation order, so results agree to the bit wherever XLA's dot and
reduction round the same way (`tests/test_torch_frame.py` holds `lod_n`
equal on several views).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def perspective(fovy_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspective (GL depth convention)."""
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def rotate(angle: float, axis) -> np.ndarray:
    """glm::rotate: rotation about an arbitrary axis."""
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


def translate(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


@dataclass
class OrbitControls:
    """Yaw/pitch/radius/target orbit camera, Z-up (OrbitControls.h:116-135)."""

    yaw: float = 0.0
    pitch: float = 0.0
    radius: float = 2.0
    target: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def world(self) -> np.ndarray:
        flip = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, -1.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ]
        )  # glm column-major listing transposed into row-major
        return (
            translate(self.target)
            @ rotate(self.yaw, (0, 0, 1))
            @ rotate(self.pitch, (1, 0, 0))
            @ flip
            @ translate((0, 0, self.radius))
        )


@dataclass
class Camera:
    fovy: float = 60.0
    near: float = 0.1
    far: float = 200_000.0
    width: int = 1920
    height: int = 1080
    world: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def view(self) -> np.ndarray:
        return np.linalg.inv(self.world)

    def proj(self) -> np.ndarray:
        return perspective(self.fovy, self.aspect, self.near, self.far)

    def view_proj(self) -> np.ndarray:
        return self.proj() @ self.view()

    def proj_params(self) -> np.ndarray:
        """[a, b, c, d, near, far] — the nonzero perspective terms."""
        p = self.proj()
        return np.array(
            [p[0, 0], p[1, 1], p[2, 2], p[2, 3], self.near, self.far]
        )


def frustum_planes(world_view_proj: np.ndarray) -> np.ndarray:
    """(6,4) planes (normalized normal, constant); Gribb-Hartmann rows

    exactly as the kernel builds them (render.cu:247-256)."""
    m = world_view_proj
    rows = [
        m[3] - m[0],
        m[3] + m[0],
        m[3] + m[1],
        m[3] - m[1],
        m[3] - m[2],
        m[3] + m[2],
    ]
    planes = np.stack(rows)
    n = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    return planes / n


def batches_in_frustum(
    planes: np.ndarray, bbox_min: np.ndarray, bbox_max: np.ndarray
) -> np.ndarray:
    """Vectorized AABB-frustum test over (B,3) boxes (render.cu:257-273)."""
    normals = planes[:, :3]  # (6,3)
    consts = planes[:, 3]
    corner = np.where(normals[None, :, :] > 0, bbox_max[:, None, :], bbox_min[:, None, :])
    d = np.einsum("bpc,pc->bp", corner, normals) + consts[None, :]
    return (d >= 0).all(axis=1)


def lod_points_per_thread(
    world_view: np.ndarray,
    proj: np.ndarray,
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    width: int,
    height: int,
    points_per_thread: int = 64,
    lod_floor: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-batch (num_points_to_render, use_double) (render.cu:346-379).

    bbox arrays are (B,3) in the render coordinate frame.
    """
    center = 0.5 * (bbox_min + bbox_max)
    radius = np.linalg.norm(bbox_min - bbox_max, axis=1)
    ch = np.concatenate([center, np.ones((len(center), 1))], axis=1)
    view_c = ch @ world_view.T
    view_e = view_c + np.stack(
        [radius, np.zeros_like(radius), np.zeros_like(radius), np.zeros_like(radius)], 1
    )
    proj_c = view_c @ proj.T
    proj_e = view_e @ proj.T
    pc = proj_c[:, :2] / proj_c[:, 3:4]
    pe = proj_e[:, :2] / proj_e[:, 3:4]
    sc = 0.5 * (pc + 1.0) * np.array([width, height])
    se = 0.5 * (pe + 1.0) * np.array([width, height])
    pixel_size = np.linalg.norm(se - sc, axis=1)
    use_double = pixel_size >= 100.0
    percentage = np.clip(1.8 * pixel_size / 100.0 - 0.3, lod_floor, 1.0)
    n = np.minimum(
        (percentage * points_per_thread).astype(np.int32), points_per_thread
    )
    return n, use_double


def batch_translations(wvp: np.ndarray, anchors_i: np.ndarray,
                       scale, offset, las_min) -> np.ndarray:
    """Per-batch folded translation column, computed in f64 (B, 4) f32.

    The reference switches to a double-precision decode+project path for
    close-up batches (UseDouble = pixelSize >= 100, render.cu:346-379,
    459-461) because absolute f32 coordinates of km-scale clouds lose
    millimetres.  The TPU-shaped equivalent: decode to batch-relative
    i32 (subtract an exact per-batch anchor), keep the f32 projection on
    the small relative coordinates, and fold the anchor's world-space
    contribution into this per-batch translation column — computed here
    on the host in f64, which costs O(batches), not O(points).

    Tb[b, i] = sum_j wvp[i,j] * (anchor[b]*scale + offset - las_min)[j]
               + wvp[i,3]
    """
    world = anchors_i.astype(np.float64) * np.asarray(scale, np.float64) \
        + np.asarray(offset, np.float64) - np.asarray(las_min, np.float64)
    wvp = np.asarray(wvp, np.float64)
    tb = world @ wvp[:, :3].T + wvp[:, 3]
    return tb.astype(np.float32)


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def stable_frustum_planes(view, proj_params):
    """(6,4) planes from view rows + exact projection coefficients.

    Gribb-Hartmann rows built symbolically from [a,b,c,d,near,far] so the
    far plane keeps full f32 precision (see the reference docstring).
    """
    a, b, _c, d, near, far = (proj_params[i] for i in range(6))
    v0, v1, v2 = view[0], view[1], view[2]
    e4 = torch.zeros(4, dtype=view.dtype, device=view.device)
    e4[3] = 1.0
    one_plus_c = 2.0 * near / (near - far)
    c_minus_1 = 2.0 * far / (near - far)
    planes = torch.stack([
        -v2 - a * v0,
        -v2 + a * v0,
        -v2 + b * v1,
        -v2 - b * v1,
        -one_plus_c * v2 - d * e4,
        c_minus_1 * v2 + d * e4,
    ])
    n = _norm3(planes[:, 0], planes[:, 1], planes[:, 2])[:, None]
    return planes / torch.clamp(n, min=1e-30)


def frame_setup_device(view, proj_params, bbox_min, bbox_max, n_loaded,
                       width: int, height: int, lod_floor, cull: bool,
                       points_per_thread: int = 64):
    """Frustum cull + LOD on the device (render.cu:339-379).

    view (4,4) f32, proj_params (6,) f32, bbox_* (B,3) f32, n_loaded
    0-dim i32, lod_floor 0-dim f32 -> lod_n (B,) i32 (0 = culled).
    """
    a, b, c, d = (proj_params[i] for i in range(4))
    B = bbox_min.shape[0]
    center = 0.5 * (bbox_min + bbox_max)
    e = bbox_min - bbox_max
    radius = _norm3(e[:, 0], e[:, 1], e[:, 2])

    def row(r):  # (center, 1) . view[r]
        return (center[:, 0] * view[r, 0] + center[:, 1] * view[r, 1]
                + center[:, 2] * view[r, 2]) + view[r, 3]

    vc = [row(r) for r in range(4)]
    ve = [vc[0] + radius, vc[1], vc[2], vc[3]]

    def screen(v):  # proj has a, b, c, d at (0,0) (1,1) (2,2) (2,3), -1 at (3,2)
        w = -v[2]
        sx = 0.5 * (v[0] * a / w + 1.0) * width
        sy = 0.5 * (v[1] * b / w + 1.0) * height
        return sx, sy

    scx, scy = screen(vc)
    sex, sey = screen(ve)
    dx, dy = sex - scx, sey - scy
    pixel_size = torch.sqrt(dx * dx + dy * dy)
    percentage = torch.minimum(
        torch.maximum(1.8 * pixel_size / 100.0 - 0.3, lod_floor),
        torch.ones_like(pixel_size))
    n = torch.clamp((percentage * points_per_thread).to(torch.int32),
                    max=points_per_thread)

    if cull:
        planes = stable_frustum_planes(view, proj_params)
        corner = torch.where(planes[None, :, :3] > 0, bbox_max[:, None, :],
                             bbox_min[:, None, :])  # (B, 6, 3)
        dist = (corner[..., 0] * planes[:, 0] + corner[..., 1] * planes[:, 1]
                + corner[..., 2] * planes[:, 2]) + planes[:, 3]
        vis = (dist >= 0).all(dim=1)
        n = torch.where(vis, n, torch.zeros_like(n))

    loaded = torch.arange(B, device=bbox_min.device) < n_loaded
    return torch.where(loaded, n, torch.zeros_like(n))
