"""Device half of `pcrhpg24_tpu/render/camera.py`, in torch f32.

`Camera`, `OrbitControls`, `batch_translations` and the host cull/LOD
helpers are jax-free in the reference and are imported from there.
The two functions below run per frame on the device.  Where the
reference uses `@` and `jnp.linalg.norm`, they use explicit
element-wise ops in the natural summation order, so results agree to
the bit wherever XLA's dot and reduction round the same way
(`tests/test_torch_frame.py` holds `lod_n` equal on several views).
"""

from __future__ import annotations

import torch

from pcrhpg24_tpu.render.camera import (  # noqa: F401  (re-exported)
    Camera,
    OrbitControls,
    batch_translations,
    batches_in_frustum,
    frustum_planes,
    lod_points_per_thread,
)


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
