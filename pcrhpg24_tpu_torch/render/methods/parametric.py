"""`parametric` — procedurally generated point surfaces, no resource.

Counterpart of `pcrhpg24_tpu/render/methods/parametric.py` (itself
after the source's modules/compute_parametric): every frame evaluates a
parametric surface (sphere or wave) on a 2048 x 1024 (u, v) grid,
shades it by (u, v, height), projects it in linear pixel ids and
resolves the exact u64 min through one sort by pid and kernel B6
(`raster.sorted_resolve_u64_min`).  Generation and projection are torch
ops, as they are XLA ops in the reference, in the reference's op order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...engine.method import Method
from ..raster import project_points, resolve, sorted_resolve_u64_min

N_U, N_V = 2048, 1024  # 2M generated points per frame


def sphere(u, v):
    theta = u * 2 * math.pi
    phi = (v - 0.5) * math.pi
    r = 10.0
    return (
        r * torch.cos(phi) * torch.cos(theta),
        r * torch.cos(phi) * torch.sin(theta),
        r * torch.sin(phi),
    )


def wave(u, v):
    x = (u - 0.5) * 40
    y = (v - 0.5) * 40
    z = 3.0 * torch.sin(0.5 * x) * torch.cos(0.5 * y)
    return x, y, z


SURFACES = {"sphere": sphere, "wave": wave}


def uv_grid(device):
    """The (u, v) grid flattened u-major, f32, (N_U * N_V,) each."""
    u = (torch.arange(N_U, device=device) + 0.5) / N_U
    v = (torch.arange(N_V, device=device) + 0.5) / N_V
    uu, vv = torch.meshgrid(u.float(), v.float(), indexing="ij")
    return uu.reshape(-1), vv.reshape(-1)


def surface_points(surface: str, device):
    """-> (fx, fy, fz) f32 and the UV colour (int32 u32 bits) per point."""
    uu, vv = uv_grid(device)
    fx, fy, fz = SURFACES[surface](uu, vv)
    r = (uu * 255).to(torch.int32)
    g = (vv * 255).to(torch.int32)
    b = ((fz - fz.min()) / (fz.max() - fz.min() + 1e-9) * 255).to(torch.int32)
    return fx, fy, fz, r | (g << 8) | (b << 16)


def render_points(fx, fy, fz, rgba, transform, width: int, height: int,
                  plain: bool = False):
    """Project and resolve coloured points -> (fb_d, fb_p), (W*H,) int32
    bits each.  `plain=True` resolves with B6's plain version."""
    pid, depth = project_points(fx, fy, fz, transform, width, height)
    return sorted_resolve_u64_min(pid, depth, rgba, width * height, True, plain)


def render_parametric(transform, surface: str, width: int, height: int,
                      plain: bool = False):
    """One frame of `surface` under the (4, 4) f32 world-view-projection
    `transform` (on the frame's device) -> (fb_d, fb_p)."""
    return render_points(*surface_points(surface, transform.device), transform,
                         width, height, plain)


class Parametric(Method):
    def __init__(self, renderer, surface: str = "sphere"):
        self.name = "parametric"
        self.description = f"procedural {surface} point surface"
        self.group = "none"
        self.surface = surface
        self.renderer = renderer

    def update(self, renderer):
        pass

    def transform(self, renderer):
        """The frame's (4, 4) f32 world-view-projection on the device."""
        wvp = renderer.camera.view_proj().astype(np.float32)
        return torch.from_numpy(wvp).to(renderer.device)

    def render(self, renderer):
        W, H = renderer.width, renderer.height
        fb_d, fb_p = render_parametric(self.transform(renderer), self.surface, W, H)
        renderer.last_fb = (fb_d, fb_p)
        return resolve(fb_p, W, H)
