"""Seeded terrain cloud, made on the device in a few large calls.

The formula of `utils/synthetic.terrain_cloud` (bench.py's scene): points
uniform over an `extent_m` rectangle, a height of two large-scale waves
(three along x, two along y), a ripple and 0.4 m of noise, 100 m up, and
colours banded by height; then the LAS grid of `scale` (1 mm).  Drawn
from a `torch.Generator` seeded with the run's seed, so one seed gives
one scene.  The points are then stored in the Morton order of their
grid coordinates (the reference preprocessor's order,
`reference/morton.py`), so that each run of 65,536 stored points covers
a small patch of ground, as in a sorted survey, not the whole scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.morton import morton_order


class Points:
    """A scene's points on the host: int32 grid coordinates (n, 3), colours
    R | G<<8 | B<<16 (n,) u32, the LAS grid's scale and offset, and the
    world box as a LAS header states it (`cmin`, `cmax`)."""

    def __init__(self, grid: np.ndarray, color: np.ndarray, scale, offset):
        self.grid = grid
        self.color = color
        self.scale = np.asarray(scale, np.float64)
        self.offset = np.asarray(offset, np.float64)
        world = [grid[:, k].astype(np.float64) * self.scale[k] + self.offset[k]
                 for k in range(3)]
        self.cmin = np.array([w.min() for w in world])
        self.cmax = np.array([w.max() for w in world])

    @property
    def n(self) -> int:
        return len(self.color)

    @property
    def rgb(self) -> np.ndarray:
        """(n, 3) u8 channels."""
        c = self.color
        return np.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], 1).astype(np.uint8)


def make(config: dict, seed: int, device) -> Points:
    n = config["batches"] * config["points_per_batch"]
    ex, ey = (float(e) for e in config["extent_m"])
    g = torch.Generator(device=device)
    g.manual_seed(seed & (2**63 - 1))
    f64 = dict(dtype=torch.float64, device=device)
    xy = torch.rand((n, 2), generator=g, **f64) * torch.tensor([ex, ey], **f64)
    noise = torch.randn((n,), generator=g, **f64) * 0.4
    x, y = xy[:, 0], xy[:, 1]
    fx = torch.sin(x * (2 * math.pi / ex) * 3.0)
    fy = torch.cos(y * (2 * math.pi / ey) * 2.0)
    h = 40.0 * fx * fy + 15.0 * torch.sin(x * 0.05) + noise
    t = torch.clamp((h - h.min()) / (h.max() - h.min() + 1e-9), 0, 1)
    rgb = torch.stack([50 + 200 * t, 80 + 120 * (1 - t), 60 + 40 * torch.sin(t * 9)], 1)
    rgb = rgb.to(torch.uint8).to(torch.int64)
    color = (rgb[:, 0] | (rgb[:, 1] << 8) | (rgb[:, 2] << 16)).to(torch.int32)
    scale = torch.tensor(config["scale"], **f64)
    offset = torch.tensor(config["offset"], **f64)
    xyz = torch.stack([x, y, h + 100.0], 1)
    grid = torch.round((xyz - offset) / scale).to(torch.int32)
    del xy, noise, x, y, fx, fy, h, t, rgb, xyz
    order = morton_order(*grid.unbind(1))
    grid, color = grid[order], color[order]
    return Points(grid.cpu().numpy(), color.cpu().numpy().view(np.uint32),
                  config["scale"], config["offset"])
