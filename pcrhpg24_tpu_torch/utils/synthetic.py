"""Synthetic point-cloud scene generation for tests and benchmarks.

A copy of `pcrhpg24_tpu/utils/synthetic.py`."""

from __future__ import annotations

import numpy as np


def terrain_cloud(n: int, seed: int = 0, extent: float = 1000.0):
    """Height-field-like cloud: world meters; returns (xyz f64 (n,3), rgb u8 (n,3)).

    Rough stand-in for an aerial lidar tile (the reference's morrobay /
    neuchatel scenes): smooth large-scale height + noise + colored bands.
    """
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2)) * extent
    fx = np.sin(xy[:, 0] * (2 * np.pi / extent) * 3.0)
    fy = np.cos(xy[:, 1] * (2 * np.pi / extent) * 2.0)
    h = 40.0 * fx * fy + 15.0 * np.sin(xy[:, 0] * 0.05) + rng.normal(0, 0.4, n)
    xyz = np.column_stack([xy[:, 0], xy[:, 1], h + 100.0])

    t = np.clip((h - h.min()) / (np.ptp(h) + 1e-9), 0, 1)
    rgb = np.column_stack(
        [50 + 200 * t, 80 + 120 * (1 - t), 60 + 40 * np.sin(t * 9)]
    ).astype(np.uint8)
    return xyz, rgb


def cloud_to_grid(xyz: np.ndarray, scale=(0.001, 0.001, 0.001), offset=(0.0, 0.0, 0.0)):
    """World f64 -> int32 LAS grid coords."""
    scale = np.asarray(scale)
    offset = np.asarray(offset)
    g = np.round((xyz - offset) / scale).astype(np.int64)
    assert np.abs(g).max() < 2**31
    return g.astype(np.int32)
