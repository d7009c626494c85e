"""`loop_nodes_compressed` — per-node variable-bit-width packed coords.

Counterpart of `pcrhpg24_tpu/render/methods/loop_nodes_compressed.py`
(after the source's modules/compute_loop_compress_nodewise): octree
nodes carry bit-packed node-relative fixed-point coordinates whose width
depends on the node's extent, in the `.wg` file written by
`tools/potree_to_wg.py`.  Each frame unpacks every point (a two-word
window read per axis), dequantises it into its node box, projects it in
linear pixel ids with the point index as payload, resolves the exact
u64 min through one sort by pid and kernel B6
(`raster.sorted_resolve_u64_min`) and looks the colours up by index.
The unpack, dequantisation and projection are torch ops, as they are
XLA ops in the reference, in its op order; u32 shifts run in int64 and
are masked back to 32 bits (`u32.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import device_of
from ...engine.method import Method
from ...engine.resource import Resource, ResourceState
from ...tools.potree_to_wg import read_wg
from ...u32 import MASK32, from_u32, widen
from ..raster import BACKGROUND, project_points, sorted_resolve_u64_min
from .loop_las import resolve_indexed


class WgData(Resource):
    """Whole-file `.wg` resource: the packed words, the colours and the
    per-point expansion tables (node bit width, first bit, node box),
    about 36 B per point, on one device."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = device_of(device)
        records, words, colors = read_wg(path)
        self.records = records
        self.num_points = int(sum(r[0] for r in records))
        self.num_points_loaded = 0
        self.words_np = words
        self.colors_np = colors
        self.dev = {}

    @classmethod
    def create(cls, path: str, device="cuda"):
        return cls(path, device)

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        recs = self.records
        node_bits = np.concatenate([np.full(r[0], r[1], np.int32) for r in recs])
        base_bit = np.concatenate([
            np.int64(r[2]) * 32 + np.arange(r[0], dtype=np.int64) * 3 * r[1]
            for r in recs])
        bmin = np.concatenate([np.broadcast_to(r[4], (r[0], 3)) for r in recs])
        bmax = np.concatenate([np.broadcast_to(r[5], (r[0], 3)) for r in recs])
        tables = dict(
            words=from_u32(self.words_np), colors=from_u32(self.colors_np),
            bits=torch.from_numpy(node_bits), base_bit=torch.from_numpy(base_bit),
            bmin=torch.from_numpy(bmin.astype(np.float32)),
            bmax=torch.from_numpy(bmax.astype(np.float32)))
        self.dev = {k: v.to(self.device) for k, v in tables.items()}
        self.num_points_loaded = self.num_points
        self.state = ResourceState.LOADED

    def process(self, renderer=None):
        pass

    def unload(self, renderer=None):
        self.dev = {}
        self.num_points_loaded = 0
        self.state = ResourceState.UNLOADED

    def wait_loaded(self, renderer=None):
        self.load(renderer)
        return self


def unpack_axis(words, bits, base_bit, axis: int):
    """Each point's `bits`-wide code of one axis (`:98-107`), as int64:
    the u32 word at the code's first bit shifted up by its offset, ORed
    with the next word shifted down; word reads clamp to the buffer."""
    last = words.shape[0] - 1
    pos = base_bit + axis * bits.to(torch.int64)
    w0 = pos // 32
    off = pos % 32
    a = widen(words[torch.clamp(w0, 0, last)])
    b = widen(words[torch.clamp(w0 + 1, 0, last)])
    hi = (a << off) & MASK32
    lo = b >> torch.clamp(32 - off, max=31)
    window = hi | torch.where(off > 0, lo, torch.zeros_like(lo))
    return window >> (32 - bits.to(torch.int64))


def wg_points(words, bits, base_bit, bmin, bmax):
    """Unpack and dequantise every point -> (fx, fy, fz) f32 (`:109-115`)."""
    span = torch.clamp((bmax - bmin).amax(dim=1), min=1e-12)
    steps = (torch.ones_like(bits) << bits).to(torch.float32)
    return tuple(
        unpack_axis(words, bits, base_bit, axis).to(torch.float32) / steps * span
        + bmin[:, axis]
        for axis in range(3))


def render_wg(words, colors, bits, base_bit, bmin, bmax, transform,
              width: int, height: int, plain: bool = False):
    """One frame (`_render_wg`, `:92-133`) -> (fb_d, fb_p), (W*H,) int32
    bits each; the payload is the point index.  `colors` is unused here
    (the resolve looks it up).  `plain=True` resolves with B6's plain
    version."""
    del colors
    fx, fy, fz = wg_points(words, bits, base_bit, bmin, bmax)
    pid, depth = project_points(fx, fy, fz, transform, width, height)
    payload = torch.arange(bits.shape[0], dtype=torch.int32, device=bits.device)
    return sorted_resolve_u64_min(pid, depth, payload, width * height, True, plain)


class ComputeLoopNodesCompressed(Method):
    def __init__(self, renderer, wg):
        self.name = "loop_nodes_compressed"
        self.description = "nodewise variable-bit-width packed coords (wg)"
        self.group = "potree"
        self.wg = wg
        self.renderer = renderer

    def update(self, renderer):
        self.wg.load(renderer)

    def transform(self, renderer):
        """The frame's (4, 4) f32 world-view-projection on the device."""
        wvp = renderer.camera.view_proj().astype(np.float32)
        return torch.from_numpy(wvp).to(self.wg.device)

    def render(self, renderer):
        d = self.wg.dev
        W, H = renderer.width, renderer.height
        if not d:
            return torch.full((H, W), BACKGROUND, dtype=torch.int32,
                              device=self.wg.device)
        fb_d, fb_p = render_wg(**d, transform=self.transform(renderer),
                               width=W, height=H)
        renderer.last_fb = (fb_d, fb_p)
        return resolve_indexed(fb_p, d["colors"], W, H)
