"""`loop_las` family — adaptive 10/20/30-bit fixed-point methods.

Counterpart of `pcrhpg24_tpu/render/methods/loop_las.py`, after the
source system's modules/compute_loop_las (+las2) and
compute_loop_las_hqs: per batch, a precision level is chosen on the host
from the projected box size (render.cs:235-271: level 0 keeps 30 bits,
level 1 20, levels 2-4 10), coordinates unpack from up to three
10-10-10 planes batch-relative, and points rasterize with the point
*index* as payload (render.cs:527-533); the resolve looks colours up by
index (`resolve_indexed`, which the `.wg` method shares).

The reference resolves each 256-batch chunk by a 3-key sort and a head
scatter merged into the running planes; here every chunk's (pid, depth,
index) part of a frame goes to B3 (`raster.u64_min_planes`) in one
launch, in linear pixel ids, which gives the same u64 (depth << 32 |
index) minimum.  The padding repeats a batch's last point under new
indices, so the index breaks depth ties as the sort does.  The HQS
frame resolves the same parts with B3 as its depth prepass, then B4
(`hqs.hqs_sums`) over them with the colour as the payload: B4's accept
test `w <= old * 1.01f` and byte sums are the reference's
`hqs_chunk_101010`.

The reference uploads per-point level, visibility and box planes each
frame (`np.repeat` over the padded scene); here the per-batch arrays
go up in one packed copy and each batch's 65,536 points read them,
which gives the same numbers.  A frame projects the loaded batches only:
the reference masks every entry past them (visibility False).  On the
card the 10-10-10 unpack and projection of a frame are one kernel
(`LAS_PROJECT`, `csrc/las_project.cu`) that reads only the planes each
batch's level needs; on the CPU, and for the plain frame, they are
`project_101010`: int32 and f32 torch ops in the reference's operation
order, unfused, one call a 256-batch chunk.

The reference's 30-bit unpack has a copy-paste defect (render.cs:
456-458 ORs X_12 into Y and Z); both implement the evident intent.
`loop_las2`'s uvec4 double-buffered prefetch (compute_loop_las2/
render.cs:300-446) is a memory-coalescing variant with identical
numerics, registered as an alias.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import POINTS_PER_WORKGROUP, RENDER_CHUNK_BATCHES
from ...engine import timing
from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ...kernels.build import I, P, Kernel, check_cuda
from ...u32 import widen
from ..camera import batches_in_frustum, frustum_planes
from ..hqs import hqs_sums, hqs_sums_plain, resolve_hqs
from ..raster import (
    BACKGROUND,
    EMPTY,
    project_points,
    resolve,
    u64_min_planes,
    u64_min_planes_plain,
)

CHUNK_PTS = RENDER_CHUNK_BATCHES * POINTS_PER_WORKGROUP
STEPS_30BIT = float(1 << 30)
STEPS_10BIT = 1024.0
MASK = 1023
# 10-10-10 planes a batch's points read, by precision level: 30, 20, 10 bits
PLANES = np.array([3, 2, 1, 1, 1])
PLANE_KEYS = ("xyz4", "xyz8", "xyz12")
# (xyz4, xyz8, xyz12, level, vis, bmin, bmax, transform, pid, dep, idx,
# batches, width, height)
LAS_PROJECT = Kernel("pcr_las_project", [P] * 11 + [I, I, I])


def precision_levels(view, proj, bbox_min, bbox_max, width, height):
    """Per-batch level 0..4 (render.cs:235-271), host f64."""
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


def resolve_indexed(fb_p, rgba, width: int, height: int):
    """Colour lookup by winning point index (compute_loop_las/resolve.cs).

    fb_p (H*W,) int32 u32 bits, rgba (N,) int32 -> (H, W) int32 image.
    The index clamps as an unsigned value (EMPTY, -1 in int32 bits, is
    2**32 - 1 and clamps to N - 1, as in the reference); EMPTY pixels
    take the background.
    """
    color = rgba[torch.clamp(widen(fb_p), max=rgba.shape[0] - 1)]
    img = torch.where(fb_p != EMPTY, color, torch.full_like(color, BACKGROUND))
    return img.reshape(height, width)


def point_index(base_index: int, shape, device):
    """Each point's global index (int32, the payload) over `shape`."""
    n = int(np.prod(shape))
    return torch.arange(base_index, base_index + n, dtype=torch.int32,
                        device=device).reshape(shape)


def mask_pid(pid, keep, size: int):
    """`pid` where `keep`, else `size` (dropped)."""
    return torch.where(keep, pid, torch.full_like(pid, size))


def project_101010(xyz4, xyz8, xyz12, level, bmin, bmax, transform, base_index: int,
                   width: int, height: int, mask, index=None):
    """(pid, depth, index) of packed points (`loop_las.py:225-279`): the
    plain version, torch ops on any device.

    xyz4/8/12: int32 planes of one shape, here (nb, 65536) for nb
    batches; level (int32), mask (bool) and each axis of the 3-tuples
    bmin, bmax (f32) broadcast against them (per batch: (nb, 1)).  Level
    0 joins all three planes (30 bits), level 1 the first two (20),
    higher levels the first only and divide its top 10 bits by 1024;
    then `Xs * (box / denom) + bmin`, and `raster.project_points`' f32
    projection.  All int32: a plane field is 10 bits, X/Y/Z 30.  The
    payload is each point's global index: `base_index` onwards, or the
    int32 `index` tensor of the points' own indices (a gathered frame).
    It is what `loop_las_parts` runs on the CPU and for the plain frame,
    what `LAS_PROJECT` is held to on the card, and the Potree frames'
    projection (`project_101010_nodes`) everywhere."""

    def unpack(plane, shift):
        return tuple(((plane >> s) & MASK) << shift for s in (0, 10, 20))

    x4, y4, z4 = unpack(xyz4, 20)
    x8, y8, z8 = unpack(xyz8, 10)
    x12, y12, z12 = unpack(xyz12, 0)
    lvl = level
    lo = lvl >= 2
    denom = torch.where(lo, STEPS_10BIT, STEPS_30BIT).to(torch.float32)
    pos = []
    for a4, a8, a12, mn, mx in ((x4, x8, x12, bmin[0], bmax[0]), (y4, y8, y12, bmin[1], bmax[1]),
                                (z4, z8, z12, bmin[2], bmax[2])):
        a = torch.where(lvl == 0, a4 | a8 | a12, torch.where(lvl == 1, a4 | a8, a4))
        s = torch.where(lo, a >> 20, a).to(torch.float32)
        pos.append(s * ((mx - mn) / denom) + mn)
    pid, dep = project_points(*pos, transform, width, height)
    pid = mask_pid(pid, mask, width * height)
    if index is None:
        index = point_index(base_index, pid.shape, pid.device)
    return pid, dep, index


def project_101010_nodes(xyz4, xyz8, xyz12, nid, nodes, transform, base_index: int,
                         width: int, height: int, index=None):
    """(pid, depth, index) of a Potree chunk's packed points, each against
    its node (`raster_chunk_101010_nodes`, `loop_las.py:185-222`).

    xyz4/8/12 and nid (each point's node) are (n,) int32; `nodes` holds
    the per-node device tables: `code` (take << 4 | level << 1 | vis,
    int32), `bmin`, `bmax` ((N, 3) f32, relative to las_min) and `start`
    (the node's first point, int32).  A point renders only among its
    node's first `take` (the prefix budget, `loop_las.py:208-212`); its
    index is `base_index` onwards, or `index` (the compact frame's
    gathered points)."""
    if index is None:
        index = point_index(base_index, nid.shape, nid.device)
    code = nodes["code"][nid]
    vis = ((code & 1) == 1) & ((index - nodes["start"][nid]) < (code >> 4))
    bmin, bmax = nodes["bmin"][nid], nodes["bmax"][nid]
    return project_101010(xyz4, xyz8, xyz12, (code >> 1) & 7,
                          tuple(bmin[:, k] for k in range(3)),
                          tuple(bmax[:, k] for k in range(3)), transform, base_index,
                          width, height, vis, index)


def colour_parts(parts, rgba):
    """Each (pid, depth, index) part of a frame with its points' colours
    as the payload (B4's input): part k holds the points from
    k * CHUNK_PTS."""
    return [(pid, dep, rgba[k * CHUNK_PTS:k * CHUNK_PTS + pid.numel()].view(pid.shape))
            for k, (pid, dep, _idx) in enumerate(parts)]


def resolve_parts(parts, rgba, width: int, height: int, hqs: bool = False,
                  plain: bool = False):
    """A frame's (pid, depth, index) parts, linear pids, part k holding
    the points from k * CHUNK_PTS -> (fb_depth, fb_payload, image), or
    in HQS (fb_depth, acc_n, image).

    The u64-min planes come from B3 in one launch; the colour image is
    `resolve_indexed` of the payload plane over the whole `rgba` buffer.
    HQS hands B4 the same parts with each point's colour as the payload
    and the depth plane as its prepass, then divides (`resolve_hqs`).
    The parts are one entry a point in file order: both kernels take
    them in their flat layout.  `plain=True` runs the plain versions
    instead of B3 and B4.  A span `las.resolve` while tracing."""
    with timing.span("las.resolve"):
        size = width * height
        if not parts:
            empty = torch.full((size,), EMPTY, dtype=torch.int32, device=rgba.device)
            if hqs:
                return (empty, torch.zeros_like(empty),
                        torch.full((height, width), BACKGROUND, dtype=torch.int32,
                                   device=rgba.device))
            return empty, empty, resolve(empty, width, height)
        fb_d, fb_p = (u64_min_planes_plain(parts, size) if plain
                      else u64_min_planes(parts, size, layout="flat"))
        if not hqs:
            return fb_d, fb_p, resolve_indexed(fb_p, rgba, width, height)
        fb_d = fb_d.contiguous()  # B4 reads a contiguous plane
        cparts = colour_parts(parts, rgba)
        acc = (hqs_sums_plain(cparts, fb_d, size) if plain
               else hqs_sums(cparts, fb_d, size, layout="flat"))
        return fb_d, acc[3], resolve_hqs(*acc, width, height)


def loop_las_parts(dev, level, vis, bmin, bmax, transform, batches: int, width: int,
                   height: int, plain: bool = False):
    """The (pid, depth, index) part of each 256-batch chunk of the first
    `batches` batches (`raster_chunk_101010`, `loop_las.py:63-74`), each
    (nb, 65536) int32.

    dev: `ComputeLasData.dev`; level (B,) int32, vis (B,) int32 (0: the
    batch is culled), bmin and bmax (B, 3) f32: per loaded batch;
    transform (4, 4) f32 wvp.  CUDA tensors launch `LAS_PROJECT` once for
    the frame, and the parts are views of its three outputs; CPU tensors,
    or `plain=True`, take `project_101010` a chunk.  On the card a culled
    batch's depth words are 0, which B3 and B4 never read (its pids are
    width*height).  The projection is a span `las.project` while
    tracing."""
    P = POINTS_PER_WORKGROUP
    nb = CHUNK_PTS // P
    with timing.span("las.project"):
        if plain or not dev["xyz4"].is_cuda:
            parts = []
            for b0 in range(0, batches, nb):
                b1 = min(b0 + nb, batches)
                planes = [dev[k][b0 * P:b1 * P].view(b1 - b0, P) for k in PLANE_KEYS]
                per_axis = lambda box: tuple(box[b0:b1, k:k + 1] for k in range(3))
                parts.append(project_101010(*planes, level[b0:b1, None], per_axis(bmin),
                                            per_axis(bmax), transform, b0 * P, width,
                                            height, vis[b0:b1, None] != 0))
            return parts
        out = las_project(dev, level, vis, bmin, bmax, transform, batches, width, height)
    return chunk_parts(out, batches)


def chunk_parts(entries, batches: int):
    """A frame's (pid, depth, index), each (batches, 65536), as the views
    of its 256-batch chunks: the parts `loop_las_parts` returns."""
    nb = CHUNK_PTS // POINTS_PER_WORKGROUP
    return [tuple(t[b0:b0 + nb] for t in entries) for b0 in range(0, batches, nb)]


def las_project(dev, level, vis, bmin, bmax, transform, batches: int, width: int,
                height: int):
    """`LAS_PROJECT` over the first `batches` batches -> (pid, depth,
    index), each (batches, 65536) int32: `loop_las_parts`' arguments, on
    the card."""
    P = POINTS_PER_WORKGROUP
    planes = [dev[k] for k in PLANE_KEYS]
    for k, t in zip(PLANE_KEYS, planes):
        check_cuda(k, t, torch.int32)
        if t.numel() < batches * P or t.data_ptr() % 16:
            raise ValueError(f"{k}: expected 16-byte aligned planes of at least "
                             f"{batches * P} points")
    B = level.shape[0]
    if not 0 <= batches <= B or batches * P >= 2**31:
        raise ValueError(f"batches {batches}: expected 0..{B} and under 2**31 points")
    check_cuda("level", level, torch.int32, (B,))
    check_cuda("vis", vis, torch.int32, (B,))
    check_cuda("bmin", bmin, torch.float32, (B, 3))
    check_cuda("bmax", bmax, torch.float32, (B, 3))
    check_cuda("transform", transform, torch.float32, (4, 4))
    out = [torch.empty((batches, P), dtype=torch.int32, device=level.device)
           for _ in range(3)]
    if batches:
        LAS_PROJECT.launch(*(t.data_ptr() for t in (*planes, level, vis, bmin, bmax,
                                                    transform, *out)),
                           batches, width, height)
    return tuple(out)


def loop_las_frame(dev, level, vis, bmin, bmax, transform, batches: int, width: int,
                   height: int, hqs: bool = False, plain: bool = False):
    """One frame -> (fb_depth, fb_payload or acc_n, image), the planes
    (H*W,) int32 u32 bits, linear: `loop_las_parts` resolved by
    `resolve_parts`; `hqs` blends (`hqs_chunk_101010`,
    `ComputeLoopLasHqs.render`); `plain=True` builds it from the plain
    versions alone."""
    parts = loop_las_parts(dev, level, vis, bmin, bmax, transform, batches, width, height,
                           plain)
    return resolve_parts(parts, dev["rgba"], width, height, hqs, plain)


class LasMethod(Method):
    """Resource switching and the frame of the `.las` methods: each
    names its frame function (`FRAME`) and builds its arguments
    (`frame_args`)."""

    HQS = False
    FRAME = None

    def __init__(self, renderer, las, name: str):
        self.name = name
        self.las = las
        self.renderer = renderer

    def update(self, renderer):
        if Runtime.resource is not self.las:
            if Runtime.resource is not None:
                Runtime.resource.unload(renderer)
            self.las.load(renderer)
            Runtime.resource = self.las

    def frame(self, renderer, plain: bool = False):
        """-> (fb_depth, fb_payload or acc_n, image) of this frame;
        `plain=True` builds it from the plain versions alone."""
        return type(self).FRAME(**self.frame_args(renderer), plain=plain)

    def render(self, renderer):
        self.las.process(renderer)
        fb_d, fb_p, img = self.frame(renderer)
        renderer.last_fb = (fb_d, fb_p)
        return img

    def wvp(self, renderer) -> np.ndarray:
        cam = renderer.camera
        return (cam.proj() @ cam.view()).astype(np.float32)


class ComputeLoopLas(LasMethod):
    FRAME = staticmethod(loop_las_frame)

    def __init__(self, renderer, las, name="loop_las"):
        super().__init__(renderer, las, name)
        self.description = "10-10-10 adaptive precision (2022 paper path)"
        self.group = "10-10-10 bit"

    def frame_args(self, renderer) -> dict:
        """Keyword arguments of `loop_las_frame`: the host's cull and
        precision levels of the loaded batches, their boxes and the wvp
        in one packed host -> device copy.  While tracing: a span
        `las.frame_args`, and counters `las.batches` (the batches the
        frame projects) and `las.planes_needed` (the 10-10-10 planes the
        visible batches' levels read)."""
        with timing.span("las.frame_args"):
            las = self.las
            W, H = renderer.width, renderer.height
            cam = renderer.camera
            view, proj = cam.view(), cam.proj()
            B = las.num_batches_loaded
            bmin, bmax = las.bbox_min[:B], las.bbox_max[:B]
            if Debug.frustum_culling_enabled and Debug.update_frustum:
                vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax)
            else:
                vis = np.ones(B, bool)
            level = precision_levels(view, proj, bmin, bmax, W, H)
            if timing.tracing():
                timing.count("las.batches", B)
                timing.count("las.planes_needed", int(PLANES[level[vis]].sum()))
            packed = torch.from_numpy(np.concatenate([
                (proj @ view).astype(np.float32).ravel(), bmin.ravel(), bmax.ravel(),
                level.astype(np.int32).view(np.float32),
                vis.astype(np.int32).view(np.float32)])).to(las.device)
            return dict(
                dev=las.dev, transform=packed[:16].reshape(4, 4),
                bmin=packed[16:16 + 3 * B].reshape(B, 3),
                bmax=packed[16 + 3 * B:16 + 6 * B].reshape(B, 3),
                level=packed[16 + 6 * B:16 + 7 * B].view(torch.int32),
                vis=packed[16 + 7 * B:].view(torch.int32),
                batches=B, width=W, height=H, hqs=self.HQS)


class ComputeLoopLas2(ComputeLoopLas):
    """Alias of loop_las (see the module docstring on why)."""

    def __init__(self, renderer, las):
        super().__init__(renderer, las, name="loop_las2")
        self.description = "10-10-10 adaptive precision (las2 alias)"


class ComputeLoopLasHqs(ComputeLoopLas):
    """HQS over the 10-10-10 format (modules/compute_loop_las_hqs)."""

    HQS = True

    def __init__(self, renderer, las):
        super().__init__(renderer, las, name="loop_las_hqs")
        self.description = "10-10-10 adaptive precision, HQS average blend"
