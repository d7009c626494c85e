"""`loop_nodes` — Potree octree LOD rendering.

Counterpart of `pcrhpg24_tpu/render/methods/loop_nodes.py`, after the
source system's modules/compute_loop_nodes: one unit of work per octree
node instead of per fixed batch, frustum culling plus the LOD cut (a
node whose projected box is under 80 px is skipped: its parents'
subsampled points already cover those pixels; compute_loop_nodes/
render.cs:211-226, 292-296), then the 10-10-10 node-relative unpack
and the depth-test raster.  `loop_nodes_hqs` adds the average-blend
second pass (modules/compute_loop_nodes_hqs).

The host does the reference's per-node work in f64 (`node_levels`,
`node_budget`, the live chunks) and sends each frame's per-node codes
(take << 4 | level << 1 | vis) up with the wvp in one copy.  On the
device the resource's node-id plane (4 B a point) indexes the node
tables, as the reference's CPU path does
(`raster_chunk_101010_nodes`, `loop_las.py:185-222`); each live
16.7M-point chunk of the loaded points becomes one (pid, depth, index)
part (`loop_las.project_101010_nodes`), and B3 (`raster.u64_min_planes`)
resolves the parts, a group of them at a time into one running plane,
in linear pixel ids; `resolve_indexed` colours the winners.  With
`Debug.node_budget > 0` the frame is the reference's compact frame
(`:831-848`): only each visible node's first `take` points are gathered
on the device, with their global indices as the payload, so the planes
equal the masked frame's, and the work follows what is visible, not
what is resident.  HQS hands B4 (`hqs.hqs_sums`) the same kind of parts
with the colours as the payload and the colour frame's depth plane,
and `resolve_hqs` divides.

The reference's TPU frames rebuild per-point attributes from per-node
XOR deltas and prefix scans, and sort rows for its merge kernel,
because TPU gathers are slow; the card gathers at memory speed, so none
of that machinery is here.  Its compact frame copies 4096-point
segments, and copies a segment twice where two visible nodes share it
(ROADMAP C1), which double-counts points in its compact HQS; the
gather here takes each point once.
"""

from __future__ import annotations

import numpy as np
import torch

from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ...u32 import key_views
from ..camera import batches_in_frustum, frustum_planes
from ..hqs import hqs_sums, hqs_sums_plain, resolve_hqs
from ..raster import (
    BACKGROUND,
    EMPTY,
    key_plane,
    resolve,
    u64_min_planes,
    u64_min_planes_plain,
)
from .loop_las import project_101010_nodes, resolve_indexed

CHUNK_PTS = 1 << 24  # 16.7M points per part
GROUP_PTS = 1 << 27  # entries resolved into the running planes per B3 / B4 call
COMPACT_SEG = 4096
COMPACT_CAP = 1 << 25  # the reference's compact buffer (points): the takes' cover fits it

# budget value meaning "render every point" (no thinning); fits the
# code's take field (27 usable bits) and exceeds any node's count
TAKE_ALL = 1 << 26


def _node_screen_px(view, proj, bmin, bmax, width, height):
    """Projected screen size (px) per node — the same center+radius
    construction as the reference LOD heuristic (render.cu:350-367)."""
    center = 0.5 * (bmin + bmax)
    radius = np.linalg.norm(bmin - bmax, axis=1)
    ch = np.concatenate([center, np.ones((len(center), 1))], 1)
    vc = ch @ view.T
    ve = vc + np.stack([radius, *([np.zeros_like(radius)] * 3)], 1)
    pc = vc @ proj.T
    pe = ve @ proj.T
    sc = 0.5 * (pc[:, :2] / pc[:, 3:4] + 1) * [width, height]
    se = 0.5 * (pe[:, :2] / pe[:, 3:4] + 1) * [width, height]
    return np.linalg.norm(se - sc, axis=1)


def node_levels(view, proj, bmin, bmax, width, height):
    """Precision level per node; >= 4 culls it (render.cs:205-226)."""
    ps = _node_screen_px(view, proj, bmin, bmax, width, height)
    level = np.zeros(len(ps), np.int32)
    level[ps < 10000] = 1
    level[ps < 500] = 2
    level[ps < 200] = 3
    level[ps < 80] = 4
    return level


def node_budget(view, proj, bmin, bmax, counts, width, height,
                density: float = 3.0, min_take: int = 256):
    """Per-node point budget: the first `take` of the node's points
    render (a prefix), take chosen so the node's candidate count tracks
    ~density points per covered screen pixel (the nodes-path analogue of
    the flagship's per-batch LOD%, huffman_mem_iter_cuda/render.cu:
    346-379).  The projected box diagonal ps gives a footprint of ~ps^2 / 2
    pixels, clipped to the framebuffer."""
    ps = _node_screen_px(view, proj, bmin, bmax, width, height)
    area = np.minimum(ps * ps * 0.5, float(width * height))
    take = np.ceil(density * area).astype(np.int64)
    return np.clip(take, min_take, np.maximum(counts, 1)).astype(np.int32)


def _grouped(parts):
    """Lists of consecutive parts of about GROUP_PTS entries."""
    group, n = [], 0
    for part in parts:
        group.append(part)
        n += part[0].numel()
        if n >= GROUP_PTS:
            yield group
            group, n = [], 0
    if group:
        yield group


def node_parts(dev, nid, nodes, transform, n_loaded: int, chunks, gather,
               width: int, height: int):
    """The frame's (pid, depth, index) parts, one at a time.

    dev: `PotreeData.dev`; nid: the node-id plane; nodes: the device node
    tables with the frame's `code` (`loop_las.project_101010_nodes`).
    Without `gather`, each live chunk of the loaded points (`chunks`,
    indices of CHUNK_PTS-point chunks).  With `gather` = (nodes, takes,
    their sum): int32 device tensors and an int, the compact frame: each
    listed node's first `take` points, gathered, CHUNK_PTS a part, with
    their global indices as the payload."""
    planes = [dev[k] for k in ("xyz4", "xyz8", "xyz12")]
    if gather is None:
        for c in chunks:
            s = int(c) * CHUNK_PTS
            sl = slice(s, min(s + CHUNK_PTS, n_loaded))
            yield project_101010_nodes(*(x[sl] for x in planes), nid[sl], nodes, transform,
                                       s, width, height)
        return
    vi, take, total = gather
    if total == 0:
        return
    seq = torch.arange(len(vi), dtype=torch.int32, device=vi.device)
    node_of = torch.repeat_interleave(seq, take, output_size=total)
    first = torch.cumsum(take, 0, dtype=torch.int32) - take
    local = torch.arange(total, dtype=torch.int32, device=vi.device) - first[node_of]
    node = vi[node_of]
    index = nodes["start"][node] + local
    for s in range(0, total, CHUNK_PTS):
        idx = index[s:s + CHUNK_PTS]
        yield project_101010_nodes(*(x[idx] for x in planes), node[s:s + CHUNK_PTS], nodes,
                                   transform, 0, width, height, index=idx)


def resolve_node_parts(parts, size: int, device, plain: bool = False):
    """B3 over an iterable of parts, a group at a time into one running
    plane -> (fb_depth, fb_payload, the parts if they made one group,
    else None).  The parts are one entry a point in node order: B3 takes
    them in its flat layout.  `plain=True` runs its plain version."""
    plane = key_plane(size, device)
    kept, groups = None, 0
    for group in _grouped(parts):
        if plain:
            u64_min_planes_plain(group, size, plane)
        else:
            u64_min_planes(group, size, plane, layout="flat")
        groups += 1
        kept = group if groups == 1 else None
    return (*key_views(plane), kept)


def hqs_node_sums(parts, rgba, fb_depth, size: int, plain: bool = False):
    """B4 over an iterable of (pid, depth, index) parts, each point's
    colour as the payload, a group at a time into one accumulator ->
    the (r, g, b, n) planes; B4 in its flat layout, as B3 in
    `resolve_node_parts`."""
    acc = torch.zeros((size, 4), dtype=torch.int32, device=fb_depth.device)
    for group in _grouped(parts):
        cparts = [(pid, dep, rgba[idx]) for pid, dep, idx in group]
        if plain:
            hqs_sums_plain(cparts, fb_depth, size, acc)
        else:
            hqs_sums(cparts, fb_depth, size, acc, layout="flat")
    return tuple(acc[:, k] for k in range(4))


class ComputeLoopNodes(Method):
    def __init__(self, renderer, potree, name="loop_nodes"):
        self.name = name
        self.description = "Potree octree nodes, 10-10-10 node-relative"
        self.group = "potree"
        self.potree = potree
        self.renderer = renderer

    def update(self, renderer):
        if Runtime.resource is not self.potree:
            if Runtime.resource is not None:
                Runtime.resource.unload(renderer)
            self.potree.load(renderer)
            Runtime.resource = self.potree

    def _frame_codes(self, level, vis, cap, take=None):
        """(take<<4 | level<<1 | vis) per node, padded to the node
        capacity.  take (node_budget) is the per-node prefix point
        budget; default TAKE_ALL = render everything."""
        code = (level.astype(np.int32) << 1) | vis.astype(np.int32)
        tv = np.full(len(code), TAKE_ALL, np.int32) if take is None else (
            np.minimum(take.astype(np.int64), TAKE_ALL).astype(np.int32))
        code = code | (tv << 4)
        full = np.zeros(cap + 1, np.int32)
        full[: len(code)] = code
        return full

    def _live_chunks(self, starts, counts, vis, n_pad):
        """Chunk indices containing at least one visible node's points
        (host, O(nodes)): skipped chunks hold no visible point, so the
        image is the same (compute_loop_nodes.h:150-186 dispatches work
        only for accepted nodes)."""
        nchunks = (n_pad + CHUNK_PTS - 1) // CHUNK_PTS
        live = np.zeros(nchunks, bool)
        vis_idx = np.flatnonzero(vis)
        if len(vis_idx):
            c0 = starts[vis_idx] // CHUNK_PTS
            c1 = (starts[vis_idx] + counts[vis_idx] - 1) // CHUNK_PTS
            for a, b in zip(c0, c1):
                live[a : b + 1] = True
        return np.flatnonzero(live)

    def _compact_takes(self, vis, take):
        """The compact frame's nodes and takes (`_compact_frame_tables`,
        `loop_nodes.py:684-711`): every visible node with a take, its take
        capped at its count; if the cover of COMPACT_SEG-aligned segments
        of the takes exceeds COMPACT_CAP (the reference's compact buffer),
        every take shrinks by 9/10 until it fits.  -> (node indices,
        takes), int64, empty when nothing is visible."""
        p = self.potree
        nn = p.nodes_loaded
        n_pad = int(p.dev["xyz4"].shape[0])
        SEG = COMPACT_SEG
        cap_pts = min(COMPACT_CAP, n_pad)
        chunk_pts = min(CHUNK_PTS, cap_pts)
        ncap = max(1, -(-cap_pts // chunk_pts))
        cap_pts = ncap * chunk_pts if cap_pts % chunk_pts else cap_pts
        cap_segs = cap_pts // SEG
        counts = p.node_count[:nn].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        t_all = np.minimum(take[:nn].astype(np.int64), counts)
        vi = np.flatnonzero(vis[:nn] & (t_all > 0))
        if len(vi) == 0:
            return vi, t_all[vi]
        s_n = starts[vi]
        t_n = t_all[vi]
        for _ in range(64):
            a0 = s_n // SEG
            a1 = (s_n + t_n - 1) // SEG
            tot = int((a1 - a0 + 1).sum())
            if tot <= cap_segs:
                break
            t_n = np.maximum(1, t_n * 9 // 10)
        else:
            raise RuntimeError("compact cover does not fit the buffer")
        return vi, t_n

    def frame_tables(self, renderer, cull: bool, compact: bool = True) -> dict:
        """The host's per-frame work, in f64 over the loaded nodes: the
        cull (`cull`: the frustum test), the LOD cut, the budget when
        `Debug.node_budget > 0`, the codes, and the live chunks or (the
        budgeted frame, unless `compact=False`) the compact frame's nodes
        and takes.  A budgeted frame's codes carry the compact takes, so
        that its masked chunks (`compact=False`) hold the points that the
        compact frame gathers, also where the reference's cover shrinks
        them; `asked` is the points the budget asked for."""
        p = self.potree
        W, H = renderer.width, renderer.height
        cam = renderer.camera
        view, proj = cam.view(), cam.proj()
        nn = p.nodes_loaded
        bmin, bmax = p.bbox_min[:nn], p.bbox_max[:nn]
        vis = (batches_in_frustum(frustum_planes(proj @ view), bmin, bmax) if cull
               else np.ones(nn, bool))
        level = node_levels(view, proj, bmin, bmax, W, H)
        vis &= level < 4  # the LOD cut
        counts = p.node_count[:nn]
        take, gather, asked = None, None, None
        if Debug.node_budget > 0:
            take = node_budget(view, proj, bmin, bmax, counts, W, H, density=Debug.node_budget)
            asked = int(np.minimum(take, counts)[vis].sum())
            gather = self._compact_takes(vis, take)
            take[gather[0]] = gather[1]
        t = dict(wvp=(proj @ view).astype(np.float32),
                 code=self._frame_codes(level, vis, len(p.nodes), take), chunks=None,
                 gather=gather if compact else None, asked=asked)
        if t["gather"] is None:
            t["chunks"] = self._live_chunks(p.node_offset[:nn], counts, vis,
                                            p.dev["xyz4"].shape[0])
        return t

    def frame_args(self, renderer, tables: dict) -> dict:
        """Keyword arguments of `node_parts`: the frame's tables in one
        packed host -> device copy, and the resource's buffers."""
        p = self.potree
        gather = tables["gather"]
        host = [tables["wvp"].ravel(), tables["code"].view(np.float32)]
        if gather is not None:
            host += [a.astype(np.int32).view(np.float32) for a in gather]
        packed = torch.from_numpy(np.concatenate(host)).to(p.device)
        nc = len(tables["code"])
        if gather is not None:
            k = len(gather[0])
            gather = (*(packed[16 + nc + i * k:16 + nc + (i + 1) * k].view(torch.int32)
                        for i in range(2)), int(gather[1].sum()))
        return dict(dev=p.dev, nid=p.node_ids,
                    nodes=dict(p.node_dev, code=packed[16:16 + nc].view(torch.int32)),
                    transform=packed[:16].reshape(4, 4), n_loaded=p.num_points_loaded,
                    chunks=tables["chunks"], gather=gather, width=renderer.width,
                    height=renderer.height)

    def colour_frame(self, renderer, plain: bool = False, compact: bool = True):
        """One colour frame of the loaded points -> (fb_depth, fb_payload,
        image, the frame's tables, its parts if they made one group);
        `plain=True` resolves with B3's plain version, `compact=False`
        renders a budgeted frame as the reference's masked chunks."""
        t = self.frame_tables(renderer, Debug.frustum_culling_enabled and Debug.update_frustum,
                              compact)
        W, H = renderer.width, renderer.height
        fb_d, fb_p, kept = resolve_node_parts(
            node_parts(**self.frame_args(renderer, t)), W * H, self.potree.device, plain)
        return fb_d, fb_p, resolve_indexed(fb_p, self.potree.dev["rgba"], W, H), t, kept

    def frame(self, renderer, plain: bool = False, compact: bool = True):
        """-> (fb_depth, fb_payload, image) of this frame, the planes
        (H*W,) int32 u32 bits in linear pixel order."""
        return self.colour_frame(renderer, plain, compact)[:3]

    def render(self, renderer):
        p = self.potree
        p.process(renderer)
        W, H = renderer.width, renderer.height
        if p.num_points_loaded == 0:
            return resolve(torch.full((W * H,), EMPTY, dtype=torch.int32, device=p.device), W, H)
        fb_d, fb_p, img = self.frame(renderer)
        renderer.last_fb = (fb_d, fb_p)
        return img


def _same_tables(a: dict, b: dict) -> bool:
    """Whether two frames' tables select the same points: the same codes,
    and the same live chunks or compact nodes and takes."""
    flat = lambda t: [t["code"], t["chunks"] is None,
                      *(t["gather"] if t["chunks"] is None else (t["chunks"],))]
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb))


class ComputeLoopNodesHqs(ComputeLoopNodes):
    """HQS over Potree nodes (modules/compute_loop_nodes_hqs)."""

    def __init__(self, renderer, potree):
        super().__init__(renderer, potree, name="loop_nodes_hqs")
        self.description = "Potree octree nodes, HQS average blend"

    def frame(self, renderer, plain: bool = False, compact: bool = True):
        """-> (fb_depth, acc_n, image): the colour frame's depth plane as
        the prepass, then B4 over the parts of the nodes this pass keeps,
        which are always culled to the frustum (`loop_nodes.py:917`)."""
        fb_d, _fb_p, _img, ct, kept = self.colour_frame(renderer, plain, compact)
        t = self.frame_tables(renderer, True, compact)
        W, H = renderer.width, renderer.height
        parts = (kept if kept is not None and _same_tables(ct, t)
                 else node_parts(**self.frame_args(renderer, t)))
        acc = hqs_node_sums(parts, self.potree.dev["rgba"], fb_d.contiguous(), W * H, plain)
        return fb_d, acc[3], resolve_hqs(*acc, W, H)

    def render(self, renderer):
        p = self.potree
        p.process(renderer)
        W, H = renderer.width, renderer.height
        if p.num_points_loaded == 0:
            return torch.full((H, W), BACKGROUND, dtype=torch.int32, device=p.device)
        p.process(renderer)  # the colour pass's own (`loop_nodes.py:799`)
        fb_d, acc_n, img = self.frame(renderer)
        renderer.last_fb = (fb_d, acc_n)
        return img
