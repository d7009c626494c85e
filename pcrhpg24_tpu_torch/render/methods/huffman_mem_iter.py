"""`huffman_mem_iter` — the colour frame on `.huffman` scenes.

Counterpart of `pcrhpg24_tpu/render/methods/huffman_mem_iter.py`, the
source system's flagship method (modules/huffman_mem_iter_cuda/): per
frame, every loaded batch is frustum-culled and given a screen-size LOD
point count on the host (f64), then each live 64-batch chunk is
Huffman-decoded (B12), projected with the BC1 payload and its runs
collapsed (B2), and every chunk's stream is resolved by the exact u64
(depth << 32 | payload) min (B3) in one launch.

The reference projects `(coords - anchor) * scale` with per-batch
translations folded on the host in f64 (`camera.batch_translations`)
in B2's operation order (`((t0 x + t1 y) + t2 z) + tb`, then
`inv = 1 / w`, `ndc = c * inv`), so B2 serves as it is; the anchor is
the component-wise minimum of the batch's chain starts
(`HuffmanLasData`).  The reference resolves each 256-batch chunk by a
sort and a head scatter, which gives the same planes as B3's min in any
order and any chunking.  A chunk with no batch in view launches nothing;
which chunks are live is read from the host's LOD counts.  The debug
modes `colorize_chunks` and `show_num_points` run B2 in batch-payload
mode (the batch index, the LOD count); `colorize_overdraw` renders
colour, as the reference's `huffman_mem_iter` has no overdraw frame.
Bounding boxes are drawn over the image (`overlay.py`) and EDL is the
renderer's.

`HuffmanMemIter`'s resource switching and host cull + LOD are inherited
by the `.tpc` method `huffman_tpu`, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import POINTS_PER_THREAD, RENDER_CHUNK_BATCHES
from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ..camera import batch_translations, batches_in_frustum, frustum_planes, lod_points_per_thread
from ..decode_huffman import decode_ref_batches, decode_ref_plain
from ..overlay import draw_bounding_boxes
from ..project import project_batches, project_plain
from ..raster import (
    EMPTY,
    frame_image,
    resolve,
    swizzle_dims,
    u64_min_planes,
    u64_min_planes_plain,
    unswizzle_plane,
)

CHUNK = 64  # batches per decode + project pass (4.2M points)
LOD_PAD = RENDER_CHUNK_BATCHES  # lod_full padding, as the reference's
REF_KEYS = ("enc_offsets", "cluster_sizes", "sep_offsets", "separate_sizes",
            "table_values", "table_cw_len", "start_values")


def debug_mode(overdraw: bool = True) -> str:
    """The frame mode the `Debug` flags ask for (`huffman_tpu.py:
    381-386`): "colorize_chunks", "show_num_points", "colorize_overdraw"
    (only where the method has that frame) or "color"."""
    if Debug.colorize_chunks:
        return "colorize_chunks"
    if Debug.show_num_points:
        return "show_num_points"
    if overdraw and Debug.colorize_overdraw:
        return "colorize_overdraw"
    return "color"


def batch_payload(mode: str, sl: slice, lod):
    """B2's per-batch payload for the batches `sl` in a debug `mode`:
    their batch indices or LOD counts (`lod`, int32); None (the BC1
    colour) in colour mode."""
    if mode == "colorize_chunks":
        return torch.arange(sl.start, sl.stop, dtype=torch.int32, device=lod.device)
    if mode == "show_num_points":
        return lod[sl]
    return None


def decode_chunk(dev, sl: slice, points: int, plain: bool = False):
    """B12 (or its plain version) on the batches `sl` of a `.huffman`
    resource's buffers -> (C, points, 3, 8, 128) i32 coords."""
    rows = {k: dev[k][sl] for k in REF_KEYS}
    decode = decode_ref_plain if plain else decode_ref_batches
    return decode(dev["encoding"], rows["enc_offsets"], rows["cluster_sizes"],
                  dev["separate"], rows["sep_offsets"], rows["separate_sizes"],
                  rows["table_values"], rows["table_cw_len"], rows["start_values"],
                  points=points)


def live_chunks(lod_full: np.ndarray, batches: int) -> list[slice]:
    """The batches of each 64-batch chunk of the first `batches` that has
    a batch in view (a slice each)."""
    chunks = [slice(c, min(c + CHUNK, batches)) for c in range(0, batches, CHUNK)]
    return [sl for sl in chunks if lod_full[sl].any()]


def mem_iter_frame(dev, lod, tb, frame12, width: int, height: int, chunks,
                   points: int = POINTS_PER_THREAD, mode: str = "color",
                   plain: bool = False):
    """One frame -> (fb_depth, fb_payload, image).

    dev: `HuffmanLasData.dev`; lod (B_pad,) i32 host LOD counts (0 ==
    culled); tb (B_pad, 4) f32 per-batch folded translations; frame12
    (12,) f32 (wvp rows 0/1/3 by columns 0..2, then scale xyz); chunks:
    the live chunks' batch slices; `points` the static LOD bucket;
    `mode` "color", "colorize_chunks" or "show_num_points".  The planes
    are (H*W,) int32 u32 bits in linear pixel order, the image (H, W)
    int32.  `plain=True` runs every stage's plain torch version.
    """
    project = project_plain if plain else project_batches
    size = swizzle_dims(width, height)[2]
    parts = []
    for sl in chunks:
        coords = decode_chunk(dev, sl, points, plain)
        parts.append(project(coords, dev["colors_k"][sl], dev["anchor"][sl], tb[sl],
                             lod[sl], frame12, width, height, points=points,
                             payload=batch_payload(mode, sl, lod)))
    if parts:
        fb_d, fb_p = (u64_min_planes_plain if plain else u64_min_planes)(parts, size)
    else:
        fb_d = fb_p = torch.full((size,), EMPTY, dtype=torch.int32,
                                 device=dev["anchor"].device)
    fb_d, fb_p = (unswizzle_plane(x, width, height) for x in (fb_d, fb_p))
    return fb_d, fb_p, frame_image(fb_p, mode, width, height)


class HuffmanMemIter(Method):
    """The `.huffman` colour frame: B12 -> B2 -> B3."""

    def __init__(self, renderer, las):
        self.name = "huffman_mem_iter"
        self.description = "Huffman decode + fused projection + u64 atomicMin"
        self.group = "huffman"
        self.las = las
        self.renderer = renderer

    def update(self, renderer):
        if Runtime.resource is not self.las:
            if Runtime.resource is not None:
                Runtime.resource.unload(renderer)
            self.las.load(renderer)
            Runtime.resource = self.las

    def frame_setup(self, renderer):
        """-> (wvp f32 (4,4), lod_full (b_pad,) i32), host f64 math."""
        las = self.las
        W, H = renderer.width, renderer.height
        cam = renderer.camera
        view = cam.view()
        proj = cam.proj()
        wvp = (proj @ view).astype(np.float32)
        B = las.num_batches_loaded

        # resource bboxes are stored in the render frame (world - las_min)
        bmin = las.bbox_min[:B]
        bmax = las.bbox_max[:B]
        if Debug.frustum_culling_enabled and Debug.update_frustum:
            vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax)
        else:
            vis = np.ones(B, bool)
        n_pts, use_double = lod_points_per_thread(
            view, proj, bmin, bmax, W, H, POINTS_PER_THREAD, Debug.lod
        )
        b_pad = -(-las.num_batches // LOD_PAD) * LOD_PAD
        lod_full = np.zeros(b_pad, np.int32)
        lod_full[:B] = np.where(vis, n_pts, 0).astype(np.int32)
        Debug.clear_frame_stats()
        Debug.push_frame_stat("#batches loaded", str(B))
        Debug.push_frame_stat("#batches visible", str(int(vis.sum())))
        Debug.push_frame_stat(
            "#points budget", f"{int(lod_full.astype(np.int64).sum() * 1024):,}"
        )
        # every batch projects batch-relative with an f64-folded
        # translation, so this count is reporting-only
        Debug.push_frame_stat(
            "#batches close-up (f64-class precision)", str(int(use_double.sum()))
        )
        return wvp, lod_full

    def frame_args(self, renderer) -> dict:
        """Keyword arguments of `mem_iter_frame` for this frame.

        One host -> device copy: frame12, the per-batch translations
        (computed on the host in f64) and the LOD counts (their int32
        bits) ride one packed f32 array.
        """
        las = self.las
        cam = renderer.camera
        wvp, lod_full = self.frame_setup(renderer)
        rows = las.dev["anchor"].shape[0]
        tb = batch_translations(cam.proj() @ cam.view(), las.anchor_i[:rows],
                                las.scale, las.offset, las.las_min)
        frame12 = np.concatenate([wvp[0, :3], wvp[1, :3], wvp[3, :3],
                                  np.asarray(las.scale, np.float32)])
        lod = lod_full[:rows]
        packed = torch.from_numpy(np.concatenate([
            frame12.astype(np.float32), np.asarray(tb, np.float32).ravel(),
            lod.view(np.float32)])).to(las.device)
        B = las.num_batches_loaded
        return dict(
            dev=las.dev, lod=packed[12 + 4 * rows:].view(torch.int32),
            tb=packed[12:12 + 4 * rows].reshape(rows, 4), frame12=packed[:12],
            width=renderer.width, height=renderer.height,
            chunks=live_chunks(lod_full, B),
            points=max(16, -(-int(lod_full[:B].max()) // 16) * 16),
        )

    def frame_mode(self, renderer) -> dict:
        """`mem_iter_frame`'s mode from the `Debug` flags (overdraw renders
        colour: the reference's `huffman_mem_iter.py:203-208`)."""
        return dict(mode=debug_mode(overdraw=False))

    def draw_boxes(self, renderer, img):
        """The loaded batches' boxes over `img` (`huffman_mem_iter.py:
        242-247`), through the frame's f32 world-view-projection; the
        rows past `num_batches_loaded` are never drawn (ROADMAP C6)."""
        las = self.las
        B = las.num_batches_loaded
        wvp = (renderer.camera.proj() @ renderer.camera.view()).astype(np.float32)
        packed = torch.from_numpy(np.concatenate([  # one host -> device copy
            wvp.reshape(-1), las.bbox_min[:B].reshape(-1), las.bbox_max[:B].reshape(-1)]))
        packed = packed.to(las.device)
        return draw_bounding_boxes(img, packed[16:16 + 3 * B].reshape(B, 3),
                                   packed[16 + 3 * B:].reshape(B, 3),
                                   packed[:16].reshape(4, 4), renderer.width, renderer.height)

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        if las.num_batches_loaded == 0:
            empty = torch.full((W * H,), EMPTY, dtype=torch.int32, device=las.device)
            renderer.last_fb = (empty, empty)
            return resolve(empty, W, H)
        fb_d, fb_p, img = mem_iter_frame(**self.frame_args(renderer),
                                         **self.frame_mode(renderer))
        renderer.last_fb = (fb_d, fb_p)
        if Debug.show_bounding_box:
            img = self.draw_boxes(renderer, img)
        return img
