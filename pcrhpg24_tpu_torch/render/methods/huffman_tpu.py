"""`huffman_tpu` — the flagship colour frame on `.tpc` scenes.

Counterpart of `pcrhpg24_tpu/render/methods/huffman_tpu.py`: per frame,
device frustum cull + LOD, then for each live 64-batch chunk the
geometry decode — fbatch (v2, B1) or tbatch (v1, B5) — and the fused
projection + colour payload + run collapse (B2: BC1, or on v2 BC7 or raw
colours, decoded in the kernel where the reference leaves those two to
XLA, `huffman_tpu.py:67-68,155-161`), then the exact u64-min resolve
(B3) over every chunk's stream in one launch, the unswizzle of the
payload half and the background fill.  B3 writes the depth half too; it
is unswizzled only when the frame asks for it (`need_depth`: the
renderer's `capture_depth` or EDL).

There is no sort: the reference's per-chunk `lax.sort` and its
matscatter merge exist only because the TPU has no atomics
(`pallas_merge.py:1-25`); B3's `atomicMin` gives the same planes in any
order.  The debug modes: `colorize_chunks` and `show_num_points` run B2
in batch-payload mode (the batch index, the clamped LOD count) with its
run collapse, which keeps each run's exact (depth, payload) minimum, so
B3's planes are the reference's uncollapsed ones; `colorize_overdraw`
runs B2 without collapse and counts every entry per pixel
(`raster.overdraw_counts`) in place of B3.  Bounding boxes are drawn
over the image for the loaded batches only (`HuffmanMemIter.draw_boxes`;
the reference draws the zero rows of the rest too, ROADMAP C6).
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import POINTS_PER_THREAD
from ...engine import timing
from ...engine.debug import Debug
from ..camera import batch_translations, frame_setup_device
from ..decode_fixed import decode_fixed_batches, decode_fixed_plain
from ..decode_tbatch import decode_native_batches, decode_native_plain
from ..project import project_batches, project_plain
from ..raster import (
    EMPTY,
    frame_image,
    overdraw_counts,
    overdraw_image,
    resolve,
    swizzle_dims,
    u64_min_planes,
    u64_min_planes_plain,
    unswizzle_plane,
)
from .huffman_mem_iter import CHUNK, HuffmanMemIter, batch_payload, debug_mode


def frame_streams(dev, frame_params, tb, scale, width: int, height: int,
                  nchunks: int, cull: bool, points: int = POINTS_PER_THREAD,
                  fmt: str = "fixed", plain: bool = False,
                  collapse: bool = True, mode: str = "color", color_fmt: str = "bc1"):
    """Every live chunk's (pid, dep, pay) stream -> (parts, size, device).

    frame_params (40,) f32: view(16) | proj_params(6) | lod_floor | B |
    wvp(16); tb (B_pad, 4) f32 per-batch folded translations; scale
    (3,) f32.  `points` is the static LOD bucket: every chain decodes
    only that prefix.  `fmt` is "fixed" (v2, B1) or "tbatch" (v1, B5);
    `color_fmt` the format of `dev["colors_k"]` ("bc1", "bc7", "raw").
    `collapse=False` (HQS) keeps every entry.  In `mode`
    "colorize_chunks" or "show_num_points" the payload is each batch's
    index or clamped LOD count (B2's batch-payload mode).  `plain=True` runs every
    stage's plain torch version on whatever device the tensors are on
    (the gate the kernels are held to); otherwise the stages dispatch on
    the tensors' device.  While tracing: spans `tpc.live_wait` (the
    live-chunk read) and `tpc.chunk` (each live chunk's decode and
    projection), and the counter `tpc.live_chunks`.
    """
    if fmt == "fixed":
        keys = ("widths", "streams", "ptrs", "starts")
        decode = decode_fixed_plain if plain else decode_fixed_batches
    elif fmt == "tbatch":
        keys = ("lj", "streams", "ptrs", "dD", "lut", "starts")
        decode = decode_native_plain if plain else decode_native_batches
    else:
        raise ValueError(f"unknown fmt {fmt!r}")
    project = project_plain if plain else project_batches
    view = frame_params[0:16].reshape(4, 4)
    proj_params = frame_params[16:22]
    lod_n = frame_setup_device(
        view, proj_params, dev["bbox_min"], dev["bbox_max"],
        frame_params[23].to(torch.int32), width, height, frame_params[22], cull,
    )
    # the bucket comes from the host f64 LOD; the device f32 LOD could
    # exceed it by one at a bucket boundary, so clamp (huffman_tpu.py:227)
    lod_n = torch.clamp(lod_n, max=points)
    t = frame_params[24:40].reshape(4, 4)
    frame12 = torch.cat([t[0, :3], t[1, :3], t[3, :3], scale[:3]])
    size = swizzle_dims(width, height)[2]

    # live-chunk skip: a chunk with no visible batch launches nothing.
    # The host reads which chunks are live (one small device->host copy).
    live = (lod_n[: nchunks * CHUNK].reshape(nchunks, CHUNK) > 0).any(dim=1)
    with timing.span("tpc.live_wait"):
        chunks = torch.nonzero(live).flatten().tolist()
    timing.count("tpc.live_chunks", len(chunks))
    parts = []
    for c in chunks:
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        with timing.span("tpc.chunk"):
            coords = decode(*(dev[k][sl] for k in keys), points=points)
            parts.append(project(coords, dev["colors_k"][sl], dev["anchor"][sl],
                                 tb[sl], lod_n[sl], frame12, width, height,
                                 points=points, collapse=collapse,
                                 payload=batch_payload(mode, sl, lod_n),
                                 color_fmt=color_fmt))
    return parts, size, lod_n.device


def render_frame_native(dev, frame_params, tb, scale, width: int, height: int,
                        nchunks: int, cull: bool,
                        points: int = POINTS_PER_THREAD, fmt: str = "fixed",
                        mode: str = "color", need_depth: bool = False,
                        plain: bool = False, color_fmt: str = "bc1"):
    """One frame -> (fb_depth or None, fb_payload, image): the planes
    (H*W,) int32 u32 bits in linear pixel order, the image (H, W) int32.

    Arguments as `frame_streams`; `mode` is "color", "colorize_chunks",
    "show_num_points" or "colorize_overdraw" (then fb_payload holds the
    per-pixel entry counts and fb_depth is None, `huffman_tpu.py:
    296-309`); fb_depth is None unless `need_depth`.
    """
    if mode == "colorize_overdraw":
        parts, size, device = frame_streams(dev, frame_params, tb, scale, width,
                                            height, nchunks, cull, points, fmt,
                                            plain, collapse=False, color_fmt=color_fmt)
        counts = unswizzle_plane(overdraw_counts(parts, size, device), width, height)
        return None, counts, overdraw_image(counts, width, height)
    parts, size, device = frame_streams(dev, frame_params, tb, scale, width,
                                        height, nchunks, cull, points, fmt,
                                        plain, mode=mode, color_fmt=color_fmt)
    if parts:
        fb_d, fb_p = (u64_min_planes_plain if plain else u64_min_planes)(parts, size)
    else:
        fb_d = fb_p = torch.full((size,), EMPTY, dtype=torch.int32, device=device)
    fb_p = unswizzle_plane(fb_p, width, height)
    fb_d = unswizzle_plane(fb_d, width, height) if need_depth else None
    return fb_d, fb_p, frame_image(fb_p, mode, width, height)


class HuffmanTpu(HuffmanMemIter):
    """Flagship native-format method ((B1 or B5) -> B2 -> B3)."""

    def __init__(self, renderer, tpc):
        self.name = "huffman_tpu"
        self.description = "fbatch decode + fused projection + u64 atomicMin"
        self.group = "huffman"
        self.las = tpc
        self.renderer = renderer
        self._scale = None

    def frame_args(self, renderer) -> dict:
        """Keyword arguments of `render_frame_native` for this frame.

        One host -> device copy: the 40 frame params and the (B, 4)
        per-batch translations (computed on the host in f64, the
        reference's close-up precision path) ride one packed array.  A
        span `tpc.frame_args` while tracing.
        """
        with timing.span("tpc.frame_args"):
            las = self.las
            cam = renderer.camera
            fp = np.zeros(40, np.float32)
            fp[0:16] = cam.view().astype(np.float32).reshape(-1)
            fp[16:22] = cam.proj_params().astype(np.float32)
            fp[22] = Debug.lod
            fp[23] = float(las.num_batches_loaded)
            fp[24:40] = (cam.proj() @ cam.view()).astype(np.float32).reshape(-1)
            # LOD bucket: decode only ceil(max_lod/16)*16 points per chain
            _, lod_full = self.frame_setup(renderer)
            points = max(16, -(-int(lod_full.max()) // 16) * 16)
            tb = batch_translations(
                cam.proj() @ cam.view(), las.anchor_i[: las.dev["anchor"].shape[0]],
                las.scale, las.offset, las.las_min,
            )
            packed = torch.from_numpy(
                np.concatenate([fp, np.asarray(tb, np.float32).ravel()])
            ).to(las.device)
            if self._scale is None:
                self._scale = torch.tensor(np.asarray(las.scale, np.float32),
                                           device=las.device)
            return dict(
                dev=las.dev, frame_params=packed[:40], tb=packed[40:].reshape(-1, 4),
                scale=self._scale, width=renderer.width, height=renderer.height,
                nchunks=-(-las.num_batches // CHUNK),
                cull=Debug.frustum_culling_enabled and Debug.update_frustum,
                points=points, fmt="fixed" if las.version == 2 else "tbatch",
                color_fmt=las.color_fmt,
            )

    def frame_mode(self, renderer) -> dict:
        """The rest of `render_frame_native`'s arguments: the frame mode
        the `Debug` flags ask for, and whether the depth plane is needed
        (`huffman_tpu.py:397`: captured, or read by EDL)."""
        return dict(mode=debug_mode(), need_depth=bool(renderer.capture_depth or Debug.edl))

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        if las.num_batches_loaded == 0:
            W, H = renderer.width, renderer.height
            empty = torch.full((W * H,), EMPTY, dtype=torch.int32, device=las.device)
            return resolve(empty, W, H)
        fb_d, fb_p, img = render_frame_native(**self.frame_args(renderer),
                                              **self.frame_mode(renderer))
        renderer.last_fb = (fb_d, fb_p)
        if Debug.show_bounding_box:
            img = self.draw_boxes(renderer, img)
        return img
