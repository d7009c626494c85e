"""Host half of `pcrhpg24_tpu/render/methods/huffman_mem_iter.py`.

`HuffmanMemIter.update` and `frame_setup` (huffman_mem_iter.py:135-190)
are host NumPy code over the camera's host half; the flagship method
inherits them.  The `.huffman` XLA method itself is
ROADMAP A11.
"""

from __future__ import annotations

import numpy as np

from ...constants import POINTS_PER_THREAD, RENDER_CHUNK_BATCHES
from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ..camera import batches_in_frustum, frustum_planes, lod_points_per_thread

CHUNK = RENDER_CHUNK_BATCHES  # lod_full padding, as the reference's


class HuffmanMemIterHost(Method):
    """Resource switching and the host per-frame cull + LOD."""

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
        b_pad = -(-las.num_batches // CHUNK) * CHUNK
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
