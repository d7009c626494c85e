"""Multi-file LAS/LAZ ingestion — the LasLoaderSparse equivalent.

Counterpart of `pcrhpg24_tpu/engine/las_sparse.py`.  The source
system's LasLoaderSparse (modules/compute/LasLoaderSparse.cpp) accepts
several LAS/LAZ files, loads them in parallel through laszip, and
appends them into sparse buffers reserved up front.  Here: one flat
device SoA sized for the concatenated scene, in `ComputeLasDataBasic`'s
layout (int32 x, y, z and the colour's u32 bits), allocated at `load`;
a background loader thread that walks the files in 4-batch chunks (LAZ
decoding included, `formats/laz.py`) into a bounded queue, re-quantizing
a file on another grid to the first file's; and per-frame `process()`
uploads in whole batches, carrying a partial batch over to the next
chunk or file, with the final partial batch padded by repeating its
last point.  Renders through `basic`.
"""

from __future__ import annotations

import glob as _glob
import threading
import time
from queue import Empty, Queue

import numpy as np
import torch

from .. import device_of
from ..constants import POINTS_PER_WORKGROUP, RENDER_CHUNK_BATCHES
from ..formats.las import read_header, read_points
from .resource import Resource, ResourceState, upload_rows

CHUNK_POINTS = 4 * POINTS_PER_WORKGROUP


def expand_scene_paths(pattern: str) -> list[str]:
    """'a.las,b.laz' or a glob like 'dir/*.las' -> ordered file list."""
    paths: list[str] = []
    for part in pattern.split(","):
        part = part.strip()
        hits = sorted(_glob.glob(part))
        paths.extend(hits if hits else [part])
    return paths


class LasSparseData(Resource):
    """Concatenated multi-LAS/LAZ scene in ComputeLasDataBasic's layout.

    World positions use each file's own scale and offset; a file on
    another grid is re-quantized to the first file's, so the batch math
    stays int32-exact, and raises if its points leave int32 there."""

    def __init__(self, paths: list[str] | str, device):
        self.device = device_of(device)
        if isinstance(paths, str):
            paths = expand_scene_paths(paths)
        if not paths:
            raise ValueError("no input files")
        self.paths = paths
        self.headers = [read_header(p) for p in paths]
        h0 = self.headers[0]
        self.scale = h0.scale
        self.offset = h0.offset
        self.las_min = np.min([h.cmin for h in self.headers], axis=0)
        self.num_points = int(sum(h.num_points for h in self.headers))
        self.num_batches = (self.num_points + POINTS_PER_WORKGROUP - 1) // POINTS_PER_WORKGROUP
        self.num_points_loaded = 0
        self.num_batches_loaded = 0
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        self.dev: dict[str, torch.Tensor] = {}
        self._queue: Queue = Queue(maxsize=4)
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()
        self._tail: dict | None = None

    @classmethod
    def create(cls, paths, device) -> "LasSparseData":
        return cls(paths, device)

    # -- loading -----------------------------------------------------------

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        n_pad = (-(-self.num_batches // RENDER_CHUNK_BATCHES) * RENDER_CHUNK_BATCHES
                 * POINTS_PER_WORKGROUP)
        self.dev = {k: torch.zeros(n_pad, dtype=torch.int32, device=self.device)
                    for k in ("x", "y", "z", "rgba")}
        self._queue = Queue(maxsize=4)  # nothing of an earlier load carries over
        self._abort.clear()
        self._thread = threading.Thread(target=self._loader_main, daemon=True)
        self._thread.start()

    def _loader_main(self):
        """Walk the files in chunks, re-quantizing to the scene grid."""
        try:
            for path, h in zip(self.paths, self.headers):
                same_grid = (np.allclose(h.scale, self.scale)
                             and np.allclose(h.offset, self.offset))
                for start in range(0, h.num_points, CHUNK_POINTS):
                    if self._abort.is_set():
                        return
                    count = min(CHUNK_POINTS, h.num_points - start)
                    pts = read_points(path, start, count)
                    if same_grid:
                        x, y, z = pts.x, pts.y, pts.z
                    else:
                        world = (np.stack([pts.x, pts.y, pts.z], 1).astype(np.float64)
                                 * h.scale + h.offset)
                        grid = np.rint((world - self.offset) / self.scale).astype(np.int64)
                        # a file whose extent lands outside +/-2^31 of the
                        # scene grid would silently wrap in the i32 cast
                        if grid.size and np.abs(grid).max() >= 2**31:
                            raise ValueError(f"{path}: points exceed the scene grid's "
                                             "int32 range after re-quantization")
                        x, y, z = (grid[:, k].astype(np.int32) for k in range(3))
                    self._queue.put((x, y, z, pts.color))
            self._queue.put(None)  # done marker
        except Exception as e:  # surfaced on the render thread by process()
            self._queue.put(("error", e))

    def unload(self, renderer=None):
        self.state = ResourceState.UNLOADING
        self._abort.set()
        if self._thread is not None:
            # drain, so that a put() blocked on the full queue returns and
            # the thread sees the abort
            while self._thread.is_alive():
                try:
                    self._queue.get(timeout=0.01)
                except Empty:
                    pass
            self._thread = None
        self.dev = {}
        self.num_points_loaded = 0
        self.num_batches_loaded = 0
        self._tail = None
        self.state = ResourceState.UNLOADED

    def process(self, renderer=None, max_tasks: int = 4):
        if self.state in (ResourceState.LOADED, ResourceState.UNLOADED):
            return
        for _ in range(max_tasks):
            try:
                item = self._queue.get_nowait()
            except Empty:
                return
            if item is None:
                self._flush_tail()
                self.state = ResourceState.LOADED
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "error":
                raise item[1]
            x, y, z, c = item
            if self._tail is not None:
                t = self._tail
                x, y, z, c = (np.concatenate([t[k], a]) for k, a in zip("xyzc", (x, y, z, c)))
                self._tail = None
            keep = (len(x) // POINTS_PER_WORKGROUP) * POINTS_PER_WORKGROUP
            if keep < len(x):
                self._tail = dict(x=x[keep:], y=y[keep:], z=z[keep:], c=c[keep:])
                x, y, z, c = x[:keep], y[:keep], z[:keep], c[:keep]
            if len(x):
                self._append(x, y, z, c)

    def _flush_tail(self):
        if self._tail is None:
            return
        t = self._tail
        self._tail = None
        pad = (-len(t["x"])) % POINTS_PER_WORKGROUP
        rep = lambda a: np.concatenate([a, np.full(pad, a[-1], a.dtype)])
        self._append(*(rep(t[k]) for k in "xyzc"))

    def _append(self, x, y, z, c):
        start = self.num_points_loaded
        rel = (np.stack([x, y, z], 1).astype(np.float64) * self.scale
               + self.offset - self.las_min)
        nb = len(x) // POINTS_PER_WORKGROUP
        wb = rel.reshape(nb, POINTS_PER_WORKGROUP, 3)
        b0 = start // POINTS_PER_WORKGROUP
        self.bbox_min[b0:b0 + nb] = wb.min(axis=1)
        self.bbox_max[b0:b0 + nb] = wb.max(axis=1)
        d = self.dev
        for key, a in (("x", x), ("y", y), ("z", z)):
            upload_rows(d[key], start, np.asarray(a, np.int32))
        upload_rows(d["rgba"], start, np.asarray(c, np.uint32).view(np.int32))
        self.num_points_loaded = start + len(x)
        self.num_batches_loaded = self.num_points_loaded // POINTS_PER_WORKGROUP

    def wait_loaded(self, renderer=None):
        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer, max_tasks=1_000_000)
            time.sleep(0.005)
        return self
