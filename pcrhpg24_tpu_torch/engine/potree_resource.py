"""Potree octree scene resource with coarse-first bin streaming.

Counterpart of `pcrhpg24_tpu/engine/potree_resource.py`, after the
source system's PotreeData runtime (modules/compute/PotreeData.h:
288-311, 380-549): nodes are packed greedily into ~1M-point bins, the
bins ordered coarse level first; a loader thread reads a bin's nodes
through `formats/potree.read_node_points` into a bounded queue; each
`process()` uploads one bin and packs its points on the device into
node-relative 10-10-10 planes (`las_resources.pack_101010`,
PotreeData.h:469-513), in place in buffers preallocated for every
resident point, and keeps each point's node in a node-id plane
(`node_ids`, int32, written with the bin: the reference's method
builds it at each upload, `loop_nodes.py:506-537`).  u32 planes are
int32 tensors holding the same bits.

The reference pads each upload to a multiple of 2**20 points so that
its jitted packing compiles a handful of shapes (`UPLOAD_QUANTUM`); the
padding only writes words past `num_points_loaded`, which no frame
reads, so the port uploads the bin as it is.  The per-node tables
(`node_dev`: box relative to las_min in f32, first point) go to the
device once, at `load`, and serve both the packing and the frames.
"""

from __future__ import annotations

import threading
import time
from queue import Empty, Queue

import numpy as np
import torch

from .. import device_of
from ..formats.potree import parse_hierarchy, read_metadata, read_node_points
from .las_resources import pack_101010
from .resource import Resource, ResourceState

BIN_POINTS = 1_000_000
BUFFER_QUANTUM = 1 << 20  # device buffers pad to whole multiples of this
QUEUE_BINS = 4  # bins read ahead of the uploads


class PotreeData(Resource):
    def __init__(self, path: str, device, budget_points: int | None = None):
        """`budget_points` caps device residency: bins stream in
        coarse-first order until the cap, finer nodes stay on disk.  The
        coarse-first order keeps the resident set a valid LOD prefix
        (parents before children), so the 80-px cut never reaches the
        unresident fine levels (PotreeData.h:288-311, 575-605)."""
        self.device = device_of(device)
        self.path = path
        self.meta = read_metadata(path)
        self.nodes = [n for n in parse_hierarchy(path, self.meta) if n.num_points > 0]
        self.num_points = sum(n.num_points for n in self.nodes)
        self.las_min = self.meta.bbox_min
        # bins: coarse-first (PotreeData.h:288-311)
        bins, cur, cur_n, cur_w = [], [], 0, 1e9
        for nd in self.nodes:
            cur.append(nd)
            cur_n += nd.num_points
            cur_w = min(cur_w, nd.level)
            if cur_n > BIN_POINTS:
                bins.append((cur_w, cur))
                cur, cur_n, cur_w = [], 0, 1e9
        if cur:
            bins.append((cur_w, cur))
        bins.sort(key=lambda b: b[0])
        self.bins = [b[1] for b in bins]
        self.resident_limited = False
        if budget_points is not None:
            kept, cum = [], 0
            for bn in self.bins:
                nb = sum(n.num_points for n in bn)
                if kept and cum + nb > budget_points:
                    break
                kept.append(bn)
                cum += nb
            self.resident_limited = len(kept) < len(self.bins)
            self.bins = kept

        # node table (render frame = world - bbox_min of the octree)
        order = [n for bn in self.bins for n in bn]
        self.nodes = order
        self.node_count = np.array([n.num_points for n in order], np.int64)
        self.node_offset = np.concatenate([[0], np.cumsum(self.node_count)[:-1]]).astype(np.int64)
        self.total_points = int(self.node_count.sum())
        self.node_level = np.array([n.level for n in order], np.int32)
        self.bbox_min = np.stack([(n.bbox_min - self.las_min) for n in order]).astype(np.float32)
        self.bbox_max = np.stack([(n.bbox_max - self.las_min) for n in order]).astype(np.float32)
        self.nodes_loaded = 0
        self.num_points_loaded = 0
        self.dev: dict[str, torch.Tensor] = {}
        self.node_dev: dict[str, torch.Tensor] = {}
        self.node_ids: torch.Tensor | None = None
        self._queue: Queue = Queue(maxsize=QUEUE_BINS)
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()

    @classmethod
    def create(cls, path: str, device, budget_points: int | None = None):
        return cls(path, device, budget_points)

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        n_pad = -(-self.total_points // BUFFER_QUANTUM) * BUFFER_QUANTUM
        self.dev = {k: torch.zeros(n_pad, dtype=torch.int32, device=self.device)
                    for k in ("xyz4", "xyz8", "xyz12", "rgba")}
        self.node_ids = torch.zeros(n_pad, dtype=torch.int32, device=self.device)
        n = len(self.nodes)
        packed = torch.from_numpy(np.concatenate([  # one host -> device copy
            self.bbox_min.ravel(), self.bbox_max.ravel(),
            self.node_offset.astype(np.int32).view(np.float32)])).to(self.device)
        self.node_dev = dict(bmin=packed[:3 * n].view(n, 3), bmax=packed[3 * n:6 * n].view(n, 3),
                             start=packed[6 * n:].view(torch.int32))
        self._queue = Queue(maxsize=QUEUE_BINS)  # nothing of an earlier load carries over
        self._abort.clear()
        self._thread = threading.Thread(target=self._loader_main, daemon=True)
        self._thread.start()

    def _loader_main(self):
        """Read each bin's nodes -> (f32 positions relative to las_min,
        rgba, node ids, nodes loaded after it) into the queue."""
        try:
            idx = 0
            for bn in self.bins:
                pts, rgba, node_ids = [], [], []
                for nd in bn:
                    if self._abort.is_set():
                        return
                    world, colour = read_node_points(self.path, self.meta, nd)
                    pts.append((world - self.las_min).astype(np.float32))
                    rgba.append(colour)
                    node_ids.append(np.full(len(world), idx, np.int32))
                    idx += 1
                self._queue.put((np.concatenate(pts), np.concatenate(rgba),
                                 np.concatenate(node_ids), idx))
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
        self.node_dev = {}
        self.node_ids = None
        self.nodes_loaded = 0
        self.num_points_loaded = 0
        self.state = ResourceState.UNLOADED

    def process(self, renderer=None, max_bins: int = 1):
        """Upload up to `max_bins` bins read by the loader (one per frame,
        PotreeData.h:575-605)."""
        if self.state == ResourceState.UNLOADED:
            return
        for _ in range(max_bins):
            try:
                item = self._queue.get_nowait()
            except Empty:
                break
            if isinstance(item[0], str) and item[0] == "error":
                raise item[1]
            rel, rgba, node_ids, next_loaded = item
            self._upload(rel, rgba, node_ids)
            self.nodes_loaded = next_loaded
        if self.nodes_loaded == len(self.nodes):
            self.state = ResourceState.LOADED

    def _upload(self, rel: np.ndarray, rgba: np.ndarray, node_ids: np.ndarray):
        """One bin: positions, colours and node ids up in one copy, each
        point packed against its node's box on the device and its node
        written to the node-id plane."""
        n = len(rel)
        packed = torch.from_numpy(np.concatenate([
            rel.ravel(), rgba.astype(np.uint32).view(np.float32),
            node_ids.view(np.float32)])).to(self.device)
        nid = packed[4 * n:].view(torch.int32)
        planes = pack_101010(packed[:3 * n].view(n, 3), self.node_dev["bmin"][nid],
                             self.node_dev["bmax"][nid])
        sl = slice(self.num_points_loaded, self.num_points_loaded + n)
        for key, plane in zip(("xyz4", "xyz8", "xyz12"), planes):
            self.dev[key][sl] = plane
        self.dev["rgba"][sl] = packed[3 * n:4 * n].view(torch.int32)
        self.node_ids[sl] = nid
        self.num_points_loaded += n

    def wait_loaded(self, renderer=None):
        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer, max_bins=1000)
            time.sleep(0.01)
        return self
