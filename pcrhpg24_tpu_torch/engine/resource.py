"""Resource state machine, the in-place row upload and the streaming
`.huffman` scene resource.

Counterpart of `pcrhpg24_tpu/engine/resource.py` (reference:
modules/compute/Resources.h:20-40, modules/compute/
HuffmanLasLoader.{h,cpp}): a header-driven preallocation of flat device
buffers, a detached loader thread that reads batch blobs from disk, and
a per-frame `process()` that uploads pending batches into device-buffer
slices via append cursors.  The reference updates preallocated jax
arrays with a donated `dynamic_update_slice`; torch tensors are
mutable, so `upload_rows` copies into a slice of the preallocated device
tensor in place and streaming never reallocates.
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from queue import Empty, Queue

import numpy as np
import torch

from .. import device_of
from ..constants import RENDER_CHUNK_BATCHES, WARP_SIZE, WARPS_PER_BATCH, WORKGROUP_SIZE
from ..formats.huffman_file import BatchDump, read_batch, read_file_header
from ..render.bc1_layout import colors_kernel_layout


class ResourceState(Enum):
    UNLOADED = 0
    LOADING = 1
    LOADED = 2
    UNLOADING = 3


class Resource:
    state: ResourceState = ResourceState.UNLOADED

    def load(self, renderer):  # pragma: no cover - interface
        raise NotImplementedError

    def unload(self, renderer):
        raise NotImplementedError

    def process(self, renderer):
        raise NotImplementedError


def upload_rows(buf: torch.Tensor, start: int, vals: np.ndarray) -> None:
    """buf[start:start+len(vals)] = vals, in place (host -> device copy).

    u32 arrays arrive as their int32 bit views (`u32.from_u32`)."""
    src = torch.from_numpy(np.ascontiguousarray(vals))
    if src.dtype != buf.dtype:
        raise TypeError(f"upload of {src.dtype} into a {buf.dtype} buffer")
    buf[start:start + src.shape[0]].copy_(src)


class HuffmanLasData(Resource):
    """Streaming `.huffman` scene with flat device buffers.

    Device layout mirrors the reference's nine cuMemAlloc buffers
    (HuffmanLasLoader.cpp:32-77): encoding, separate, per-batch decoder
    tables, cluster sizes, separate sizes, start values, colors, and
    batch metadata, each indexed through per-batch offsets.  `dev` holds
    the reference's keys (u32 arrays as int32 bits) and `colors_k`, the
    colours in B2's layout (`colors_kernel_layout`).
    """

    BATCHES_PER_TASK = 100  # loader granularity (HuffmanLasLoader.cpp:81-149)

    def __init__(self, path: str, device):
        self.device = device_of(device)
        self.path = path
        self.header = read_file_header(path)
        self.num_points = self.header.num_points
        self.num_batches = self.header.num_batches
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self.dev: dict[str, torch.Tensor] = {}
        self.scale = None
        self.offset = None
        self.las_min = None
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        b_pad = -(-self.num_batches // RENDER_CHUNK_BATCHES) * RENDER_CHUNK_BATCHES
        # per-batch i32 anchors for batch-relative (f64-precision) projection
        self.anchor_i = np.zeros((b_pad, 3), np.int64)
        self._queue: Queue = Queue()
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()
        self._enc_cursor = 0
        self._sep_cursor = 0

    @classmethod
    def create(cls, path: str, device) -> "HuffmanLasData":
        return cls(path, device)

    # -- loading ---------------------------------------------------------

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        # pad batch-row arrays to the reference's render chunk size
        B = -(-self.num_batches // RENDER_CHUNK_BATCHES) * RENDER_CHUNK_BATCHES
        h = self.header
        enc_words = h.encoding_bytes // 4 + 2 * WARP_SIZE  # overread pad
        sep_words = max(h.separate_bytes // 4, 1)
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
        self.dev = dict(
            encoding=z(enc_words),
            enc_offsets=z(B),
            cluster_sizes=z(B, WARPS_PER_BATCH),
            separate=z(sep_words),
            sep_offsets=z(B),
            separate_sizes=z(B, WORKGROUP_SIZE),
            table_values=z(B, 4096),
            table_cw_len=z(B, 4096),
            start_values=z(B, WORKGROUP_SIZE, 3),
            colors=z(B, WORKGROUP_SIZE * 64 // 8),
            colors_k=z(B, 4, 2, 8, 128),
            anchor=z(B, 3),
        )
        self._abort.clear()
        self._thread = threading.Thread(target=self._loader_main, daemon=True)
        self._thread.start()

    def _loader_main(self):
        try:
            for start in range(0, self.num_batches, self.BATCHES_PER_TASK):
                if self._abort.is_set():
                    return
                end = min(start + self.BATCHES_PER_TASK, self.num_batches)
                dumps = [read_batch(self.path, self.header, i) for i in range(start, end)]
                self._queue.put((start, dumps))
        except Exception as e:  # surfaced on the render thread by process()
            self._queue.put(("error", e))

    def unload(self, renderer=None):
        self.state = ResourceState.UNLOADING
        self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.dev = {}
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self._enc_cursor = 0
        self._sep_cursor = 0
        self.state = ResourceState.UNLOADED

    # -- per-frame upload -----------------------------------------------

    def process(self, renderer=None, max_tasks: int = 8):
        """Drain loaded batch groups into device buffers (append cursors)."""
        for _ in range(max_tasks):
            try:
                item = self._queue.get_nowait()
            except Empty:
                break
            if item[0] == "error":
                raise item[1]
            start, dumps = item
            self._upload_group(start, dumps)
        if self.num_batches_loaded == self.num_batches:
            self.state = ResourceState.LOADED

    def _upload_group(self, start: int, dumps: list[BatchDump]):
        n = len(dumps)
        if self.scale is None:
            self.scale = np.asarray(dumps[0].las_scale)
            self.offset = np.asarray(dumps[0].las_offset)
            self.las_min = np.asarray(dumps[0].las_min, np.float64)

        enc = np.concatenate([np.asarray(d.encoding, np.uint32) for d in dumps])
        sep_parts = [np.asarray(d.separate, np.int32) for d in dumps]
        sep = np.concatenate(sep_parts)
        enc_offs = self._enc_cursor + np.concatenate(
            [[0], np.cumsum([len(d.encoding) for d in dumps])[:-1]]
        ).astype(np.int32)
        sep_offs = self._sep_cursor + np.concatenate(
            [[0], np.cumsum([len(s) for s in sep_parts])[:-1]]
        ).astype(np.int32)
        colors = np.stack([d_.color for d_ in dumps]).astype(np.uint32)
        # anchor: exact per-batch i32 reference point (the format has no
        # integer bbox; the component-wise start_values minimum serves)
        anchors = np.stack([
            np.asarray(d_.start_values).reshape(-1, 3).min(axis=0) for d_ in dumps
        ]).astype(np.int64)

        d = self.dev
        upload_rows(d["encoding"], self._enc_cursor, enc.view(np.int32))
        upload_rows(d["separate"], self._sep_cursor, sep)
        upload_rows(d["enc_offsets"], start, enc_offs)
        upload_rows(d["sep_offsets"], start, sep_offs)
        for key, field in (("cluster_sizes", "cluster_sizes"),
                           ("separate_sizes", "separate_sizes"),
                           ("table_values", "decoder_values"),
                           ("table_cw_len", "decoder_cw_len")):
            upload_rows(d[key], start,
                        np.stack([getattr(d_, field) for d_ in dumps]).astype(np.int32))
        upload_rows(d["start_values"], start, np.stack(
            [np.asarray(d_.start_values).reshape(-1, 3) for d_ in dumps]).astype(np.int32))
        upload_rows(d["colors"], start, colors.view(np.int32))
        upload_rows(d["colors_k"], start, colors_kernel_layout(colors).view(np.int32))
        self.anchor_i[start:start + n] = anchors
        upload_rows(d["anchor"], start, anchors.astype(np.int32))

        for i, dump in enumerate(dumps):
            # render frame is world - las_min (render.cu:336-341)
            self.bbox_min[start + i] = dump.bbox_min - self.las_min.astype(np.float32)
            self.bbox_max[start + i] = dump.bbox_max - self.las_min.astype(np.float32)
        self._enc_cursor += len(enc)
        self._sep_cursor += len(sep)
        self.num_batches_loaded = max(self.num_batches_loaded, start + n)
        self.num_points_loaded = self.num_batches_loaded * WORKGROUP_SIZE * 64

    def wait_loaded(self, renderer=None):
        """Block until fully loaded."""
        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer, max_tasks=1_000_000)
            time.sleep(0.01)
        return self
