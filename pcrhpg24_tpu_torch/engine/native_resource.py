"""Streaming `.tpc` scene resource on torch device tensors.

Counterpart of `pcrhpg24_tpu/engine/native_resource.py:NativeLasData`
for `.tpc` v2 (fbatch) and v1 (tbatch) scenes: the same header-driven
preallocation, detached loader thread, per-frame `process()` upload and
`budget_batches` residency cap.  Device buffers are padded to the render
chunk (64 batches) and hold u32 words as int32 bits.  The colours, BC1
(v1 and v2), BC7 or raw (v2: the reference's COLOR_COMPRESSION 7 and 0,
`color_fmt` in the header), are held once, in their format's kernel
layout (`colors_k`, `render/bc1_layout.py`), the only copy B2 reads: the
reference also keeps each batch's flat row (`colors`), which no path of
the port reads (raw colours are 4 B a point).  So B2 serves v1 too,
where the reference projects with XLA ops of the same formula and order.
The stream buffer is sized from the header's `max_group_words`, which
bounds every batch of the file; a batch wider than that fails its
packing instead of being cut.

`HuffmanNativeData` is the reference `.huffman` scene on the same path,
with the format conversion at load time (the fused C++ transcode of
`native.transcode_ref_batch` on a pool of loader threads).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue

import numpy as np
import torch

from .. import device_of
from .. import native as codec_core
from ..codec.fixed import FixedBatch
from ..constants import TPU_GROUPS_PER_BATCH, WORKGROUP_SIZE
from ..formats.huffman_file import read_batch, read_file_header
from ..formats.native_file import read_tpc_batch, read_tpc_header
from ..render.decode_fixed import pack_fixed_batches
from ..render.decode_tbatch import pack_native_batches
from ..render.methods.huffman_tpu import CHUNK
from ..render.bc1_layout import COLOR_K_SHAPE, colors_kernel_layout
from .resource import Resource, ResourceState, upload_rows

G = TPU_GROUPS_PER_BATCH


class NativeLasData(Resource):
    BATCHES_PER_TASK = 100

    def __init__(self, path: str, device, budget_batches: int | None = None):
        """`budget_batches` caps device residency: the loader streams the
        first `budget_batches` batches (a coarse Morton prefix) and the
        resource reports LOADED there; `resident_limited` records that
        the dataset is larger."""
        self.device = device_of(device)
        self.path = path
        self.header = read_tpc_header(path)
        self.version = self.header.version
        self.color_fmt = self.header.color_fmt
        self.dataset_points = self.header.num_points
        self.dataset_batches = self.header.num_batches
        nb = self.header.num_batches
        if budget_batches is not None:
            nb = min(nb, budget_batches)
        self.resident_limited = nb < self.header.num_batches
        self.num_points = nb * WORKGROUP_SIZE * 64
        self.num_batches = nb
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        # stream width: v2 in (8, 128) tiles, v1 in words per group row
        self.maxt = -(-self.header.max_group_words // 128) + 4
        self.maxw = (-(-self.header.max_group_words // 128) + 2) * 128
        self.dev: dict[str, torch.Tensor] = {}
        self.scale = np.asarray(self.header.scale)
        self.offset = np.asarray(self.header.offset)
        self.las_min = np.asarray(self.header.las_min)
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        b_pad = -(-self.num_batches // CHUNK) * CHUNK
        # per-batch i32 anchors for batch-relative (f64-precision) projection
        self.anchor_i = np.zeros((b_pad, 3), np.int64)
        self._queue: Queue = Queue()
        self._thread = None
        self._abort = threading.Event()

    @classmethod
    def create(cls, path: str, device, budget_batches: int | None = None
               ) -> "NativeLasData":
        return cls(path, device, budget_batches=budget_batches)

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        B = -(-self.num_batches // CHUNK) * CHUNK
        z = lambda shape, dtype=torch.int32: torch.zeros(
            shape, dtype=dtype, device=self.device)
        if self.version == 2:
            self.dev = dict(
                widths=z((B, 3, G, 128)),
                streams=z((B, self.maxt, G, 128)),
                ptrs=z((B, 1, 64)),
                starts=z((B, 3, G, 128)),
            )
        else:
            self.dev = dict(
                lj=z((B, 1, 32)),
                streams=z((B, G, self.maxw)),
                ptrs=z((B, 384, G)),
                dD=z((B, 1, 128)),
                lut=z((B, 1, 128)),
                starts=z((B, 3, G, 128)),
            )
        self.dev.update(
            colors_k=z((B, *COLOR_K_SHAPE[self.color_fmt])),
            bbox_min=z((B, 3), torch.float32),
            bbox_max=z((B, 3), torch.float32),
            anchor=z((B, 3)),
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
                items = [read_tpc_batch(self.path, self.header, i)
                         for i in range(start, end)]
                self._queue.put((start, items))
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
        self.state = ResourceState.UNLOADED

    def process(self, renderer=None, max_tasks: int = 8):
        for _ in range(max_tasks):
            try:
                item = self._queue.get_nowait()
            except Empty:
                break
            if item[0] == "error":
                raise item[1]
            start, items = item
            self._upload(start, items)
        if self.num_batches_loaded == self.num_batches:
            self.state = ResourceState.LOADED

    def _upload(self, start: int, items):
        d = self.dev
        n = len(items)
        fbs = [fb for fb, _c in items]
        if self.version == 2:
            packed = pack_fixed_batches(fbs, maxt=self.maxt)
            keys = ("widths", "streams", "ptrs", "starts")
        else:
            packed = pack_native_batches(fbs, maxw=self.maxw)
            keys = ("lj", "streams", "ptrs", "dD", "lut", "starts")
        packed["streams"] = packed["streams"].view(np.int32)
        for key in keys:
            upload_rows(d[key], start, packed[key])
        colors = np.stack([c for _fb, c in items]).astype(np.uint32)
        upload_rows(d["colors_k"], start,
                    colors_kernel_layout(colors, self.color_fmt).view(np.int32))
        # component-wise chain-start minimum: the exact per-batch anchor
        anchors = np.stack([
            np.asarray(fb.start_values).reshape(-1, 3).min(axis=0) for fb in fbs
        ]).astype(np.int64)
        self.anchor_i[start:start + n] = anchors
        upload_rows(d["anchor"], start, anchors.astype(np.int32))
        for i, fb in enumerate(fbs):
            bmin = fb.bbox_min_i.astype(np.float64) * self.scale + self.offset
            bmax = fb.bbox_max_i.astype(np.float64) * self.scale + self.offset
            self.bbox_min[start + i] = (bmin - self.las_min).astype(np.float32)
            self.bbox_max[start + i] = (bmax - self.las_min).astype(np.float32)
        upload_rows(d["bbox_min"], start, self.bbox_min[start:start + n])
        upload_rows(d["bbox_max"], start, self.bbox_max[start:start + n])
        self.num_batches_loaded = max(self.num_batches_loaded, start + n)
        self.num_points_loaded = self.num_batches_loaded * WORKGROUP_SIZE * 64

    def wait_loaded(self, renderer=None):
        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer, max_tasks=1_000_000)
            time.sleep(0.01)
        return self


def _transcode(b):
    """A `.huffman` batch record -> (FixedBatch, BC1 colours)."""
    st, wd, pt, mn, mx = codec_core.transcode_ref_batch(b)
    fb = FixedBatch(streams=st, widths=wd,
                    start_values=np.asarray(b.start_values, np.int32).reshape(-1, 3),
                    bbox_min_i=mn, bbox_max_i=mx, round_ptrs=pt)
    return fb, np.asarray(b.color, np.uint32)


class HuffmanNativeData(NativeLasData):
    """Reference `.huffman` scene on the `.tpc` v2 path (B1 -> B2 -> B3),
    with the format conversion at LOAD TIME — no `.tpc` on disk.

    Counterpart of `pcrhpg24_tpu/engine/native_resource.py:
    HuffmanNativeData`.  The loader thread reads reference batch blobs
    and a worker pool runs the fused C++ transcode (reference Huffman
    decode -> fbatch fixed-width re-encode in one call; the decoded
    deltas ARE the fixed codec's chain deltas).  Decoded geometry is
    bit-identical to the `.huffman` decode, so the image equals the
    `.tpc` v2 scene's of the same LAS.

    The reference header carries no group-width bound, so the device
    stream buffer starts at 1.5x batch 0's width and grows (one realloc
    + copy) when a task it uploads holds a wider batch.  The check runs
    on each popped task, so no batch can arrive unchecked (the
    reference checks the queue before popping, and loses a wider batch
    that arrives in between).
    """

    BATCHES_PER_TASK = 32

    def __init__(self, path: str, device, budget_batches: int | None = None):
        if not codec_core.available():
            raise RuntimeError("the native codec core (g++) is required for "
                               "the .huffman load-time transcode")
        self.device = device_of(device)
        self.path = path
        self.ref_hdr = read_file_header(path)
        self.dataset_batches = self.ref_hdr.num_batches
        nb = self.ref_hdr.num_batches
        if budget_batches is not None:
            nb = min(nb, budget_batches)
        self.resident_limited = nb < self.ref_hdr.num_batches
        self.dataset_points = self.dataset_batches * WORKGROUP_SIZE * 64
        self.num_batches = nb
        self.num_points = nb * WORKGROUP_SIZE * 64
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self.version = 2
        self.color_fmt = "bc1"
        b0 = read_batch(path, self.ref_hdr, 0)
        self._fb0 = _transcode(b0)
        self.maxt = (self._fb0[0].streams.shape[1] * 3 // 2 + 127) // 128 + 4
        self.maxw = self.maxt * 128
        self.dev: dict[str, torch.Tensor] = {}
        self.scale = np.asarray(b0.las_scale)
        self.offset = np.asarray(b0.las_offset)
        self.las_min = np.asarray(b0.las_min, np.float64)
        self.bbox_min = np.zeros((nb, 3), np.float32)
        self.bbox_max = np.zeros((nb, 3), np.float32)
        b_pad = -(-nb // CHUNK) * CHUNK
        self.anchor_i = np.zeros((b_pad, 3), np.int64)
        self._queue: Queue = Queue()
        self._thread = None
        self._abort = threading.Event()

    def _loader_main(self):
        def one(i):
            if i == 0:
                return self._fb0
            return _transcode(read_batch(self.path, self.ref_hdr, i))

        try:
            # the C++ transcode releases the GIL (ctypes), so a small
            # pool overlaps IO + conversion; sized to the host
            workers = min(8, os.cpu_count() or 1)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for start in range(0, self.num_batches, self.BATCHES_PER_TASK):
                    if self._abort.is_set():
                        return
                    end = min(start + self.BATCHES_PER_TASK, self.num_batches)
                    self._queue.put((start, list(pool.map(one, range(start, end)))))
        except Exception as e:  # surfaced on the render thread by process()
            self._queue.put(("error", e))

    def _upload(self, start: int, items):
        need = max(-(-fb.streams.shape[1] // 128) + 4 for fb, _c in items)
        if need > self.maxt:
            old = self.dev["streams"]
            grown = torch.zeros((old.shape[0], need, G, 128), dtype=old.dtype,
                                device=old.device)
            grown[:, :old.shape[1]] = old
            self.dev["streams"] = grown
            self.maxt = need
            self.maxw = need * 128
        super()._upload(start, items)
