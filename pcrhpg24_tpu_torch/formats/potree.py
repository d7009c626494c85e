"""Potree 2.0 octree format: metadata/hierarchy parsing plus a builder.

Parser mirrors the reference's PotreeData loading (reference:
modules/compute/PotreeData.h:120-259): metadata.json attributes,
22-byte hierarchy records (type, childMask, numPoints, byteOffset,
byteSize) expanded recursively through proxy (type 2) nodes, and child
AABB subdivision.

The builder is our own (the reference consumes externally-converted
Potree datasets): it constructs a valid potree-2 directory from a point
cloud — inner nodes hold spacing-subsampled points, leaves the rest —
so the LOD path is testable end-to-end without external data.

A copy of `pcrhpg24_tpu/formats/potree.py`.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np

HIER_RECORD = 22
TYPE_NORMAL = 0
TYPE_LEAF = 1
TYPE_PROXY = 2


@dataclass
class PotreeNode:
    name: str
    level: int
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    spacing: float
    num_points: int = 0
    byte_offset: int = 0
    byte_size: int = 0
    node_type: int = TYPE_NORMAL
    children: list = field(default_factory=lambda: [None] * 8)


def child_aabb(bmin, bmax, index):
    """Octant subdivision (PotreeData.h createChildAABB semantics)."""
    c = 0.5 * (bmin + bmax)
    out_min = bmin.copy()
    out_max = c.copy()
    for axis, bit in ((0, 4), (1, 2), (2, 1)):
        if index & bit:
            out_min[axis] = c[axis]
            out_max[axis] = bmax[axis]
    return out_min, out_max


@dataclass
class PotreeMetadata:
    points: int
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    scale: np.ndarray
    offset: np.ndarray
    spacing: float
    first_chunk_size: int
    bytes_per_point: int
    rgb_offset: int


def read_metadata(path: str) -> PotreeMetadata:
    with open(os.path.join(path, "metadata.json")) as f:
        js = json.load(f)
    bpp = 0
    rgb_offset = -1
    for attr in js["attributes"]:
        if attr["name"] in ("rgb", "rgba"):
            rgb_offset = bpp
        bpp += attr["size"]
    return PotreeMetadata(
        points=js["points"],
        bbox_min=np.array(js["boundingBox"]["min"]),
        bbox_max=np.array(js["boundingBox"]["max"]),
        scale=np.array(js["scale"]),
        offset=np.array(js["offset"]),
        spacing=js["spacing"],
        first_chunk_size=js["hierarchy"]["firstChunkSize"],
        bytes_per_point=bpp,
        rgb_offset=rgb_offset,
    )


def parse_hierarchy(path: str, meta: PotreeMetadata) -> list[PotreeNode]:
    """All real (non-proxy) nodes, recursive proxy expansion

    (PotreeData.h:188-259)."""
    with open(os.path.join(path, "hierarchy.bin"), "rb") as f:
        buf = f.read()

    root = PotreeNode("r", 0, meta.bbox_min.copy(), meta.bbox_max.copy(), meta.spacing)

    def expand(node, h_offset, h_size):
        n = h_size // HIER_RECORD
        nodes = [node] + [None] * (n - 1)
        pos = 1
        proxies = []
        for i in range(n):
            cur = nodes[i]
            t, mask, npts = struct.unpack_from("<BBI", buf, h_offset + i * HIER_RECORD)
            boff, bsize = struct.unpack_from(
                "<qq", buf, h_offset + i * HIER_RECORD + 6
            )
            if t == TYPE_PROXY:
                cur.node_type = t
                proxies.append((cur, boff, bsize))
            else:
                cur.node_type = t
                cur.byte_offset = boff
                cur.byte_size = bsize
                cur.num_points = npts
                for ci in range(8):
                    if mask & (1 << ci):
                        cmin, cmax = child_aabb(cur.bbox_min, cur.bbox_max, ci)
                        child = PotreeNode(
                            cur.name + str(ci), cur.level + 1, cmin, cmax,
                            cur.spacing / 2,
                        )
                        cur.children[ci] = child
                        nodes[pos] = child
                        pos += 1
        out = [nd for nd in nodes[:pos] if nd is not None and nd.node_type != TYPE_PROXY]
        for p, boff, bsize in proxies:
            out.extend(expand(p, boff, bsize))
        return out

    return expand(root, 0, meta.first_chunk_size)


def read_node_points(path: str, meta: PotreeMetadata, node: PotreeNode):
    """-> (world_xyz f64 (n,3), rgba u32 (n,))."""
    with open(os.path.join(path, "octree.bin"), "rb") as f:
        f.seek(node.byte_offset)
        raw = np.frombuffer(f.read(node.byte_size), np.uint8)
    n = node.num_points
    raw = raw.reshape(n, meta.bytes_per_point)
    xyz = raw[:, 0:12].copy().view(np.int32).reshape(n, 3)
    world = xyz.astype(np.float64) * meta.scale + meta.offset
    if meta.rgb_offset >= 0:
        rgb16 = (
            raw[:, meta.rgb_offset : meta.rgb_offset + 6]
            .copy()
            .view(np.uint16)
            .reshape(n, 3)
            .astype(np.uint32)
        )
        rgb = np.where(rgb16 > 255, rgb16 // 256, rgb16)
    else:
        rgb = np.zeros((n, 3), np.uint32)
    rgba = rgb[:, 0] | (rgb[:, 1] << 8) | (rgb[:, 2] << 16)
    return world, rgba


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def build_potree(
    out_dir: str,
    world_xyz: np.ndarray,
    rgb: np.ndarray,
    scale=(0.001, 0.001, 0.001),
    leaf_capacity: int = 20_000,
) -> str:
    """Write a potree-2 dataset (metadata.json/hierarchy.bin/octree.bin)."""
    os.makedirs(out_dir, exist_ok=True)
    scale = np.asarray(scale)
    offset = world_xyz.min(axis=0)
    bmin = world_xyz.min(axis=0)
    span = (world_xyz.max(axis=0) - bmin).max()
    span = max(span, 1e-6) * 1.0001
    bmax = bmin + span  # cubic root bbox (potree convention)
    spacing = span / 128.0

    points_blobs: list[bytes] = []
    records = []  # (name, type, childMask, numPoints, byteOffset, byteSize)
    byte_cursor = 0

    def grid_subsample(pts, rgbs, cell):
        keys = np.floor((pts - bmin) / cell).astype(np.int64)
        _, first = np.unique(
            keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791,
            return_index=True,
        )
        mask = np.zeros(len(pts), bool)
        mask[first] = True
        return mask

    def encode(pts, rgbs):
        n = len(pts)
        rec = np.zeros((n, 18), np.uint8)
        grid = np.round((pts - offset) / scale).astype(np.int32)
        rec[:, 0:12] = grid.view(np.uint8).reshape(n, 12)
        rec[:, 12:18] = rgbs.astype(np.uint16).view(np.uint8).reshape(n, 6)
        return rec.tobytes()

    nodes_out = []

    def build(name, level, nmin, nmax, pts, rgbs):
        nonlocal byte_cursor
        node_spacing = spacing / (2**level)
        if len(pts) <= leaf_capacity:
            blob = encode(pts, rgbs)
            nodes_out.append(
                dict(name=name, type=TYPE_LEAF, mask=0, n=len(pts),
                     off=byte_cursor, size=len(blob))
            )
            points_blobs.append(blob)
            byte_cursor += len(blob)
            return nodes_out[-1]
        keep = grid_subsample(pts, rgbs, node_spacing)
        own, own_rgb = pts[keep], rgbs[keep]
        rest, rest_rgb = pts[~keep], rgbs[~keep]
        blob = encode(own, own_rgb)
        me = dict(name=name, type=TYPE_NORMAL, mask=0, n=len(own),
                  off=byte_cursor, size=len(blob))
        nodes_out.append(me)
        points_blobs.append(blob)
        byte_cursor += len(blob)
        c = 0.5 * (nmin + nmax)
        oct_idx = (
            (rest[:, 0] >= c[0]).astype(int) * 4
            + (rest[:, 1] >= c[1]).astype(int) * 2
            + (rest[:, 2] >= c[2]).astype(int)
        )
        children = {}
        for ci in range(8):
            sel = oct_idx == ci
            if sel.sum() == 0:
                continue
            me["mask"] |= 1 << ci
            cmin, cmax = child_aabb(nmin, nmax, ci)
            children[ci] = (cmin, cmax, rest[sel], rest_rgb[sel])
        me["children"] = []
        for ci, (cmin, cmax, cp, cr) in sorted(children.items()):
            me["children"].append(build(name + str(ci), level + 1, cmin, cmax, cp, cr))
        return me

    root = build("r", 0, bmin, bmax, world_xyz, rgb)

    # hierarchy: BFS record order (matches the parser's expansion order)
    order = []
    queue = [root]
    while queue:
        nd = queue.pop(0)
        order.append(nd)
        queue.extend(nd.get("children", []))
    hier = bytearray()
    for nd in order:
        hier += struct.pack("<BBIqq", nd["type"], nd["mask"], nd["n"], nd["off"], nd["size"])

    with open(os.path.join(out_dir, "octree.bin"), "wb") as f:
        for blob in points_blobs:
            f.write(blob)
    with open(os.path.join(out_dir, "hierarchy.bin"), "wb") as f:
        f.write(bytes(hier))
    meta = {
        "version": "2.0",
        "points": int(len(world_xyz)),
        "boundingBox": {"min": list(map(float, bmin)), "max": list(map(float, bmax))},
        "scale": list(map(float, scale)),
        "offset": list(map(float, offset)),
        "spacing": float(spacing),
        "hierarchy": {"firstChunkSize": len(hier), "stepSize": 100},
        "attributes": [
            {"name": "position", "size": 12, "type": "int32"},
            {"name": "rgb", "size": 6, "type": "uint16"},
        ],
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
