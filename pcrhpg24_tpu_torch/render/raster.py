"""Swizzled pixel ids, the exact u64-min resolves (B3, and B6 after a
sort) and the image.

Counterpart of `pcrhpg24_tpu/render/raster.py`.  The reference resolves
a frame's (pid, depth, payload) stream by sorting it and merging the
sorted rows (`pallas_merge._merge_matscatter_kernel`), because the TPU
has no atomics.  Here the CUDA kernel (`csrc/raster.cu`) resolves every
part of a frame, unsorted, in one launch: a warp stages a tile of 32
points of 16 chains (the chain layout of the `.tpc` and `.huffman`
streams; the `.las` and Potree parts, one entry a point, take the flat
layout: 512 consecutive entries), reads the dense plane's word for each
entry's pixel, and does an `atomicMin` of the u64
`(depth << 32) | payload` key for each key below its word;
`u64_min_planes_plain` gets the same planes from
`scatter_reduce("amin")` on biased int64 keys.  The methods
that resolve a whole frame in linear pixel ids (`parametric`,
`loop_nodes_compressed`) go through `sorted_resolve_u64_min[_parts]`:
one sort by pid, then B6 (`merge.dense_from_sorted_nk1_multi`), as the
reference's TPU path does.  Planes and images are int32 tensors holding
the reference's u32 bits.

After the resolve, all torch ops: the debug images (`frame_image`, and
`overdraw_counts` with its heatmap `overdraw_image`, as
`methods/huffman_tpu.py:296-342` has them) and eye-dome lighting
(`edl_shade`, `raster.py:233-259`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.build import I, P, Kernel, check_cuda, part_groups
from ..u32 import (INT32_MIN, INT64_MAX, INT64_MIN, biased_key, key_views, split_key,
                   unbias_key, widen)

EMPTY = -1  # reference raster.EMPTY (0xFFFFFFFF) as int32 bits
BACKGROUND = 0x00443322  # resolve.cu:166
TILE_PX = 32

U64_MIN = Kernel("pcr_u64_min", [P, P, P, P, I, P, I])
U64_MIN_FLAT = Kernel("pcr_u64_min_flat", [P, P, P, P, I, P, I])
# B3's kernel for each layout of a part (`csrc/tiles.cuh`): "chain", rows
# of 1024 entries, a row one point index of 8 x 128 chains (the `.tpc` and
# `.huffman` streams); "flat", one entry a point in file or node order
# (the `.las` and Potree parts)
U64_MIN_LAYOUTS = {"chain": U64_MIN, "flat": U64_MIN_FLAT}


def swizzle_dims(width: int, height: int):
    """-> (tiles_x, tiles_y, swizzled id space size)."""
    wt = -(-width // TILE_PX)
    ht = -(-height // TILE_PX)
    return wt, ht, wt * ht * TILE_PX * TILE_PX


def swizzle_pid(px, py, width: int):
    """Pixel coords -> swizzled id ((ty*wt+tx)<<10 | ly<<5 | lx)."""
    wt = -(-width // TILE_PX)
    return (((py >> 5) * wt + (px >> 5)) << 10) | ((py & 31) << 5) | (px & 31)


def unswizzle_plane(fb, width: int, height: int):
    """Swizzled (wt*ht*1024,) plane -> linear (height*width,) plane."""
    wt, ht, _ = swizzle_dims(width, height)
    img = fb.reshape(ht, wt, TILE_PX, TILE_PX).permute(0, 2, 1, 3)
    return img.reshape(ht * TILE_PX, wt * TILE_PX)[:height, :width].reshape(-1)


def key_plane(size: int, device):
    """A running u64 key plane for `u64_min_planes(..., plane=)`: (size,)
    int64 holding the u64 `(dep << 32) | pay` bits, all ones (EMPTY)."""
    return torch.full((size,), -1, dtype=torch.int64, device=device)


def u64_min_planes_plain(parts, size: int, plane=None):
    """Exact per-pixel u64 (dep<<32|pay) min over every (pid, dep, pay)
    stream in `parts` -> (fb_depth, fb_payload), each (size,) int32 u32
    bits, EMPTY where no entry landed; pids outside [0, size) drop.

    Equal to `raster.scatter_u64_min` (tie-break by payload included):
    the biased key orders like the u64 key and EMPTY is INT64_MAX.  With
    `plane` (`key_plane`), the parts are min-combined into it in place
    and the planes are views of it, as `u64_min_planes` returns them.
    """
    device = parts[0][0].device if parts else plane.device
    biased = torch.full((size + 1,), INT64_MAX, dtype=torch.int64, device=device)
    if plane is not None:
        biased[:size] = plane ^ INT64_MIN  # all ones -> INT64_MAX
    for pid, dep, pay in parts:
        pid = pid.reshape(-1).to(torch.int64)
        live = (pid >= 0) & (pid < size)
        idx = torch.where(live, pid, torch.full_like(pid, size))
        biased.scatter_reduce_(0, idx, biased_key(dep.reshape(-1), pay.reshape(-1)),
                               reduce="amin", include_self=True)
    if plane is None:
        return split_key(unbias_key(biased[:size]))
    plane.copy_(unbias_key(biased[:size]))
    return key_views(plane)


def u64_min_planes(parts, size: int, plane=None, layout: str = "chain"):
    """B3: the planes of `u64_min_planes_plain`, one kernel launch for up
    to 64 parts into one u64 plane.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Each part's tensors are int32 (u32 bits) of one shape.  On the card
    the planes are strided views (stride 2) of the u64 plane.  With
    `plane` (`key_plane`, on the parts' device), the parts are resolved
    into that running plane, so that a frame's parts can go in groups.
    `layout` ("chain" or "flat", `U64_MIN_LAYOUTS`) picks the kernel for
    the parts' order; the planes do not depend on it.
    """
    kernel = U64_MIN_LAYOUTS[layout]  # a KeyError for any other layout
    on_card = plane.is_cuda if plane is not None else parts[0][0].is_cuda
    if not on_card:
        return u64_min_planes_plain(parts, size, plane)
    if plane is None:
        plane = key_plane(size, parts[0][0].device)
    check_cuda("plane", plane, torch.int64, (size,))
    for group in part_groups(parts):
        kernel.launch(*group, plane.data_ptr(), size)
    return key_views(plane)


def project_points(fx, fy, fz, transform, width: int, height: int):
    """f32 positions -> (linear pid, depth bits), int32 each: the
    projection of `parametric.py:56-67` and `loop_nodes_compressed.py:
    117-128`, op for op.  Pids of points off screen are width*height."""
    t = transform
    cx = t[0, 0] * fx + t[0, 1] * fy + t[0, 2] * fz + t[0, 3]
    cy = t[1, 0] * fx + t[1, 1] * fy + t[1, 2] * fz + t[1, 3]
    w = t[3, 0] * fx + t[3, 1] * fy + t[3, 2] * fz + t[3, 3]
    ndc_x, ndc_y = cx / w, cy / w
    ok = (w > 0) & (ndc_x.abs() <= 1) & (ndc_y.abs() <= 1)
    sx = ((ndc_x * 0.5 + 0.5) * width).to(torch.int32)
    sy = ((ndc_y * 0.5 + 0.5) * height).to(torch.int32)
    ok &= (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    size = width * height
    pid = torch.where(ok, sx + sy * width, torch.full_like(sx, size))
    return pid, w.contiguous().view(torch.int32)


def sort_by_pid(pid, dep, pay):
    """One unstable sort by pid as u32 (the reference's
    `lax.sort(num_keys=1)`), depth and payload following; flattened."""
    spid, order = torch.sort(pid.reshape(-1) ^ INT32_MIN)  # signed order == u32 order
    return spid ^ INT32_MIN, dep.reshape(-1)[order], pay.reshape(-1)[order]


def sorted_resolve_u64_min_parts(parts, size: int, need_depth: bool = True,
                                 presorted: bool = False, plain: bool = False):
    """Whole-frame exact u64-min resolve of every (pid, dep, pay) part
    -> (fb_d or None, fb_p), (size,) int32 each, EMPTY where nothing
    landed.  Each part is sorted by pid on its own (unless `presorted`),
    then B6 min-combines them.  `plain=True` resolves with the plain
    version on whatever device the tensors are on (the gate B6 is held
    to)."""
    from .merge import dense_from_sorted_nk1_multi

    sorted_parts = parts if presorted else [sort_by_pid(*p) for p in parts]
    if plain:
        fb_d, fb_p = u64_min_planes_plain(sorted_parts, size)
        return (fb_d if need_depth else None), fb_p
    return dense_from_sorted_nk1_multi(sorted_parts, size, need_depth)


def sorted_resolve_u64_min(pid, depth, payload, size: int,
                           need_depth: bool = True, plain: bool = False):
    """`sorted_resolve_u64_min_parts` of one stream (`raster.py:181-222`):
    one sort by pid, then B6.  The reference's XLA branch (a 3-key sort
    and a head scatter) gives the same planes."""
    return sorted_resolve_u64_min_parts([(pid, depth, payload)], size,
                                        need_depth, plain=plain)


def resolve(fb_payload, width: int, height: int):
    """Framebuffer -> (H, W) int32 RGBA image (resolve.cu:149-191)."""
    color = torch.where(fb_payload != EMPTY, fb_payload,
                        torch.full_like(fb_payload, BACKGROUND))
    return color.reshape(height, width)


def frame_image(fb_payload, mode: str, width: int, height: int):
    """The image of a payload plane (linear, int32 u32 bits) in a frame
    `mode` (`huffman_tpu.py:319-342`): "color" resolves the BC1 colour;
    "colorize_chunks" hashes the batch index (`fb_p * 1234567` mod 2**32);
    "show_num_points" greys the LOD count (`clip(f32(fb_p) / 64 * 255,
    0, 255)`, truncated).  Empty pixels take the background."""
    if mode == "colorize_chunks":
        # the product stays below 2**53 in int64; its low word is the u32 product
        color = (widen(fb_payload) * 1234567).to(torch.int32)
    elif mode == "show_num_points":
        shade = torch.clamp((widen(fb_payload).to(torch.float32) / 64.0) * 255.0, 0, 255)
        shade = shade.to(torch.int32)
        color = shade | (shade << 8) | (shade << 16)
    elif mode == "color":
        return resolve(fb_payload, width, height)
    else:
        raise ValueError(f"no payload image for mode {mode!r}")
    return torch.where(fb_payload != EMPTY, color,
                       torch.full_like(color, BACKGROUND)).reshape(height, width)


DROP_SLOTS = 1024  # spare count slots that take the entries landing nowhere


def overdraw_counts(parts, size: int, device):
    """Entries landing on each pixel of the swizzled id space, over every
    (pid, dep, pay) part (uncollapsed streams) -> (size,) int32; pids at
    or past `size` drop.  The reference's XLA scatter-add
    (`huffman_tpu.py:300-302`) as `index_add_`.  The dropped entries (most
    of a close-up's stream: the culled and LOD-masked points) go to
    `DROP_SLOTS` spare slots past the plane, entry i to slot i % 1024, so
    that their atomic adds on the card do not all meet on one word."""
    counts = torch.zeros((size + DROP_SLOTS,), dtype=torch.int32, device=device)
    for pid, _dep, _pay in parts:
        q = widen(pid.reshape(-1))
        spare = size + (torch.arange(q.numel(), device=device) & (DROP_SLOTS - 1))
        counts.index_add_(0, torch.where(q < size, q, spare),
                          torch.ones_like(q, dtype=torch.int32))
    return counts[:size]


NINTH = float(np.float32(1) / np.float32(9))  # XLA's reciprocal of the constant 9
OVERDRAW_COLORS = ((10, 0x00A4DDAB), (250, 0x00BFFFFF), (1000, 0x0061AEFD),
                   (4000, 0x001C19D7))


def overdraw_image(counts, width: int, height: int):
    """Linear (H*W,) counts -> (H, W) 5-bucket heatmap (`huffman_tpu.py:
    303-309`, after compute_loop_las_hqs/resolve.cs:54-103)."""
    color = torch.full_like(counts, 0x00BA832B)
    for thresh, c in OVERDRAW_COLORS:
        color = torch.where(counts >= thresh, torch.full_like(color, c), color)
    return torch.where(counts > 0, color,
                       torch.full_like(color, BACKGROUND)).reshape(height, width)


def _f32(v: float) -> float:
    return float(np.float32(v))


EXP_POLY = tuple(_f32(v) for v in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
                                   5.0000001201e-1))


def _fma(a, b, c):
    """f32 a * b + c rounded once: the f32 product is exact in f64."""
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def xla_exp(x):
    """XLA-CPU's f32 `exp`, bit for bit, in f32 torch ops (the Cephes
    polynomial that XLA emits, with every multiply-add fused and results
    below 2**-126 flushed to zero): clamp x to [-87.8, 88.8],
    n = floor(x log2(e) + 0.5) clamped to [-127, 127], r = x - n ln(2)
    in two steps, a degree-5 polynomial in r, then times 2**n built
    from its exponent bits.  Equal to `jnp.exp` at O0 on every f32 but
    the NaNs (a scan of all of them; EDL reaches [-104, 0]), and held to
    it by `tests/test_torch_outputs.py`."""
    x = torch.clamp(x, _f32(-87.8), _f32(88.8))
    n = torch.clamp(torch.floor(_fma(x, _f32(1.44269504088896341), 0.5)), -127.0, 127.0)
    r = _fma(n, _f32(-0.693359375), x)
    r = _fma(n, _f32(2.12194440e-4), r)
    z = _fma(r, _f32(1.9875691500e-4), _f32(1.3981999507e-3))
    for p in EXP_POLY:
        z = _fma(z, r, p)
    z = 1.0 + _fma(z, r * r, r)
    # 2**n from its exponent bits: 0 at n = -127
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    y = z * pow2
    return torch.where(y < _f32(2.0 ** -126), torch.zeros_like(y), y)


def edl_shade(img, fb_d, width: int, height: int, strength: float = 0.0005):
    """Eye-dome lighting (`raster.py:233-259`, after the reference's
    resolve.cs:143-188): per pixel s = the sum over the 3x3 neighbourhood,
    row-major from (-1, -1), of max(0, depth - neighbour depth), then
    shade = exp(-(s / 9) * 300 * strength) (`xla_exp`) and each RGB channel
    min(ch * shade, 255) truncated, all in f32.  Empty pixels and the
    border count as depth +inf; an empty pixel keeps its colour (its
    inf - inf NaN is masked out).  `img` (H, W) int32, `fb_d` (W*H,)
    depth bits in linear pixel order.  XLA divides by the constant 9 as
    a multiply by its f32 reciprocal, so this does too."""
    bits = fb_d.reshape(height, width)
    empty = bits == EMPTY
    d = torch.where(empty, float("inf"), bits.contiguous().view(torch.float32))
    pad = torch.nn.functional.pad(d, (1, 1, 1, 1), value=float("inf"))
    s = torch.zeros_like(d)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            nb = pad[1 + oy:1 + oy + height, 1 + ox:1 + ox + width]
            s = s + (d - nb).clamp_min(0.0)
    # Python floats that f32 holds exactly: no host -> device copy
    shade = xla_exp(-(s * NINTH) * 300.0 * float(np.float32(strength)))

    def ch(sh):
        v = ((img >> sh) & 0xFF).to(torch.float32) * shade
        return torch.clamp(v, max=255.0).to(torch.int32)

    shaded = ch(0) | (ch(8) << 8) | (ch(16) << 16)
    return torch.where(empty, img, shaded)


def image_to_rgb8(image):
    """(H,W) int32 (R | G<<8 | B<<16) -> (H,W,3) uint8, flipped to y-down."""
    img = image.flip(0)
    return torch.stack([(img >> s) & 0xFF for s in (0, 8, 16)], -1).to(torch.uint8)
