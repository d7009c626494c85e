"""Fused projection + colour payload + run collapse: kernel B2 and its
plain version.

Counterpart of `pcrhpg24_tpu/render/pallas_project.py`.  The CUDA
kernel (`csrc/project.cu`) replaces `_project_kernel`;
`project_plain` computes the same stream with eager torch ops, which
round per op in the reference's order (pallas_project.py:109-122).
The stream is (pid, dep, pay), each (C, points, 8, 128) int32 holding
u32 bits; pid is in the swizzled 32x32-tile id space and carries the
sentinel `swizzle_dims(width, height)[2]` for clipped, masked and
collapsed entries.  With a per-batch `payload` (batch-payload mode:
the debug frames' batch index or LOD count, `huffman_tpu.py:146-153`)
every entry's payload is its batch's value in place of the colour.  The
colour is BC1, BC7 or raw (`color_fmt`), each read from its own layout
(`bc1_layout`): the reference projects BC7 and raw with XLA ops of the
same formula and order, and decodes their payloads there.
"""

from __future__ import annotations

import torch

from ..constants import POINTS_PER_THREAD, TPU_GROUPS_PER_BATCH
from ..kernels.build import I, P, Kernel, check_cuda
from ..u32 import f32_bits, widen
from .bc1_layout import COLOR_K_SHAPE, PAYLOAD
from .raster import swizzle_dims

G = TPU_GROUPS_PER_BATCH  # 8
LANES = 128
CHAINS = G * LANES
PTS = POINTS_PER_THREAD  # 64

PROJECT = Kernel("pcr_project", [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I])
# the kernel's colour-format argument
FMT_CODES = {"bc1": 0, "bc7": 1, "raw": 2}


def _key_less(ds, ps, d, p):
    return (ds < d) | ((ds == d) & (ps < p))


def _shift_up(a, s: int, fill: int, dim: int):
    """out[i] = a[i+s] along `dim`, the last s entries = fill."""
    n = a.shape[dim]
    tail = torch.full_like(a.narrow(dim, 0, s), fill)
    return torch.cat([a.narrow(dim, s, n - s), tail], dim)


def project_plain(coords, colors_k, anchors, tbc, lodn, frame,
                  width: int, height: int, points: int = PTS, steps: int = 6,
                  chain_collapse: bool = True, collapse: bool = True, payload=None,
                  color_fmt: str = "bc1"):
    """Pure-torch version of `project_batches` on any device.

    coords (C,points,3,8,128) i32, colors_k (C, *COLOR_K_SHAPE[color_fmt])
    i32 (u32 bits, `bc1_layout`), anchors (C,3) i32, tbc (C,4) f32,
    lodn (C,) i32, frame (12,) f32 (wvp rows 0/1/3 by columns 0..2, then
    scale xyz), payload None or (C,) i32 (u32 bits) per batch.
    """
    if color_fmt not in PAYLOAD:
        raise ValueError(f"unknown color_fmt {color_fmt!r}")
    wt, _ht, size = swizzle_dims(width, height)
    C = coords.shape[0]
    bc = lambda a: a[:, None, None, None]
    t = [frame[k] for k in range(12)]
    xs = (coords[:, :, 0] - bc(anchors[:, 0])).to(torch.float32) * t[9]
    ys = (coords[:, :, 1] - bc(anchors[:, 1])).to(torch.float32) * t[10]
    zs = (coords[:, :, 2] - bc(anchors[:, 2])).to(torch.float32) * t[11]
    cx = t[0] * xs + t[1] * ys + t[2] * zs + bc(tbc[:, 0])
    cy = t[3] * xs + t[4] * ys + t[5] * zs + bc(tbc[:, 1])
    w = t[6] * xs + t[7] * ys + t[8] * zs + bc(tbc[:, 3])
    inv = torch.ones_like(w) / w
    ndc_x = cx * inv
    ndc_y = cy * inv
    i = torch.arange(points, device=coords.device)[None, :, None, None]
    ok = (i < bc(lodn)) & (w > 0) & (ndc_x.abs() <= 1) & (ndc_y.abs() <= 1)
    # where ok fails px/py may be NaN-derived garbage; they are unused there
    px = ((ndc_x * 0.5 + 0.5) * width).to(torch.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).to(torch.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    swz = (((py >> 5) * wt + (px >> 5)) << 10) | ((py & 31) << 5) | (px & 31)
    pid = torch.where(ok, swz.to(torch.int64), torch.full_like(swz, size, dtype=torch.int64))
    d = widen(f32_bits(w))
    if payload is None:
        p = PAYLOAD[color_fmt](colors_k, points)
    else:
        p = widen(payload)[:, None, None, None].expand(d.shape).clone()

    if collapse:
        s = 1
        while s < min(points, 1 << steps):
            pid_s = _shift_up(pid, s, size, 1)
            d_s = _shift_up(d, s, 0, 1)
            p_s = _shift_up(p, s, 0, 1)
            take = (pid_s == pid) & _key_less(d_s, p_s, d, p)
            d = torch.where(take, d_s, d)
            p = torch.where(take, p_s, p)
            s *= 2
        prev = torch.cat([torch.full_like(pid[:, :1], size), pid[:, :-1]], 1)
        pid_out = torch.where(pid != prev, pid, torch.full_like(pid, size))
        if chain_collapse:
            pid0 = pid[:, 0].reshape(C, CHAINS)
            d0 = d[:, 0].reshape(C, CHAINS)
            p0 = p[:, 0].reshape(C, CHAINS)
            k = 1
            while k < CHAINS:
                pid_s = _shift_up(pid0, k, size, 1)
                d_s = _shift_up(d0, k, 0, 1)
                p_s = _shift_up(p0, k, 0, 1)
                take = (pid_s == pid0) & _key_less(d_s, p_s, d0, p0)
                d0 = torch.where(take, d_s, d0)
                p0 = torch.where(take, p_s, p0)
                k *= 2
            prevc = torch.cat([torch.full_like(pid0[:, :1], size), pid0[:, :-1]], 1)
            head0 = torch.where(pid0 != prevc, pid0, torch.full_like(pid0, size))
            pid_out[:, 0] = head0.reshape(C, G, LANES)
            d[:, 0] = d0.reshape(C, G, LANES)
            p[:, 0] = p0.reshape(C, G, LANES)
        pid = pid_out
    return tuple(a.to(torch.int32) for a in (pid, d, p))


def project_batches(coords, colors_k, anchors, tbc, lodn, frame,
                    width: int, height: int, points: int = PTS, steps: int = 6,
                    chain_collapse: bool = True, collapse: bool = True, payload=None,
                    color_fmt: str = "bc1"):
    """B2: the arguments and outputs of `pallas_project.project_batches`,
    and the colour format of `colors_k` ("bc1", "bc7" or "raw", each in
    its `bc1_layout` kernel layout), whose payload B2 decodes in the
    kernel where the reference leaves BC7 and raw to XLA
    (`huffman_tpu.py:67-68,155-161`).

    CUDA tensors launch the kernel; CPU tensors take `project_plain`.
    `chain_collapse` applies only with `collapse` (colour mode); HQS
    mode (`collapse=False`) writes every entry raw.  `payload` (C,) i32
    switches to batch-payload mode in either, which reads no colours.
    """
    chain_collapse = chain_collapse and collapse
    if not coords.is_cuda:
        return project_plain(coords, colors_k, anchors, tbc, lodn, frame,
                             width, height, points, steps, chain_collapse,
                             collapse, payload, color_fmt)
    if color_fmt not in FMT_CODES:
        raise ValueError(f"unknown color_fmt {color_fmt!r}")
    if not 0 < points <= PTS:
        raise ValueError(f"points must be in 1..{PTS}, got {points}")
    C = coords.shape[0]
    check_cuda("coords", coords, torch.int32, (C, points, 3, G, LANES))
    check_cuda("colors_k", colors_k, torch.int32, (C, *COLOR_K_SHAPE[color_fmt]))
    check_cuda("anchors", anchors, torch.int32, (C, 3))
    check_cuda("tbc", tbc, torch.float32, (C, 4))
    check_cuda("lodn", lodn, torch.int32, (C,))
    check_cuda("frame", frame, torch.float32, (12,))
    if payload is not None:
        check_cuda("payload", payload, torch.int32, (C,))
    outs = [torch.empty((C, points, G, LANES), dtype=torch.int32,
                        device=coords.device) for _ in range(3)]
    if C:
        PROJECT.launch(frame.data_ptr(), anchors.data_ptr(), tbc.data_ptr(),
                       lodn.data_ptr(), coords.data_ptr(), colors_k.data_ptr(),
                       None if payload is None else payload.data_ptr(),
                       *(o.data_ptr() for o in outs), C, points, width, height,
                       steps, int(chain_collapse), int(collapse), FMT_CODES[color_fmt])
    return tuple(outs)
