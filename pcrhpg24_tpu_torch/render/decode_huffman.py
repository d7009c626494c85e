"""`.huffman` stream decode: kernel B12 and its plain version.

Counterpart of `pcrhpg24_tpu/render/decode_jax.py:decode_batches_core`,
the reference's XLA decoder of the `.huffman` batch streams (no Pallas
kernel: the reference vectorises the source's warp decoder,
`render.cu:398-451`, over batches x 1024 lanes).  Each of a batch's 1024
chains keeps a two-word window (`cur`, `nxt`) on its warp's interleaved
word stream, looks the window's top 12 bits up in the batch's 4096-entry
table (a negative or zero length is an escape: the symbol comes from the
`separate` stream), and when its window runs dry takes the next word of
its warp's stream in ballot order: lane t of a warp that needs a word
reads `already + (lanes below t that need one)`, and `already` grows by
the warp's count.  Symbols are the x y z deltas of the chain's points.

`decode_ref_plain` mirrors `decode_batches_core` op for op in torch
(u32 words as int64 values, `u32.widen`); `decode_ref_batches` launches
the CUDA kernel (`csrc/decode_huffman.cu`): blocks of 8 warps, four per
batch, each warp streaming its words through a ring in shared memory and
reading its escapes from a staged copy, so that no symbol waits on
device memory and a 64-batch chunk's 256 blocks are resident on every
SM at once.  Both write B1's output layout, (B, points, 3, 8, 128)
int32 absolute coordinates with chain
c = warp * 32 + lane at (c // 128, c % 128), so that B2 reads them
unchanged, and both decode only the first `points` points of each chain
(the static LOD bucket): the decode is sequential per chain, so that
prefix is bit-identical to the first `points` of a full decode.

Reads past a buffer's end return what the reference's clipped gathers
return: the reference pads `encoding` with 64 zero words and `separate`
with one zero (or gives one zero for an empty `separate`), and clips
every index into the padded array.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import (
    HUFFMAN_TABLE_SIZE,
    MAX_CW_LEN,
    POINTS_PER_THREAD,
    TPU_GROUPS_PER_BATCH,
    WARP_SIZE,
    WARPS_PER_BATCH,
    WORKGROUP_SIZE,
)
from ..kernels.build import I, L, P, Kernel, check_cuda, load
from ..u32 import MASK32, widen

G = TPU_GROUPS_PER_BATCH  # 8
LANES = 128
PTS = POINTS_PER_THREAD  # 64

DECODE_HUFFMAN = Kernel("pcr_decode_huffman", [P, L, P, P, P, L, P, P, P, P, P, P, I, I])


def _gather(arr, idx):
    """arr[idx] with every index clipped into arr (`jnp.take(mode="clip")`)."""
    return arr[torch.clamp(idx, 0, arr.numel() - 1)]


def decode_ref_plain(encoding, enc_offsets, cluster_sizes, separate, sep_offsets,
                     separate_sizes, table_values, table_cw_len, start_values,
                     points: int = PTS):
    """Pure-torch mirror of `decode_batches_core` on any device.

    encoding (E,) int32 (u32 bits, flat), enc_offsets (B,) i32,
    cluster_sizes (B, 32) i32 inclusive word counts, separate (S,) i32,
    sep_offsets (B,) i32, separate_sizes (B, 1024) i32 inclusive counts,
    table_values / table_cw_len (B, 4096) i32, start_values (B, 1024, 3)
    i32 -> (B, points, 3, 8, 128) i32 absolute coords.  Coordinate sums
    wrap mod 2**32 like the reference's int32.
    """
    B = enc_offsets.shape[0]
    dev = encoding.device
    i64 = dict(dtype=torch.int64, device=dev)
    enc = torch.cat([widen(encoding.reshape(-1)), torch.zeros(2 * WARP_SIZE, **i64)])
    sep = separate.reshape(-1).to(torch.int64)
    sep = torch.cat([sep, torch.zeros(1, **i64)]) if sep.numel() else torch.zeros(1, **i64)
    tv = table_values.reshape(-1).to(torch.int64)
    tl = table_cw_len.reshape(-1).to(torch.int64)

    lane = torch.arange(WORKGROUP_SIZE, device=dev)
    zero_col = torch.zeros((B, 1), **i64)
    warp_prev = torch.cat([zero_col, cluster_sizes[:, :-1].to(torch.int64)], 1)
    base = enc_offsets[:, None].to(torch.int64) + warp_prev[:, lane // WARP_SIZE]
    lane_in_warp = lane % WARP_SIZE
    cur = _gather(enc, base + lane_in_warp)
    nxt = _gather(enc, base + WARP_SIZE + lane_in_warp)
    cur_bits = torch.full((B, WORKGROUP_SIZE), 32, **i64)
    already = torch.full((B, WARPS_PER_BATCH), 2 * WARP_SIZE, **i64)
    sep_prev = torch.cat([zero_col, separate_sizes[:, :-1].to(torch.int64)], 1)
    sep_ptr = sep_offsets[:, None].to(torch.int64) + sep_prev
    tab_base = (torch.arange(B, device=dev) * table_values.shape[1])[:, None]
    shape3 = (B, WARPS_PER_BATCH, WARP_SIZE)

    prev = start_values.to(torch.int64).permute(0, 2, 1)  # (B, 3, 1024)
    out = []
    for _ in range(points):
        deltas = []
        for _k in range(3):
            full = cur_bits == 32
            cb = torch.clamp(cur_bits, 1, 31)  # shift-safe
            left = torch.where(full, cur, (cur << (32 - cb)) & MASK32)
            right = torch.where(full, torch.zeros_like(nxt), nxt >> cb)
            tidx = tab_base + ((left | right) >> (32 - MAX_CW_LEN))
            slen = _gather(tl, tidx)
            lit = slen > 0
            sym = torch.where(lit, _gather(tv, tidx), _gather(sep, sep_ptr))
            sep_ptr = sep_ptr + (~lit)
            cur_bits = cur_bits - slen.abs()

            need = cur_bits <= 0
            per_warp = need.reshape(shape3).to(torch.int64)
            offs = torch.cumsum(per_warp, 2) - per_warp  # exclusive prefix
            ridx = (base.reshape(shape3) + already[:, :, None] + offs).reshape(B, -1)
            refill = _gather(enc, ridx)
            cur = torch.where(need, nxt, cur)
            nxt = torch.where(need, refill, nxt)
            cur_bits = torch.where(need, cur_bits + 32, cur_bits)
            already = already + per_warp.sum(2)
            deltas.append(sym)
        prev = prev + torch.stack(deltas, 1)
        out.append(prev)
    coords = torch.stack(out, 1)  # (B, points, 3, 1024)
    return coords.to(torch.int32).reshape(B, points, 3, G, LANES)  # wraps mod 2**32


def decode_ref_batches(encoding, enc_offsets, cluster_sizes, separate, sep_offsets,
                       separate_sizes, table_values, table_cw_len, start_values,
                       points: int = PTS):
    """B12: the arguments and output of `decode_ref_plain`.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    `encoding` and `separate` are the whole flat buffers; the per-batch
    arrays are the rows of the batches to decode.  The kernel loads each
    table row with 16-byte loads, so the tables must start 16-byte
    aligned.  It stages each warp's words and escapes in shared memory
    with bulk copies of whole 16-byte blocks of the buffers (rounded
    outwards from the warp's run, inside the buffer); every index outside
    what it staged reads device memory with the clip above, so the
    output never depends on the staging or the buffers' alignment.
    """
    if not encoding.is_cuda:
        return decode_ref_plain(encoding, enc_offsets, cluster_sizes, separate,
                                sep_offsets, separate_sizes, table_values,
                                table_cw_len, start_values, points)
    if not 0 < points <= PTS:
        raise ValueError(f"points must be in 1..{PTS}, got {points}")
    B = enc_offsets.shape[0]
    T = HUFFMAN_TABLE_SIZE
    check_cuda("encoding", encoding, torch.int32, (encoding.numel(),))
    check_cuda("enc_offsets", enc_offsets, torch.int32, (B,))
    check_cuda("cluster_sizes", cluster_sizes, torch.int32, (B, WARPS_PER_BATCH))
    check_cuda("separate", separate, torch.int32, (separate.numel(),))
    check_cuda("sep_offsets", sep_offsets, torch.int32, (B,))
    check_cuda("separate_sizes", separate_sizes, torch.int32, (B, WORKGROUP_SIZE))
    check_cuda("table_values", table_values, torch.int32, (B, T))
    check_cuda("table_cw_len", table_cw_len, torch.int32, (B, T))
    check_cuda("start_values", start_values, torch.int32, (B, WORKGROUP_SIZE, 3))
    if table_values.data_ptr() % 16 or table_cw_len.data_ptr() % 16:
        raise ValueError("the tables must start 16-byte aligned")
    out = torch.empty((B, points, 3, G, LANES), dtype=torch.int32,
                      device=encoding.device)
    if B:
        DECODE_HUFFMAN.launch(
            encoding.data_ptr(), encoding.numel(), enc_offsets.data_ptr(),
            cluster_sizes.data_ptr(), separate.data_ptr(), separate.numel(),
            sep_offsets.data_ptr(), separate_sizes.data_ptr(),
            table_values.data_ptr(), table_cw_len.data_ptr(),
            start_values.data_ptr(), out.data_ptr(), B, points)
    return out


def kernel_resources() -> dict:
    """The kernel's resources on the card: registers per thread, shared
    bytes per block, blocks resident per SM (the occupancy API), threads
    per block, blocks per batch and the escapes a warp stages at most."""
    vals = (ctypes.c_int * 6)()
    fn = load().pcr_decode_huffman_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    err = fn(ctypes.addressof(vals))
    if err != 0:
        raise RuntimeError(f"pcr_decode_huffman_info: CUDA error {err}")
    keys = ("registers", "shared_bytes", "blocks_per_sm", "threads", "blocks_per_batch",
            "escape_cap")
    return dict(zip(keys, vals))
