"""tbatch (`.tpc` v1) geometry decode: kernel B5 and its plain version.

Counterpart of `pcrhpg24_tpu/render/pallas_decode.py` (the kernel and
its host packing) and `native_decode_xla.decode_native_xla` (the plain
decoder).  The canonical bucket-Huffman protocol is codec/native.py's:
per symbol, an 11-step compare ladder against the batch's length limits
gives the code length L, a 128-entry LUT maps the symbol index to its
bucket, `bucket - 1` raw extra bits follow, and each of the two
consumes ends with a refill round at the host-precomputed pointer
`ptrs[b, t, g]`.  The CUDA kernel (`csrc/decode_native.cu`) replaces
`_decode_kernel_impl` and reads L and the bucket from one table lookup
per symbol (`code_table_plain`); `decode_native_plain` mirrors the XLA
decoder op for op on int64 words.  Output layout (B, points, 3, 8, 128)
int32, as B1's, so B2 takes it unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import POINTS_PER_THREAD, TPU_GROUPS_PER_BATCH, TPU_MAX_CODE_LEN
from ..kernels.build import I, P, Kernel, check_cuda
from ..u32 import MASK32, widen

G = TPU_GROUPS_PER_BATCH  # 8
LANES = 128
MAXL = TPU_MAX_CODE_LEN  # 12
PTS = POINTS_PER_THREAD  # 64
ROUNDS = 6 * PTS  # 3 components x (code round + extra round) per point

DECODE_NATIVE = Kernel("pcr_decode_native", [P, P, P, P, P, P, I, I, I])


def pack_native_batches(batches, maxw: int | None = None):
    """[NativeBatch] -> dict of kernel input arrays (NumPy), as
    `pallas_decode.pack_native_batches`: lj (B,1,32) i32 (length limits
    at [0:12], dD deltas at [16:27], dD[1] at [28]), streams (B,8,maxw)
    u32, ptrs (B,384,8) i32, dD (B,1,128) i32, lut (B,1,128) i32, starts
    (B,3,8,128) i32.  `maxw` defaults to the widest group stream rounded
    up to whole 128-word tiles plus two tiles, so that a refill read at
    `ptr + rank` stays inside the row."""
    B = len(batches)
    if maxw is None:
        maxw = max(max(len(s) for s in nb.streams) for nb in batches)
        maxw = ((maxw + LANES - 1) // LANES + 1) * LANES + LANES
    lj = np.zeros((B, 1, 32), np.int32)
    streams = np.zeros((B, G, maxw), np.uint32)
    ptrs = np.zeros((B, 384, G), np.int32)
    dD = np.zeros((B, 1, 128), np.int32)
    lut = np.zeros((B, 1, 128), np.int32)
    starts = np.zeros((B, 3, G, LANES), np.int32)

    for i, nb in enumerate(batches):
        lj_limit, base_idx, first_code = nb.code.decode_tables()
        lj[i, 0, :MAXL] = lj_limit
        dDv = base_idx - first_code  # dD[L] for L = 1..12 at index L-1
        lj[i, 0, 28] = dDv[0]
        lj[i, 0, 16 : 16 + MAXL - 1] = np.diff(dDv)
        dD[i, 0, 1 : MAXL + 1] = dDv
        lut[i, 0, : len(nb.code.symbols)] = nb.code.symbols
        for g in range(G):
            s = nb.streams[g]
            streams[i, g, : len(s)] = s
        ptrs[i] = nb.round_ptrs if nb.round_ptrs is not None else compute_round_ptrs(nb)
        sv = nb.start_values.reshape(G, LANES, 3)
        starts[i] = np.transpose(sv, (2, 0, 1))
    return dict(lj=lj, streams=streams, ptrs=ptrs, dD=dD, lut=lut, starts=starts)


def compute_round_ptrs(nb) -> np.ndarray:
    """(384, 8) i32: window base pointer per round per group, recovered
    by decoding each group stream once on the host."""
    ptrs = np.zeros((384, G), np.int32)
    for g in range(G):
        ptrs[:, g] = _round_ptrs_from_stream(nb.streams[g], nb.code)
    return ptrs


def _round_ptrs_from_stream(stream, code) -> np.ndarray:
    """Decode one group stream to extract its per-round window pointers
    (cumulative consumed words); the extras' values are never needed,
    only their bit counts."""
    lj_limit, base_idx, first_code = code.decode_tables()
    lut = code.symbols
    s = np.concatenate([stream.astype(np.uint64), np.zeros(2 * LANES, np.uint64)])
    cur = s[np.arange(LANES)].copy()
    nxt = s[LANES + np.arange(LANES)].copy()
    bitpos = np.zeros(LANES, np.int64)
    already = 2 * LANES
    out = np.zeros(ROUNDS, np.int32)

    def peek(n):
        w64 = (cur << np.uint64(32)) | nxt
        sh = (64 - bitpos - n).astype(np.uint64)
        return (w64 >> sh) & ((np.uint64(1) << n.astype(np.uint64)) - np.uint64(1))

    t = 0
    for _i in range(3 * PTS):
        win = peek(np.full(LANES, MAXL, np.int64)).astype(np.int64)
        L = 1 + np.sum(win[:, None] >= lj_limit[None, :-1], axis=1)
        sym_idx = base_idx[L - 1] + (win >> (MAXL - L)) - first_code[L - 1]
        bucket = lut[sym_idx]
        for consumed in (L, np.maximum(bucket - 1, 0)):
            bitpos += consumed
            need = bitpos >= 32
            bitpos = np.where(need, bitpos - 32, bitpos)
            out[t] = already
            rank = np.cumsum(need) - need
            w = s[np.minimum(already + rank, len(s) - 1)]
            cur[:] = np.where(need, nxt, cur)
            nxt[:] = np.where(need, w, nxt)
            already += int(need.sum())
            t += 1
    return out


def _window_hi(cur, nxt, bitpos):
    """Top 32 bits of the bit window starting at bitpos (int64 words)."""
    hi = (cur << bitpos) & MASK32
    lo = nxt >> torch.clamp(32 - bitpos, max=31)
    return hi | torch.where(bitpos > 0, lo, torch.zeros_like(lo))


def decode_native_plain(lj, streams, ptrs, dD, lut, starts, points: int = PTS):
    """Pure-torch mirror of `decode_native_xla` on any device.

    lj (B,1,32) i32, streams (B,8,maxw) i32 (u32 bits), ptrs (B,384,8)
    i32, dD (B,1,128) i32, lut (B,1,128) i32, starts (B,3,8,128) i32 ->
    (B, points, 3, 8, 128) i32 absolute coords.  Words are widened to
    int64 so that shifts are logical; coordinate sums wrap mod 2**32
    like the reference's int32.
    """
    B, _, maxw = streams.shape
    dev = streams.device
    flat = widen(streams).reshape(-1)
    cur = widen(streams[:, :, 0:LANES])
    nxt = widen(streams[:, :, LANES:2 * LANES])
    bitpos = torch.zeros((B, G, LANES), dtype=torch.int64, device=dev)
    dD_flat = dD.reshape(B, 128).to(torch.int64)
    lut_flat = lut.reshape(B, 128).to(torch.int64)
    limits = lj[:, 0].to(torch.int64)
    row = ((torch.arange(B, device=dev)[:, None] * G
            + torch.arange(G, device=dev)[None, :]) * maxw)[:, :, None]
    ptrs64 = ptrs.to(torch.int64)

    def refill(t, cur, nxt, bitpos):
        need = bitpos >= 32
        bitpos = torch.where(need, bitpos - 32, bitpos)
        n = need.to(torch.int64)
        rank = torch.cumsum(n, dim=2) - n
        idx = row + ptrs64[:, t, :, None] + rank
        val = flat[torch.clamp(idx, 0, flat.numel() - 1)]
        return torch.where(need, nxt, cur), torch.where(need, val, nxt), bitpos

    def decode_symbol(t, cur, nxt, bitpos):
        win12 = _window_hi(cur, nxt, bitpos) >> (32 - MAXL)
        L = torch.ones_like(win12)
        for j in range(1, MAXL):
            L = L + (win12 >= limits[:, j - 1, None, None]).to(torch.int64)
        code_L = win12 >> torch.clamp(MAXL - L, max=MAXL)
        dd = torch.gather(dD_flat, 1, L.reshape(B, -1)).reshape(L.shape)
        sym_idx = torch.clamp(code_L + dd, 0, 127)
        bucket = torch.gather(lut_flat, 1, sym_idx.reshape(B, -1)).reshape(L.shape)
        cur, nxt, bitpos = refill(t, cur, nxt, bitpos + L)

        e = torch.clamp(bucket - 1, min=0)
        win2 = _window_hi(cur, nxt, bitpos)
        extra = ((win2 >> (31 - e)) >> 1) & ((1 << e) - 1)
        cur, nxt, bitpos = refill(t + 1, cur, nxt, bitpos + e)

        z = torch.where(bucket == 0, torch.zeros_like(e), (1 << e) | extra)
        return (z >> 1) ^ -(z & 1), cur, nxt, bitpos

    deltas = []
    for i in range(points):
        d = []
        for c in range(3):
            dc, cur, nxt, bitpos = decode_symbol(6 * i + 2 * c, cur, nxt, bitpos)
            d.append(dc)
        deltas.append(torch.stack(d, 1))
    coords = torch.cumsum(torch.stack(deltas, 1), dim=1) + starts[:, None].to(torch.int64)
    return coords.to(torch.int32)  # wraps mod 2**32, as int32 sums do


def code_table_plain(lj, lut):
    """The (L, bucket) table B5 builds in shared memory for each block.

    lj (B,1,32) i32, lut (B,1,128) i32 -> (B, 4096) i32: entry w is
    `L | bucket << 4` for the 12-bit window w, by the kernel's ladder on
    lj's folded dD deltas (lj[16:27], dD[1] at lj[28]): L counts the
    limits at or below w, the symbol index `(w >> min(12 - L, 12)) + dD[L]`
    is clipped to [0, 127] and the LUT maps it to its bucket.
    """
    B = lj.shape[0]
    lim = lj[:, 0].to(torch.int64)
    w = torch.arange(1 << MAXL, dtype=torch.int64, device=lj.device)[None, :]
    L = torch.ones((B, 1 << MAXL), dtype=torch.int64, device=lj.device)
    dd = lim[:, 28, None].expand(B, 1 << MAXL)
    for j in range(1, MAXL):
        ge = (w >= lim[:, j - 1, None]).to(torch.int64)
        L = L + ge
        dd = dd + ge * lim[:, 16 + j - 1, None]
    sym_idx = torch.clamp((w >> torch.clamp(MAXL - L, max=MAXL)) + dd, 0, 127)
    bucket = torch.gather(lut.reshape(B, 128).to(torch.int64), 1, sym_idx)
    return (L | (bucket << 4)).to(torch.int32)


def decode_native_batches(lj, streams, ptrs, dD, lut, starts, points: int = PTS):
    """B5: the arguments and output of `decode_native_plain`.

    CUDA tensors launch the kernel (which, like the Pallas kernel, reads
    dD's values folded into `lj` and takes `dD` only for signature
    parity, and looks symbols up in `code_table_plain`'s table); CPU
    tensors take the plain version.  `points` < 64 decodes only the LOD
    prefix of every chain.  The kernel stages each stream row in shared
    memory with bulk copies, so rows must start 16-byte aligned.
    """
    if not streams.is_cuda:
        return decode_native_plain(lj, streams, ptrs, dD, lut, starts, points)
    if not 0 < points <= PTS:
        raise ValueError(f"points must be in 1..{PTS}, got {points}")
    B, maxw = streams.shape[0], streams.shape[2]
    if maxw < 2 * LANES:
        raise ValueError(f"streams rows must hold >= {2 * LANES} words")
    if maxw % 4 or streams.data_ptr() % 16:  # the kernel's bulk copies
        raise ValueError("streams rows must start 16-byte aligned (maxw % 4 == 0)")
    check_cuda("lj", lj, torch.int32, (B, 1, 32))
    check_cuda("streams", streams, torch.int32, (B, G, maxw))
    check_cuda("ptrs", ptrs, torch.int32, (B, ROUNDS, G))
    check_cuda("dD", dD, torch.int32, (B, 1, 128))
    check_cuda("lut", lut, torch.int32, (B, 1, 128))
    check_cuda("starts", starts, torch.int32, (B, 3, G, LANES))
    out = torch.empty((B, points, 3, G, LANES), dtype=torch.int32,
                      device=streams.device)
    if B:
        DECODE_NATIVE.launch(lj.data_ptr(), streams.data_ptr(), ptrs.data_ptr(),
                             lut.data_ptr(), starts.data_ptr(), out.data_ptr(),
                             B, maxw, points)
    return out
