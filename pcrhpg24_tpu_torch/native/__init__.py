"""ctypes bindings for the port's native codec core (`codec_core.cpp`).

The port's copy of `pcrhpg24_tpu/native/__init__.py`: the two `.tpc`
encoders, the `.huffman` encoder and decoder, and the fused `.huffman`
-> fbatch transcode of the load-time path.  The library is built with
g++ at first use into
`build/codec_core/<source hash>/` under the checkout (never beside the
source); without a compiler the codecs take their NumPy paths, which
write the same bytes (the transcode has no NumPy path: its callers
require the library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "codec_core.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "codec_core"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_lib = None


def build() -> Path:
    """Compile the library if this source has no build yet; -> its path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libcodec_core.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".libcodec_core.so.{os.getpid()}"
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    try:
        so = build()
    except (OSError, subprocess.CalledProcessError):
        return None  # no compiler: the codecs' NumPy paths
    lib = ctypes.CDLL(str(so))
    lib.encode_native_batch.restype = ctypes.c_int
    lib.encode_native_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.encode_fixed_batch.restype = ctypes.c_int
    lib.encode_fixed_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.decode_ref_batch.restype = ctypes.c_int
    lib.decode_ref_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.transcode_ref_batch.restype = ctypes.c_int
    lib.transcode_ref_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.encode_ref_batch.restype = ctypes.c_int
    lib.encode_ref_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def encode_native_batch_streams(deltas: np.ndarray, bucket_codes, bucket_lens,
                                maxw: int):
    """C++ path of codec/native.py's per-group pack + interleave.

    deltas: (1024, 192) i32.  Returns (streams list of 8 arrays,
    round_ptrs (384,8) i32) or None when maxw too small.
    """
    lib = get_lib()
    deltas = np.ascontiguousarray(deltas, np.int32)
    codes = np.zeros(33, np.uint32)
    lens = np.zeros(33, np.int32)
    codes[: len(bucket_codes)] = bucket_codes
    lens[: len(bucket_lens)] = bucket_lens
    stream = np.zeros((8, maxw), np.uint32)
    group_len = np.zeros(8, np.int32)
    ptrs = np.zeros((384, 8), np.int32)
    rc = lib.encode_native_batch(
        deltas.ctypes.data, codes.ctypes.data, lens.ctypes.data,
        stream.ctypes.data, group_len.ctypes.data, ptrs.ctypes.data,
        maxw,
    )
    if rc != 0:
        return None
    streams = [stream[g, : group_len[g]].copy() for g in range(8)]
    return streams, ptrs


def encode_ref_batch_streams(deltas: np.ndarray, sym_keys, sym_codes, sym_lens):
    """C++ path of codec/batch_codec.py's pack + warp interleave.

    Returns (encoding u32, separate i32, separate_sizes (1024,) i32,
    cluster_sizes (32,) i32)."""
    lib = get_lib()
    deltas = np.ascontiguousarray(deltas, np.int32)
    sym_keys = np.ascontiguousarray(sym_keys, np.int32)
    sym_codes = np.ascontiguousarray(sym_codes, np.uint32)
    sym_lens = np.ascontiguousarray(sym_lens, np.int32)
    cap_enc = 1024 * 192 * 2 + 4096  # 44 bits/sym absolute worst case
    cap_sep = 1024 * 192
    enc = np.zeros(cap_enc, np.uint32)
    sep = np.zeros(cap_sep, np.int32)
    sep_sizes = np.zeros(1024, np.int32)
    cluster = np.zeros(32, np.int32)
    enc_len = ctypes.c_int64()
    sep_len = ctypes.c_int64()
    rc = lib.encode_ref_batch(
        deltas.ctypes.data, sym_keys.ctypes.data, sym_codes.ctypes.data,
        sym_lens.ctypes.data, len(sym_keys), enc.ctypes.data, cap_enc,
        ctypes.byref(enc_len), sep.ctypes.data, cap_sep,
        ctypes.byref(sep_len), sep_sizes.ctypes.data, cluster.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"encode_ref_batch failed: {rc}")
    return (
        enc[: enc_len.value].copy(),
        sep[: sep_len.value].copy(),
        sep_sizes,
        cluster,
    )


def decode_ref_batch_deltas(encoding, cluster_sizes, separate, separate_sizes,
                            table_values, table_cw_len):
    """C++ decode of one reference batch -> (1024, 192) i32 deltas."""
    lib = get_lib()
    encoding = np.ascontiguousarray(encoding, np.uint32)
    cluster = np.ascontiguousarray(cluster_sizes, np.int32)
    sep = np.ascontiguousarray(separate, np.int32)
    if sep.size == 0:
        sep = np.zeros(1, np.int32)
    sepsz = np.ascontiguousarray(separate_sizes, np.int32)
    tv = np.ascontiguousarray(table_values, np.int32)
    tl = np.ascontiguousarray(table_cw_len, np.int32)
    out = np.zeros((1024, 192), np.int32)
    rc = lib.decode_ref_batch(
        encoding.ctypes.data, len(encoding), cluster.ctypes.data,
        sep.ctypes.data, sepsz.ctypes.data, tv.ctypes.data, tl.ctypes.data,
        out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"decode_ref_batch failed: {rc}")
    return out


def encode_fixed_batch_streams(deltas: np.ndarray, maxw: int):
    """C++ path of codec/fixed.py's pack + uniform-round interleave.

    deltas: (1024, 192) i32.  Returns (streams (8,nwords) u32,
    widths (1024,3) u8, round_ptrs (64,) i32) or None when maxw too
    small."""
    lib = get_lib()
    deltas = np.ascontiguousarray(deltas, np.int32)
    widths = np.zeros((1024, 3), np.uint8)
    stream = np.zeros((8, maxw), np.uint32)
    nwords = ctypes.c_int64()
    ptrs = np.zeros(64, np.int32)
    rc = lib.encode_fixed_batch(
        deltas.ctypes.data, widths.ctypes.data, stream.ctypes.data,
        ctypes.byref(nwords), ptrs.ctypes.data, maxw,
    )
    if rc != 0:
        return None
    return stream[:, : nwords.value].copy(), widths, ptrs


# The widest fbatch group stream: 64 rounds of 128 chains x 3 words (three
# 32-bit fields a point).  No batch needs more.
MAX_FIXED_GROUP_WORDS = 64 * 128 * 3
TOO_NARROW = -1  # encode_fixed_batch's rc when the stream exceeds maxw


def transcode_ref_batch(b, maxw: int = 16384):
    """Fused C++ decode + fbatch re-encode of one reference batch.

    `b` is a huffman_file batch record.  Returns (streams (8,nwords)
    u32, widths (1024,3) u8, round_ptrs (64,) i32, bbox_min_i (3,) i32,
    bbox_max_i (3,) i32) — the decoded reference deltas ARE the fixed
    codec's chain deltas (same 1024x64 chain structure), so no
    intermediate coordinate materialization happens.

    A stream wider than `maxw` words (rc TOO_NARROW) is retried with
    twice the buffer, up to MAX_FIXED_GROUP_WORDS; any other rc, or a
    stream still too wide there, raises.  (The reference doubles `maxw`
    on any nonzero rc, without bound.)
    """
    lib = get_lib()
    encoding = np.ascontiguousarray(b.encoding, np.uint32)
    cluster = np.ascontiguousarray(b.cluster_sizes, np.int32)
    sep = np.ascontiguousarray(b.separate, np.int32)
    if sep.size == 0:
        sep = np.zeros(1, np.int32)
    sepsz = np.ascontiguousarray(b.separate_sizes, np.int32)
    tv = np.ascontiguousarray(b.decoder_values, np.int32)
    tl = np.ascontiguousarray(b.decoder_cw_len, np.int32)
    sv = np.ascontiguousarray(b.start_values, np.int32)
    maxw = min(maxw, MAX_FIXED_GROUP_WORDS)
    while True:
        widths = np.zeros((1024, 3), np.uint8)
        stream = np.zeros((8, maxw), np.uint32)
        nwords = ctypes.c_int64()
        ptrs = np.zeros(64, np.int32)
        bbox = np.zeros(6, np.int32)
        rc = lib.transcode_ref_batch(
            encoding.ctypes.data, len(encoding), cluster.ctypes.data,
            sep.ctypes.data, sepsz.ctypes.data, tv.ctypes.data,
            tl.ctypes.data, sv.ctypes.data, widths.ctypes.data,
            stream.ctypes.data, ctypes.byref(nwords), ptrs.ctypes.data,
            bbox.ctypes.data, maxw,
        )
        if rc == 0:
            return (stream[:, : nwords.value].copy(), widths, ptrs,
                    bbox[:3].copy(), bbox[3:].copy())
        if rc != TOO_NARROW or maxw >= MAX_FIXED_GROUP_WORDS:
            raise RuntimeError(f"transcode_ref_batch failed: rc {rc} at "
                               f"maxw {maxw}")
        maxw = min(2 * maxw, MAX_FIXED_GROUP_WORDS)
