"""ctypes bindings for the port's native codec core (`codec_core.cpp`).

The port's copy of the two encoder entry points of
`pcrhpg24_tpu/native/__init__.py` that the `.tpc` codecs call.  The
library is built with g++ at first use into
`build/codec_core/<source hash>/` under the checkout (never beside the
source); without a compiler the codecs take their NumPy paths, which
write the same bytes.
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
