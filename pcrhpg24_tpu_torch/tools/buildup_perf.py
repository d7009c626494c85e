"""CPU octree point-buildup strategy bench.

Port of the reference's `main_buildup_perf` executable
(src/main_buildup_perf.cpp + include/perf/*.h): how fast can the HOST
ingest LAS points into a capacity-split octree?  Strategies (C++,
native/buildup.cpp): pointwise adds, batched counting-sort partition,
batchwise multithreaded (per-top-octant locks), and morton-ordered
batched.  Off the render path — a host-side engineering bench, exactly
like upstream (it never shipped in a render method).  A copy of
`pcrhpg24_tpu/tools/buildup_perf.py`, except that g++ builds the library
into `build/buildup/<source hash>/`, never beside its source.

    python -m pcrhpg24_tpu_torch.tools.buildup_perf scene.las [--points N]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "buildup.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "buildup"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

STRATEGIES = {
    0: "pointwise",
    1: "batched",
    2: "batchwise_multithreaded",
    3: "morton_batched",
}


def build() -> Path:
    """Compile `native/buildup.cpp` with g++ into
    `build/buildup/<source hash>/` under the checkout (never beside the
    source) if this source has no build yet; -> the library's path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libbuildup.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".libbuildup.so.{os.getpid()}"
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    lib = ctypes.CDLL(str(build()))
    lib.buildup_run.restype = ctypes.c_int
    lib.buildup_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def run_strategy(lib, xyz: np.ndarray, bbox: np.ndarray, strategy: int,
                 threads: int) -> dict:
    buf = np.ascontiguousarray(xyz, np.float64).copy()  # strategies permute
    stats = np.zeros(4, np.int64)
    t0 = time.perf_counter()
    rc = lib.buildup_run(buf.ctypes.data, len(buf), bbox.ctypes.data,
                         strategy, threads, stats.ctypes.data)
    dt = time.perf_counter() - t0
    assert rc == 0, rc
    assert stats[1] == len(buf), (stats[1], len(buf))  # no point lost
    return dict(
        strategy=STRATEGIES[strategy],
        seconds=round(dt, 3),
        mpts_per_s=round(len(buf) / dt / 1e6, 2),
        nodes=int(stats[0]),
        max_depth=int(stats[2]),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("las")
    ap.add_argument("--points", type=int, default=None,
                    help="cap the point count (pointwise is slow)")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--skip-pointwise", action="store_true")
    args = ap.parse_args(argv)

    from ..formats.las import read_header, read_points

    hdr = read_header(args.las)
    n = hdr.num_points if args.points is None else min(
        args.points, hdr.num_points)
    pts = read_points(args.las, 0, n)
    xyz = np.stack([
        pts.x * hdr.scale[0] + hdr.offset[0],
        pts.y * hdr.scale[1] + hdr.offset[1],
        pts.z * hdr.scale[2] + hdr.offset[2],
    ], axis=1)
    bbox = np.concatenate([np.asarray(hdr.cmin, np.float64),
                           np.asarray(hdr.cmax, np.float64) + 1e-9])
    lib = get_lib()
    print(f"{n} points, {args.threads} threads")
    for s in STRATEGIES:
        if s == 0 and (args.skip_pointwise or n > 20_000_000):
            continue
        r = run_strategy(lib, xyz, bbox, s, args.threads)
        print(f"  {r['strategy']:26s} {r['mpts_per_s']:8.2f} Mpts/s  "
              f"({r['seconds']}s, {r['nodes']} nodes, "
              f"depth {r['max_depth']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
