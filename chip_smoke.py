#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`pcrhpg24_tpu_torch`).

Run from the repo root on a host with one NVIDIA H100:

    python3 chip_smoke.py [--batches 256]

Phases, each of which exits non-zero on failure:
 1. environment: card name and power limit, torch, CUDA, nvcc;
 2. build: every kernel of the flagship path from `csrc/` with nvcc;
 3. scene: bench.py's synthetic terrain scene (`--batches` x 65,536
    points, cached under out/), loaded onto the card;
 4. kernel gates: B1, B2 and B3 bit-exact against their plain torch
    versions on the card (B1 also against the NumPy protocol mirror),
    for bench.py's three views, colour and HQS modes;
 5. main path: `pcrhpg24_tpu_torch.app` renders each view at 1920x1080
    (2 warm + 10 timed frames) with every kernel's launch count reset
    just before; every kernel must have launched, the image must show
    points and equal, bit for bit, the all-plain-torch frame;
 6. times: median device frame (CUDA events), visible points/s, and
    each kernel beside its plain version at the frame's shapes.
The last lines are the card line, a JSON object of the kernels and
`{"ok": true, "device": {...}}`.  No jax is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
WARMUP, FRAMES = 2, 10
# bench.py:176-183
VIEWS = {
    "orbit": dict(yaw=0.5, pitch=-0.9, radius=2500.0, target=(1000.0, 1000.0, 100.0)),
    "closeup": dict(yaw=2.4, pitch=-0.25, radius=180.0, target=(1000.0, 1000.0, 60.0)),
    "oblique": dict(yaw=-1.1, pitch=-0.08, radius=1400.0, target=(1000.0, 1000.0, 40.0)),
}
KERNEL_INFO = {  # C symbol -> (name, source, TPU kernel it replaces)
    "pcr_decode_fixed": ("B1 fbatch decode", "pcrhpg24_tpu_torch/csrc/decode_fixed.cu",
                         "pcrhpg24_tpu/render/pallas_decode_fixed.py:52"),
    "pcr_project": ("B2 fused projection", "pcrhpg24_tpu_torch/csrc/project.cu",
                    "pcrhpg24_tpu/render/pallas_project.py:83"),
    "pcr_u64_min": ("B3 u64-min resolve", "pcrhpg24_tpu_torch/csrc/raster.cu",
                    "pcrhpg24_tpu/render/pallas_merge.py:467"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_abs_err(a, b) -> int:
    """Largest |a - b| over int tensors of one shape (0 when bit-exact)."""
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def time_ms(fn, reps: int) -> float:
    """Median device ms of fn() over `reps` calls, after one warm call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def build_scene(path: str, batches: int) -> float:
    """bench.py's generator (bench.py:86-102); -> seconds spent."""
    from pcrhpg24_tpu.formats.las import write_las
    from pcrhpg24_tpu.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

    if os.path.exists(path):
        return 0.0
    t0 = time.perf_counter()
    xyz, rgb = terrain_cloud(batches * 65536, seed=1, extent=2000.0)
    grid = cloud_to_grid(xyz, scale=(0.001, 0.001, 0.001))
    del xyz
    las = path + ".las"
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    del grid, rgb
    preprocess_las_tpc(las, path + ".tmp", sort=True, verbose=False)
    os.replace(path + ".tmp", path)
    os.remove(las)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=256,
                    help="scene size in 65,536-point batches (256 = 16.8M)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pcrhpg24_tpu.formats.native_file import decode_tpc_batch_coords, read_tpc_batch
    from pcrhpg24_tpu.engine.debug import Debug
    from pcrhpg24_tpu.engine.method import Runtime
    from pcrhpg24_tpu_torch import app
    from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
    from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.camera import frame_setup_device
    from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_batches, decode_fixed_plain
    from pcrhpg24_tpu_torch.render.methods.huffman_tpu import CHUNK, HuffmanTpu, render_frame_native
    from pcrhpg24_tpu_torch.render.project import project_batches, project_plain
    from pcrhpg24_tpu_torch.render.raster import (
        BACKGROUND, swizzle_dims, u64_min_planes, u64_min_planes_plain)

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[env] nvcc: {nvcc}")

    # ---- 2. build ----
    lib, build_s, log = build.build()
    build.load()
    print(f"[build] {lib.relative_to(REPO)} from {len(build.sources())} sources "
          f"in csrc/ for sm_90a: {build_s:.2f} s")
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")
        elif "spill" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. scene ----
    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    scene = os.path.join(REPO, "out", f"chip_smoke_{args.batches}.tpc")
    gen_s = build_scene(scene, args.batches)
    t0 = time.perf_counter()
    las = NativeLasData.create(scene, "cuda").wait_loaded()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resident = sum(t.numel() * t.element_size() for t in las.dev.values())
    print(f"[scene] {scene} {las.num_batches} batches, {las.num_points:,} points, "
          f"{os.path.getsize(scene):,} B on disk; generated in {gen_s:.1f} s "
          f"(0 = cached), loaded in {load_s:.1f} s; {resident:,} B resident on "
          f"the card (allocated {torch.cuda.memory_allocated():,} B)")

    # ---- 4. kernel gates ----
    Debug.lod = 1.0
    r = Renderer(W, H, "cuda")
    m = HuffmanTpu(r, las)
    errs = {k: 0 for k in KERNEL_INFO}
    shapes = {}
    d = las.dev
    for pts in (64, 32):
        sl = slice(0, CHUNK)
        got = decode_fixed_batches(d["widths"][sl], d["streams"][sl], d["ptrs"][sl],
                                   d["starts"][sl], points=pts)
        plain = decode_fixed_plain(d["widths"][sl], d["streams"][sl], d["ptrs"][sl],
                                   d["starts"][sl], points=pts)
        torch.cuda.synchronize()
        e = max_abs_err(got, plain)
        check(e == 0, f"B1 != plain at points={pts} (max err {e})")
        errs["pcr_decode_fixed"] = max(errs["pcr_decode_fixed"], e)
        for b in (0, min(las.num_batches, CHUNK) - 1):
            fb, _c = read_tpc_batch(scene, las.header, b)
            mirror = decode_tpc_batch_coords(fb).reshape(8, 128, 64, 3)[:, :, :pts]
            mine = got[b].permute(2, 3, 0, 1).cpu().numpy()
            check(np.array_equal(mine, mirror),
                  f"B1 != NumPy mirror on batch {b} at points={pts}")
    print("[gate] B1 bit-exact vs decode_fixed_plain (64 batches) and the NumPy "
          "mirror (2 batches) at points 64 and 32")

    size = swizzle_dims(W, H)[2]
    for name, view in VIEWS.items():
        for lod in (1.0, 0.1):  # 0.1: the app's default LOD, buckets < 64
            Debug.lod = lod
            r.apply_setting(Setting(**view))
            r.controls_update()
            a = m.frame_args(r)
            fpar = a["frame_params"]
            lod_n = torch.clamp(frame_setup_device(
                fpar[0:16].reshape(4, 4), fpar[16:22], d["bbox_min"], d["bbox_max"],
                fpar[23].to(torch.int32), W, H, fpar[22], True), max=a["points"])
            per_chunk = lod_n[: a["nchunks"] * CHUNK].reshape(-1, CHUNK).sum(1)
            c = int(per_chunk.argmax())  # the most populated chunk
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            t = fpar[24:40].reshape(4, 4)
            frame12 = torch.cat([t[0, :3], t[1, :3], t[3, :3], a["scale"]])
            coords = decode_fixed_batches(d["widths"][sl], d["streams"][sl],
                                          d["ptrs"][sl], d["starts"][sl],
                                          points=a["points"])
            pargs = (coords, d["colors_k"][sl], d["anchor"][sl], a["tb"][sl],
                     lod_n[sl], frame12, W, H)
            for collapse in (True, False):
                got = project_batches(*pargs, points=a["points"], collapse=collapse)
                plain = project_plain(*pargs, points=a["points"], collapse=collapse)
                torch.cuda.synchronize()
                for g, p in zip(got, plain):
                    e = max_abs_err(g, p)
                    check(e == 0, f"B2 != plain ({name}, lod {lod}, "
                                  f"collapse={collapse}, err {e})")
                    errs["pcr_project"] = max(errs["pcr_project"], e)
                if collapse:
                    stream = got
            planes = u64_min_planes([stream], size)
            plain_planes = u64_min_planes_plain([stream], size)
            torch.cuda.synchronize()
            for g, p in zip(planes, plain_planes):
                e = max_abs_err(g, p)
                check(e == 0, f"B3 != plain ({name}, lod {lod}, err {e})")
                errs["pcr_u64_min"] = max(errs["pcr_u64_min"], e)
            live = int((stream[0] < size).sum())
            print(f"[gate] {name} lod {lod}: chunk {c}, points {a['points']}: B2 "
                  f"bit-exact vs project_plain (colour + HQS), B3 bit-exact vs "
                  f"u64_min_planes_plain ({live:,} live entries)")
            if name == "orbit" and lod == 1.0:
                shapes = dict(decode=(d["widths"][sl], d["streams"][sl], d["ptrs"][sl],
                                      d["starts"][sl], a["points"]),
                              project=(pargs, a["points"]), stream=stream)
                # the card's kernels against the plain versions run on the CPU,
                # the path tests/test_torch_*.py hold to the JAX reference
                cpu = [x.cpu() if torch.is_tensor(x) else x for x in pargs]
                for g, p in zip(stream, project_plain(*cpu, points=a["points"])):
                    check(torch.equal(g.cpu(), p), "B2 on the card != CPU plain")
                for g, p in zip(planes, u64_min_planes_plain(
                        [tuple(x.cpu() for x in stream)], size)):
                    check(torch.equal(g.cpu(), p), "B3 on the card != CPU plain")
                print("[gate] orbit: B2 stream and B3 planes from the card equal "
                      "the plain versions run on the CPU")
    Debug.lod = 1.0

    # kernel vs plain times at the frame's shapes (one orbit chunk)
    dargs, dpts = shapes["decode"][:4], shapes["decode"][4]
    pargs, ppts = shapes["project"]
    parts = [shapes["stream"]]
    ktimes = {
        "pcr_decode_fixed": (time_ms(lambda: decode_fixed_batches(*dargs, points=dpts), 20),
                             time_ms(lambda: decode_fixed_plain(*dargs, points=dpts), 5)),
        "pcr_project": (time_ms(lambda: project_batches(*pargs, points=ppts), 20),
                        time_ms(lambda: project_plain(*pargs, points=ppts), 5)),
        "pcr_u64_min": (time_ms(lambda: u64_min_planes(parts, size), 20),
                        time_ms(lambda: u64_min_planes_plain(parts, size), 5)),
    }
    del m, r, las, shapes, parts, stream, coords, pargs, dargs

    # ---- 5. main path through the app ----
    results = {}
    for name, view in VIEWS.items():
        shot = os.path.join(REPO, "out", f"chip_smoke_{name}.png")
        argv = ["--scene", scene, "--method", "huffman_tpu", "--device", "cuda",
                "--width", str(W), "--height", str(H), "--lod", "1.0",
                "--yaw", str(view["yaw"]), "--pitch", str(view["pitch"]),
                "--radius", str(view["radius"]),
                "--target", *map(str, view["target"]),
                "--frames", str(WARMUP + FRAMES)]
        if name == "orbit":
            argv += ["--screenshot", shot]
        for k in build.KERNELS.values():
            k.launches = 0
        rr = app.run(argv)
        launches = {s: k.launches for s, k in build.KERNELS.items()}
        for s in KERNEL_INFO:
            check(launches[s] > 0, f"{s} never launched on the main path ({name})")
        img = rr.last_image
        check(img is not None and tuple(img.shape) == (H, W), f"no {H}x{W} image")
        shown = int((img != BACKGROUND).sum())
        check(shown > 0, f"{name}: the image is all background")
        method = Runtime.selected
        _fb, img_plain = render_frame_native(**method.frame_args(rr), plain=True)
        torch.cuda.synchronize()
        e = max_abs_err(img, img_plain)
        check(e == 0, f"{name}: main-path image != all-plain frame (err {e})")
        _, lod_full = method.frame_setup(rr)
        visible = int(lod_full.astype(np.int64).sum() * 1024)
        ms = statistics.median(rr.frame_ms[WARMUP:])
        results[name] = dict(frame_ms=ms, visible=visible, shown=shown,
                             launches=launches, frames=len(rr.frame_ms[WARMUP:]))
        print(f"[main] {name}: {shown:,} pixels shown, image bit-exact vs the "
              f"all-plain frame; launches {launches}")
        method.las.unload()
        del rr, method, img, img_plain
        Runtime.clear()
        torch.cuda.empty_cache()

    # ---- 6. times ----
    for name, res in results.items():
        print(f"[time] {name}: device frame {res['frame_ms']:.3f} ms median of "
              f"{res['frames']} (CUDA events), {res['visible']:,} visible points, "
              f"{res['visible'] / res['frame_ms'] / 1e6:.3f} Gpoints/s "
              f"@{W}x{H}, {args.batches} batches [{card}]")
    for s, (k_ms, p_ms) in ktimes.items():
        print(f"[time] {KERNEL_INFO[s][0]}: kernel {k_ms:.3f} ms vs plain "
              f"{p_ms:.3f} ms (one orbit chunk) [{card}]")
    kernels = [dict(name=KERNEL_INFO[s][0], route="cuda", source=KERNEL_INFO[s][1],
                    replaces=KERNEL_INFO[s][2],
                    launches=results["orbit"]["launches"][s], max_abs_err=errs[s],
                    ms=round(ktimes[s][0], 4), plain_ms=round(ktimes[s][1], 4))
               for s in KERNEL_INFO]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)  # as nvidia-smi prints name and power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
