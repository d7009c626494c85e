#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`pcrhpg24_tpu_torch`).

Run from the repo root on a host with one NVIDIA H100:

    python3 chip_smoke.py [--batches 256]

Phases, each of which exits non-zero on failure:
 1. environment: card name and power limit, torch, CUDA, nvcc;
 2. build: every kernel (B1-B5) from `csrc/` with one nvcc per source,
    all started together, then one link;
 3. scenes: bench.py's synthetic terrain (`--batches` x 65,536 points,
    cached under out/) written by the port's own preprocessor twice, as
    `.tpc` v2 (fbatch) and as `.tpc` v1 (tbatch), loaded onto the card;
 4. kernel gates, each kernel bit-exact against its plain torch version
    on the card: B1 (and the NumPy protocol mirror) and B5 (and its
    NumPy mirror) at points 64 and 32; B2 and B3 for bench.py's three
    views in colour and HQS modes; B4 on the orbit view's uncollapsed
    streams of every live chunk.  Each kernel is also held against its
    plain version run on the CPU (4 batches of B1/B5, the orbit chunk of
    B2/B3, one orbit chunk of B4), the path the CPU tests hold to the
    JAX reference;
 5. main paths through `pcrhpg24_tpu_torch.app` at 1920x1080, each view
    2 warm + 10 timed frames, with every kernel's launch count reset
    just before and read just after: `huffman_tpu` on v2 (B1, B2, B3),
    `huffman_tpu_hqs` on v2 (B1, B2, B3, B4) and `huffman_tpu` on v1
    (B5, B2, B3).  Each listed kernel must have launched, and each image
    must show points and equal, bit for bit, the frame built from the
    plain torch versions alone;
 6. times: median device frame (CUDA events), visible points/s, and
    each kernel beside its plain version, its bound and, where one
    PyTorch call computes the same function, that call, at the frame's
    shapes (one orbit chunk).
The last lines are the card line, a JSON object of the kernels and
`{"ok": true, "device": {...}}`.  Nothing of jax or of the JAX package
is imported.
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
DEVICE = "cuda"
W, H = 1920, 1080
WARMUP, FRAMES = 2, 10
KERNEL_REPS, PLAIN_REPS = 20, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
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
    "pcr_hqs_sums": ("B4 HQS blend sums", "pcrhpg24_tpu_torch/csrc/hqs.cu",
                     "pcrhpg24_tpu/render/pallas_hqs.py:185"),
    "pcr_decode_native": ("B5 tbatch decode", "pcrhpg24_tpu_torch/csrc/decode_native.cu",
                          "pcrhpg24_tpu/render/pallas_decode.py:55"),
}
# main paths: (label, method, scene version, kernels it must launch)
MAIN_PATHS = [
    ("colour v2", "huffman_tpu", 2, ("pcr_decode_fixed", "pcr_project", "pcr_u64_min")),
    ("hqs v2", "huffman_tpu_hqs", 2,
     ("pcr_decode_fixed", "pcr_project", "pcr_u64_min", "pcr_hqs_sums")),
    ("colour v1", "huffman_tpu", 1, ("pcr_decode_native", "pcr_project", "pcr_u64_min")),
]
OWNER = {"pcr_decode_fixed": "colour v2", "pcr_project": "colour v2",
         "pcr_u64_min": "colour v2", "pcr_hqs_sums": "hqs v2",
         "pcr_decode_native": "colour v1"}  # the path whose orbit launches are reported


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def build_scenes(base: str, batches: int) -> float:
    """bench.py's generator (bench.py:86-102), written by the port's
    preprocessor as `<base>_v2.tpc` and `<base>_v1.tpc`; -> seconds."""
    from pcrhpg24_tpu_torch.formats.las import write_las
    from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu_torch.utils.synthetic import cloud_to_grid, terrain_cloud

    todo = [(v, codec) for v, codec in ((2, "fixed"), (1, "huffman"))
            if not os.path.exists(f"{base}_v{v}.tpc")]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    xyz, rgb = terrain_cloud(batches * 65536, seed=1, extent=2000.0)
    grid = cloud_to_grid(xyz, scale=(0.001, 0.001, 0.001))
    del xyz
    las = base + ".las"
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    del grid, rgb
    for v, codec in todo:
        out = f"{base}_v{v}.tpc"
        preprocess_las_tpc(las, out + ".tmp", sort=True, verbose=False, codec=codec)
        os.replace(out + ".tmp", out)
    os.remove(las)
    return time.perf_counter() - t0


def view_args(method, renderer, view: dict, lod: float) -> dict:
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.renderer import Setting

    Debug.lod = lod
    renderer.apply_setting(Setting(**view))
    renderer.controls_update()
    return method.frame_args(renderer)


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
    from pcrhpg24_tpu_torch import app
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.method import Runtime
    from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
    from pcrhpg24_tpu_torch.engine.renderer import Renderer
    from pcrhpg24_tpu_torch.formats.native_file import decode_tpc_batch_coords, read_tpc_batch
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.camera import frame_setup_device
    from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_batches, decode_fixed_plain
    from pcrhpg24_tpu_torch.render.decode_tbatch import (
        decode_native_batches, decode_native_plain)
    from pcrhpg24_tpu_torch.render.hqs import hqs_sums, hqs_sums_plain
    from pcrhpg24_tpu_torch.render.methods.huffman_tpu import (
        CHUNK, HuffmanTpu, frame_streams, render_frame_native)
    from pcrhpg24_tpu_torch.render.methods.huffman_tpu_hqs import hqs_frame_native
    from pcrhpg24_tpu_torch.render.project import project_batches, project_plain
    from pcrhpg24_tpu_torch.render.raster import (
        BACKGROUND, swizzle_dims, u64_min_planes, u64_min_planes_plain)
    from pcrhpg24_tpu_torch.u32 import INT64_MAX, biased_key, widen

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
    print(f"[build] {os.path.relpath(lib, REPO)} from {len(build.sources())} sources "
          f"in csrc/ for sm_90a (one nvcc each, in parallel): {build_s:.2f} s")
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")
        elif "spill" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. scenes ----
    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    base = os.path.join(REPO, "out", f"chip_smoke_{args.batches}")
    scenes = {v: f"{base}_v{v}.tpc" for v in (2, 1)}
    gen_s = build_scenes(base, args.batches)
    data = {}
    for v, path in scenes.items():
        t0 = time.perf_counter()
        data[v] = NativeLasData.create(path, DEVICE).wait_loaded()
        torch.cuda.synchronize()
        check(data[v].version == v, f"{path} is not .tpc v{v}")
        print(f"[scene] v{v}: {path} {data[v].num_batches} batches, "
              f"{data[v].num_points:,} points, {os.path.getsize(path):,} B on disk; "
              f"loaded in {time.perf_counter() - t0:.1f} s; "
              f"{nbytes(*data[v].dev.values()):,} B resident on the card")
    print(f"[scene] both generated in {gen_s:.1f} s (0 = cached); allocated "
          f"{torch.cuda.memory_allocated():,} B")

    # ---- 4. kernel gates ----
    errs = {k: 0 for k in KERNEL_INFO}
    sl = slice(0, CHUNK)
    d2, d1 = data[2].dev, data[1].dev
    fixed_in = [d2[k][sl] for k in ("widths", "streams", "ptrs", "starts")]
    native_in = [d1[k][sl] for k in ("lj", "streams", "ptrs", "dD", "lut", "starts")]
    # the chunk's batches as the file holds them: the NumPy mirror's input,
    # and the stream words the decoders must read (for their bound)
    chunk_batches = {v: [read_tpc_batch(scenes[v], data[v].header, b)[0]
                         for b in range(min(data[v].num_batches, CHUNK))] for v in scenes}
    stream_bytes = {v: sum(np.asarray(s).nbytes for fb in fbs for s in fb.streams)
                    for v, fbs in chunk_batches.items()}
    for sym, kernel, plain, inputs, v in (
            ("pcr_decode_fixed", decode_fixed_batches, decode_fixed_plain, fixed_in, 2),
            ("pcr_decode_native", decode_native_batches, decode_native_plain, native_in, 1)):
        for pts in (64, 32):
            got = kernel(*inputs, points=pts)
            want = plain(*inputs, points=pts)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"{sym} != plain at points={pts} (max err {e})")
            errs[sym] = max(errs[sym], e)
            # the card's kernel against the plain version run on the CPU, the
            # path tests/test_torch_*.py hold to the JAX reference
            cpu = plain(*(x[:4].cpu() for x in inputs), points=pts)
            check(torch.equal(got[:4].cpu(), cpu),
                  f"{sym} on the card != CPU plain at points={pts}")
            for b in (0, len(chunk_batches[v]) - 1):
                mirror = decode_tpc_batch_coords(chunk_batches[v][b]).reshape(
                    8, 128, 64, 3)[:, :, :pts]
                mine = got[b].permute(2, 3, 0, 1).cpu().numpy()
                check(np.array_equal(mine, mirror),
                      f"{sym} != NumPy mirror on batch {b} at points={pts}")
        print(f"[gate] {KERNEL_INFO[sym][0]}: bit-exact vs its plain version "
              f"(64 batches), the plain version on the CPU (4 batches) and the "
              f"NumPy mirror (2 batches) at points 64 and 32")

    r = Renderer(W, H, DEVICE)
    m = HuffmanTpu(r, data[2])
    size = swizzle_dims(W, H)[2]
    shapes = {}
    for name, view in VIEWS.items():
        for lod in (1.0, 0.1):  # 0.1: the app's default LOD, buckets < 64
            a = view_args(m, r, view, lod)
            fpar = a["frame_params"]
            lod_n = torch.clamp(frame_setup_device(
                fpar[0:16].reshape(4, 4), fpar[16:22], d2["bbox_min"], d2["bbox_max"],
                fpar[23].to(torch.int32), W, H, fpar[22], True), max=a["points"])
            per_chunk = lod_n[: a["nchunks"] * CHUNK].reshape(-1, CHUNK).sum(1)
            c = int(per_chunk.argmax())  # the most populated chunk
            cs = slice(c * CHUNK, (c + 1) * CHUNK)
            t = fpar[24:40].reshape(4, 4)
            frame12 = torch.cat([t[0, :3], t[1, :3], t[3, :3], a["scale"]])
            coords = decode_fixed_batches(*(d2[k][cs] for k in
                                            ("widths", "streams", "ptrs", "starts")),
                                          points=a["points"])
            pargs = (coords, d2["colors_k"][cs], d2["anchor"][cs], a["tb"][cs],
                     lod_n[cs], frame12, W, H)
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
                shapes = dict(decode=(fixed_in, a["points"]), project=(pargs, a["points"]),
                              stream=stream)
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

    # B4 on the orbit view's uncollapsed streams of every live chunk
    a = view_args(m, r, VIEWS["orbit"], 1.0)
    parts, size, _dev = frame_streams(**a, collapse=False)
    fb_d, _fb_p = u64_min_planes(parts, size)
    got = hqs_sums(parts, fb_d, size)
    want = hqs_sums_plain(parts, fb_d, size)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        e = max_abs_err(g, p)
        check(e == 0, f"B4 != plain (orbit, err {e})")
        errs["pcr_hqs_sums"] = max(errs["pcr_hqs_sums"], e)
    accepted = int(widen(got[3]).sum())
    entries = sum(int((p[0] < size).sum()) for p in parts)
    print(f"[gate] orbit lod 1.0 HQS: B4 bit-exact vs hqs_sums_plain over "
          f"{len(parts)} live chunks ({entries:,} live entries, {accepted:,} "
          f"accepted)")
    one = hqs_sums([parts[0]], fb_d, size)
    cpu = hqs_sums_plain([tuple(x.cpu() for x in parts[0])], fb_d.cpu(), size)
    for g, p in zip(one, cpu):
        check(torch.equal(g.cpu(), p), "B4 on the card != CPU plain")
    print("[gate] orbit: B4 planes of one chunk from the card equal the plain "
          "version run on the CPU")
    shapes["hqs"] = ([parts[0]], fb_d)
    del parts, got, want, one, cpu
    Debug.lod = 1.0

    # ---- 5. main paths through the app ----
    results = {}
    for label, method_name, v, must in MAIN_PATHS:
        for name, view in VIEWS.items():
            argv = ["--scene", scenes[v], "--method", method_name, "--device", DEVICE,
                    "--width", str(W), "--height", str(H), "--lod", "1.0",
                    "--yaw", str(view["yaw"]), "--pitch", str(view["pitch"]),
                    "--radius", str(view["radius"]),
                    "--target", *map(str, view["target"]),
                    "--frames", str(WARMUP + FRAMES)]
            if name == "orbit":
                shot = f"chip_smoke_{method_name}_v{v}_orbit.png"
                argv += ["--screenshot", os.path.join(REPO, "out", shot)]
            for k in build.KERNELS.values():
                k.launches = 0
            rr = app.run(argv)
            launches = {s: k.launches for s, k in build.KERNELS.items()}
            for s in must:
                check(launches[s] > 0, f"{s} never launched on the main path "
                                       f"({label}, {name})")
            img = rr.last_image
            check(img is not None and tuple(img.shape) == (H, W), f"no {H}x{W} image")
            shown = int((img != BACKGROUND).sum())
            check(shown > 0, f"{label} {name}: the image is all background")
            method = Runtime.selected
            fa = method.frame_args(rr)
            if method_name == "huffman_tpu_hqs":
                *_planes, img_plain = hqs_frame_native(**fa, plain=True)
            else:
                _fb, img_plain = render_frame_native(**fa, plain=True)
            torch.cuda.synchronize()
            e = max_abs_err(img, img_plain)
            check(e == 0, f"{label} {name}: main-path image != all-plain frame "
                          f"(err {e})")
            _, lod_full = method.frame_setup(rr)
            visible = int(lod_full.astype(np.int64).sum() * 1024)
            ms = statistics.median(rr.frame_ms[WARMUP:])
            results[(label, name)] = dict(
                frame_ms=ms, visible=visible, shown=shown, launches=launches,
                frames=len(rr.frame_ms[WARMUP:]))
            print(f"[main] {label} ({method_name}, .tpc v{v}) {name}: {shown:,} pixels "
                  f"shown, image bit-exact vs the all-plain frame; launches "
                  f"{ {s: launches[s] for s in must} }")
            method.las.unload()
            del rr, method, img, img_plain
            Runtime.clear()
            torch.cuda.empty_cache()

    # ---- 6. times: kernels at the frame's shapes (one orbit chunk) ----
    dargs, dpts = shapes["decode"]
    pargs, ppts = shapes["project"]
    stream = shapes["stream"]
    hparts, hfb = shapes["hqs"]
    n = stream[0].numel()
    hn = hparts[0][0].numel()
    # the one PyTorch call that computes B3's planes: scatter_reduce amin
    pid64 = widen(stream[0].reshape(-1))
    idx3 = torch.where(pid64 < size, pid64, torch.full_like(pid64, size))
    keys = biased_key(stream[1].reshape(-1), stream[2].reshape(-1))
    plane3 = torch.full((size + 1,), INT64_MAX, dtype=torch.int64, device=DEVICE)
    # and B4's: index_add of the accepted (r, g, b, 1) rows
    hp, hd, hy = (x.reshape(-1) for x in hparts[0])
    q = widen(hp)
    w = hd.view(torch.float32)
    old = hfb.view(torch.float32)[torch.clamp(q, max=size - 1)]
    acc4 = (q < size) & (w <= old * torch.tensor(1.01, dtype=torch.float32, device=DEVICE))
    idx4 = torch.where(acc4, q, torch.full_like(q, size))
    y = widen(hy)
    vals4 = torch.stack([y & 255, (y >> 8) & 255, (y >> 16) & 255,
                         torch.ones_like(y)], 1).to(torch.int32)
    plane4 = torch.zeros((size + 1, 4), dtype=torch.int32, device=DEVICE)
    timed = {
        "pcr_decode_fixed": (lambda: decode_fixed_batches(*dargs, points=dpts),
                             lambda: decode_fixed_plain(*dargs, points=dpts), None),
        "pcr_project": (lambda: project_batches(*pargs, points=ppts),
                        lambda: project_plain(*pargs, points=ppts), None),
        "pcr_u64_min": (lambda: u64_min_planes([stream], size),
                        lambda: u64_min_planes_plain([stream], size),
                        lambda: plane3.scatter_reduce_(0, idx3, keys, reduce="amin")),
        "pcr_hqs_sums": (lambda: hqs_sums(hparts, hfb, size),
                         lambda: hqs_sums_plain(hparts, hfb, size),
                         lambda: plane4.index_add_(0, idx4, vals4)),
        "pcr_decode_native": (lambda: decode_native_batches(*native_in, points=64),
                              lambda: decode_native_plain(*native_in, points=64), None),
    }
    # least bytes each function must move (inputs read once, outputs
    # written once), at the timed shapes; the decoders read each batch's
    # own stream words, not the padding of the device rows
    coords_b = nbytes(pargs[0])
    fixed_tables = [x for i, x in enumerate(dargs) if i != 1]  # all but streams
    native_tables = [x for i, x in enumerate(native_in) if i != 1]
    bound_bytes = {
        "pcr_decode_fixed": (nbytes(*fixed_tables) + stream_bytes[2]
                             + CHUNK * dpts * 3 * 1024 * 4),
        "pcr_project": nbytes(*pargs[:6]) + coords_b,  # 3 u32 outputs per entry
        "pcr_u64_min": nbytes(*stream) + 8 * size,
        "pcr_hqs_sums": nbytes(*hparts[0], hfb) + 16 * size,
        "pcr_decode_native": (nbytes(*native_tables) + stream_bytes[1]
                              + CHUNK * 64 * 3 * 1024 * 4),
    }
    # f32 work of B2's projection: 3 scale, 3 x (3 mul + 3 add), 1 div,
    # 2 ndc mul, 2 x (mul, add, mul) pixel maps per entry
    bound_ops = {"pcr_project": 32 * n}
    kernels = []
    for s, (kern, plain, library) in timed.items():
        k_ms = time_ms(kern, KERNEL_REPS)
        p_ms = time_ms(plain, PLAIN_REPS)
        lib_ms = time_ms(library, KERNEL_REPS) if library else None
        t_bytes = bound_bytes[s] / HBM_BYTES_PER_S * 1e3
        t_ops = bound_ops.get(s, 0) / F32_OPS_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
        kernels.append(dict(
            name=KERNEL_INFO[s][0], route="cuda", source=KERNEL_INFO[s][1],
            replaces=KERNEL_INFO[s][2],
            launches=results[(OWNER[s], "orbit")]["launches"][s],
            max_abs_err=errs[s], ms=round(k_ms, 4), plain_ms=round(p_ms, 4),
            bound_ms=round(bound_ms, 4), bound_by=bound_by,
            library_ms=None if lib_ms is None else round(lib_ms, 4)))
        print(f"[time] {KERNEL_INFO[s][0]}: kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {bound_bytes[s]:,} B), library "
              f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'} (one orbit chunk, "
              f"{n if s != 'pcr_hqs_sums' else hn:,} stream entries) [{card}]")
    for (label, name), res in results.items():
        print(f"[time] {label} {name}: device frame {res['frame_ms']:.3f} ms median of "
              f"{res['frames']} (CUDA events), {res['visible']:,} visible points, "
              f"{res['visible'] / res['frame_ms'] / 1e6:.3f} Gpoints/s "
              f"@{W}x{H}, {args.batches} batches [{card}]")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)  # as nvidia-smi prints name and power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
