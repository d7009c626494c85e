"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run builds (or finds built) the port's kernels, makes the cell's scene
from the seed (on the card), writes it in the configuration's format
(named in a fresh directory under TMPDIR), loads it through the port's
resource, warms up on the cell's own frames, then renders frames back to
back for `--seconds`: a closed loop of one viewer, each frame from
before `update` to after the card has finished it
(`Renderer.loop(..., block=True)`), the camera a function of the frame
index.  With `--trace 1` the same window is run a second time under
`torch.profiler` for the per-layer metrics.  Afterwards the program's
state is freed and the plain reference renders a sample of the window's
frames, drawn from the seed; the images must agree pixel for pixel.

The last line of standard output is one JSON object (`correct`,
`attempted` frames, `failed` frames, `metrics`, `device`, with
`--trace 1` `breakdown`, and last the compared numbers with their
limits); every other line is a `[bench]` note.  Exits 1 without a result
where the card or the port is missing, and 2 if `jax` or the JAX package
got loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pcrhpg24_tpu")  # top-level module names, whole
CHUNK_POINTS = 100 * 65536  # the preprocessor's IO chunk: 100 batches
LIMIT_WRONG_PIXELS = 0  # the port's frames are exact: the reference's image, bit for bit


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into `build/torch_kernels/`)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def note(msg: str) -> None:
    print(f"[bench] {msg}", flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi(fields: str) -> str | None:
    """The card's `fields` as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def power_limit() -> str | None:
    return nvidia_smi("name,power.limit")


def card_state() -> str | None:
    """Clocks, temperature and power draw: what can make two processes'
    windows differ on one card."""
    return nvidia_smi("clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active")


class Pool:
    """`map` over worker processes (spawned, one per core), or in this
    process where there is one core or one item."""

    def __init__(self, workers: int):
        self.workers = workers
        self.ex = None

    def __enter__(self):
        if self.workers > 1:
            self.ex = ProcessPoolExecutor(self.workers, mp_context=get_context("spawn"))
        return self

    def __exit__(self, *exc):
        if self.ex is not None:
            self.ex.shutdown(wait=True)

    def map(self, fn, items):
        return self.ex.map(fn, items) if self.ex is not None else map(fn, items)


class Window:
    """Frames rendered back to back for a number of seconds."""

    def __init__(self, renderer, method, traffic: dict, config: dict, seed: int, capture=()):
        from benchmark.reference.common import orbit

        self.r, self.m = renderer, method
        self.camera = lambda i: orbit(traffic, config, seed, i)
        self.capture = set(capture)
        self.images = {}
        self.frame_s, self.enqueue_s = [], []
        self.seconds = 0.0
        self.spans = False

    def _span(self, name: str):
        import contextlib

        import torch

        return (torch.profiler.record_function(f"bench.{name}") if self.spans
                else contextlib.nullcontext())

    def _update(self, r):
        with self._span("update"):
            self.m.update(r)

    def _render(self, r):
        with self._span("render"):
            t = time.perf_counter()
            img = self.m.render(r)
            self.enqueue_s.append(time.perf_counter() - t)
        return img

    def frame(self, i: int) -> None:
        c = self.r.controls
        c.yaw, c.pitch, c.radius, c.target = self.camera(i)
        t = time.perf_counter()
        with self._span("frame"):
            self.r.loop(self._update, self._render, frames=1, block=True)
        self.frame_s.append(time.perf_counter() - t)

    def run(self, seconds: float, spans: bool = False):
        """Frames from index 0 until `seconds` have passed; with `spans`,
        each frame, update and render inside a profiler range."""
        self.spans = spans
        t0 = time.perf_counter()
        i = 0
        while True:
            self.frame(i)
            if i in self.capture:
                self.images[i] = self.r.last_image.clone()
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.seconds = time.perf_counter() - t0
        if self.capture:  # and the last frame, so a window slower than planned keeps one
            self.images.setdefault(i - 1, self.r.last_image.clone())
        return self

    @property
    def frames(self) -> int:
        return len(self.frame_s)


def capture_plan(seed: int, est_frames: int, k: int) -> range:
    """Frame indices whose images are kept for the check: a seeded phase
    and a stride that puts about 2k of them in the window."""
    stride = max(1, est_frames // (2 * k))
    return range(random.Random(seed).randrange(stride), 8 * k * stride, stride)


def load_scene(spec, seed: int, device: str, on_card: bool, steps: dict):
    """Kernels, the scene from the seed, written and loaded through the
    port -> (points, what the writer reports, renderer, method, worker
    count); each step's seconds go into `steps`."""
    import torch

    config, traffic = spec.config, spec.traffic
    fmt = spec.module("formats", config["format"])
    gen = spec.module("generators", config["generator"])
    t = time.perf_counter()
    if on_card:
        from pcrhpg24_tpu_torch.kernels import build

        _lib, nvcc_s, _log = build.build()
        build.load()
        steps["kernels (nvcc)" if nvcc_s else "kernels (built before)"] = time.perf_counter() - t
    from pcrhpg24_tpu_torch import native
    from pcrhpg24_tpu_torch.app import build_methods, wait_loaded
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.method import Runtime
    from pcrhpg24_tpu_torch.engine.renderer import Renderer

    t = time.perf_counter()
    native.get_lib()  # the codec core, built once before the workers need it
    steps["codec core"] = time.perf_counter() - t
    t = time.perf_counter()
    points = gen.make(config, seed, device)
    if on_card:  # the peak is the program's: the generator's arrays are gone
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    steps["scene"] = time.perf_counter() - t
    # one worker process a preprocessing chunk, at most one a core
    workers = min(os.cpu_count() or 1, 8, -(-points.n // CHUNK_POINTS))
    with tempfile.TemporaryDirectory(prefix="pcr_bench_") as tmp:
        t = time.perf_counter()
        with Pool(workers) as pool:
            info = fmt.write(points, tmp, pool.map)
        steps["write " + fmt.SUFFIX] = time.perf_counter() - t
        Debug.lod = float(traffic["lod"])
        renderer = Renderer(traffic["width"], traffic["height"], device)
        build_methods(renderer, info["path"])
        Runtime.set_selected(config["methods"][traffic["mode"]])
        method = Runtime.selected
        t = time.perf_counter()
        wait_loaded(method, renderer)  # the program reads its file only until here
        steps["load"] = time.perf_counter() - t
        if "fd" in info:  # a scene kept in memory
            os.close(info.pop("fd"))
    return points, info, renderer, method, workers


def traced_window(renderer, method, traffic: dict, config: dict, seed: int, seconds: float,
                  on_card: bool, untraced: Window) -> dict:
    """The same frames again under `torch.profiler` -> `trace.reduce`'s numbers."""
    import torch

    from benchmark.trace import reduce

    twin = Window(renderer, method, traffic, config, seed)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        twin.run(seconds, spans=True)
        if on_card:
            torch.cuda.synchronize()
    t = time.perf_counter()
    traced = reduce(prof, twin.frames, twin.seconds)
    rate, base = twin.frames / twin.seconds, untraced.frames / untraced.seconds
    note(f"trace: {twin.frames} frames in {twin.seconds:.3f} s under the profiler ({rate:.3f} "
         f"frames/s against {base:.3f} without it: overhead {base / rate:.4f}x); read in "
         f"{time.perf_counter() - t:.1f} s")
    return traced


def check(ref, traffic: dict, config: dict, seed: int, images: dict,
          k: int) -> tuple[list, int, int]:
    """The reference's image of `k` of the kept frames, drawn from the seed,
    against the window's -> (frames checked, wrong pixels, frames wrong)."""
    from benchmark.reference.common import view

    picked = sorted(random.Random(seed + 1).sample(sorted(images), min(k, len(images))))
    wrong, failed = 0, 0
    for i in picked:
        want = ref.frame(view(traffic, config, seed, i), traffic["mode"] == "hqs").cpu()
        bad = int((want != images[i]).sum())
        wrong += bad
        failed += bad > 0
    return picked, wrong, failed


def run(spec, seed: int, seconds: float, trace: bool, device: str, t_age0: float,
        hook=None) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from benchmark.reference.common import view
    from pcrhpg24_tpu_torch.engine.method import Runtime

    config, traffic = spec.config, spec.traffic
    on_card = torch.device(device).type == "cuda"
    steps = {}
    points, info, renderer, method, workers = load_scene(spec, seed, device, on_card, steps)
    if hook is not None:
        hook(method, renderer)

    t = time.perf_counter()
    warm = Window(renderer, method, traffic, config, seed).run(0.0)
    for _ in range(int(traffic["warmup_frames"]) - 1):
        warm.frame(warm.frames)
    steps["warm-up"] = time.perf_counter() - t
    est = max(1, int(seconds / max(min(warm.frame_s), 1e-6)))
    k = int(traffic["check_frames"])
    setup_s = process_age_s() + t_age0
    note("setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in steps.items())
         + f"; setup_s {setup_s:.3f} s (from process start)")

    win = Window(renderer, method, traffic, config, seed,
                 capture_plan(seed, est, k)).run(seconds)
    if on_card:
        torch.cuda.synchronize()
        note(f"card after the window: {card_state()}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    traced = (traced_window(renderer, method, traffic, config, seed, seconds, on_card, win)
              if trace else None)

    images = {i: img.cpu() for i, img in win.images.items()}
    method.las.unload(renderer)
    del method, renderer, win.images, warm
    Runtime.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_mod = spec.module("reference", config["format"])
    with Pool(workers) as pool:
        ref = ref_mod.Reference(points, traffic, device, pool.map)
    picked, wrong, failed = check(ref, traffic, config, seed, images, k)
    note(f"reference: frames {picked} of {win.frames} checked in "
         f"{time.perf_counter() - t:.1f} s, {wrong} wrong pixels")

    work = [ref.visible_points(view(traffic, config, seed, i)) for i in range(win.frames)]
    rec = dict(setup_s=setup_s, load_s=steps["load"],
               window=dict(seconds=win.seconds, frames=win.frames, frame_s=win.frame_s,
                           enqueue_s=win.enqueue_s, points=work))
    per_s = np.bincount(np.cumsum(win.frame_s).astype(int))[:int(win.seconds)].tolist()
    note(f"window: {win.frames} frames in {win.seconds:.3f} s, visible points a frame "
         f"{np.mean(work):.0f} (min {min(work)}, max {max(work)}), peak device bytes {peak}; "
         f"frame ms p5/p50/p95/max {np.percentile(win.frame_s, [5, 50, 95, 100]) * 1e3}; "
         f"host ms in render p50 {np.median(win.enqueue_s) * 1e3:.3f}; "
         f"frames a second {per_s}")
    if traced is not None:
        traced["bytes"] = spec.module("formats", config["format"]).kernel_bytes(
            info, ref, [view(traffic, config, seed, i) for i in range(traced["frames"])],
            traffic["mode"] == "hqs")
        rec["trace"] = traced
    metrics = {}
    for name, (entry, reader) in spec.readers(spec.per_layer if trace else spec.end_to_end).items():
        value = reader.read(rec)
        if value is not None:
            metrics[name] = dict(value=float(value), unit=entry["unit"])
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=spec.cell["chips"], memory_peak_bytes=peak)
    if on_card:
        dev["power_limit"] = power_limit()
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
    checks = dict(wrong_pixels=dict(value=wrong, limit=LIMIT_WRONG_PIXELS),
                  frames_checked=dict(value=len(picked), limit=k))
    result = dict(correct=wrong <= LIMIT_WRONG_PIXELS and len(picked) == k and failed == 0,
                  attempted=win.frames, failed=failed, metrics=metrics, device=dev)
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result, checks


def main(argv=None, device=None, roots=(), bench_path=None, hook=None) -> int:
    """The command line; `device`, `roots`, `bench_path` and `hook` let a
    test run a cell on the CPU, with its own files, and a fault planted."""
    age0 = -process_age_s() if device is not None else 0.0  # a test: count from here
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    from benchmark.spec import Spec

    spec = Spec.load(args.workload, bench_path, roots)
    import torch

    if device is None:
        chips = spec.cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 1
        device = "cuda"
    result, checks = run(spec, args.seed, args.seconds, bool(args.trace), device, age0, hook)
    leaked = loaded_forbidden()
    if leaked:
        print(f"benchmark: modules that must not load were loaded: {leaked}", file=sys.stderr)
        return 2
    for name, c in checks.items():
        print(f"{name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
