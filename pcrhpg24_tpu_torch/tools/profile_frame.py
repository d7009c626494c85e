"""Where a frame's time goes on the card: a `torch.profiler` breakdown.

Renders a scene through its method for a few warm frames, then traces
`--frames` more with CPU and CUDA activity and prints, per frame: the
host wall time (and that of as many frames run before, without the
profiler), the device busy time (union of the kernels' and copies'
device intervals), the device idle share (1 - busy / wall), each device
kernel's time and launch count, the host's self time in each torch op
and CUDA runtime call that takes the most of it (what the host spends
its share of the frame on), and the peak device memory.  Scenes: a
`.huffman`, `.tpc` or `.las` file, a multi-file scene, a Potree
directory (`--node-budget D`: `Debug.node_budget`, the budgeted compact
frame) or `parametric` through the app's methods, or a `.wg` file
through `loop_nodes_compressed` (which the app does not register, as
the reference's does not).  Run on a host with a card:

    python -m pcrhpg24_tpu_torch.tools.profile_frame --scene out/s.tpc|out/s.huffman|out/s.wg \
        [--method huffman_tpu|huffman_tpu_hqs|huffman_mem_iter|huffman_hqs|loop_las|...] \
        [--view orbit] [--frames 5]
    python -m pcrhpg24_tpu_torch.tools.profile_frame --scene parametric --view near
    python -m pcrhpg24_tpu_torch.tools.profile_frame --scene out/potree_dir \
        --method loop_nodes|loop_nodes_hqs --view steady [--node-budget 2.0] \
        [--budget-points 3e8]
    python -m pcrhpg24_tpu_torch.tools.profile_frame --scene out/s.tpc \
        --outputs colorize_overdraw edl   # the frame's other outputs: any of OUTPUTS
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

import torch

from ..engine.debug import Debug
from ..engine.method import Runtime
from ..engine.renderer import Renderer, Setting

# bench.py:176-183
VIEWS = {
    "orbit": Setting(yaw=0.5, pitch=-0.9, radius=2500.0, target=(1000.0, 1000.0, 100.0)),
    "closeup": Setting(yaw=2.4, pitch=-0.25, radius=180.0, target=(1000.0, 1000.0, 60.0)),
    "oblique": Setting(yaw=-1.1, pitch=-0.08, radius=1400.0, target=(1000.0, 1000.0, 40.0)),
    # the parametric scene's radius-10 sphere at the origin
    "near": Setting(yaw=0.4, pitch=-0.3, radius=14.0),
    "mid": Setting(yaw=-1.2, pitch=-0.7, radius=22.0),
    "far": Setting(yaw=2.0, pitch=0.25, radius=35.0),
    # the synthetic Potree scene of `tools/synth_potree.py` (4096 m): the
    # steady camera of the reference's 1B-point run, an overview, and a
    # close-up of the (700, 700) corner on the terrain
    "steady": Setting(yaw=0.45, pitch=-0.75, radius=6500.0, target=(2048.0, 2048.0, 500.0)),
    "overview": Setting(yaw=-0.6, pitch=-1.2, radius=12000.0, target=(2048.0, 2048.0, 900.0)),
    "corner": Setting(yaw=0.8, pitch=-0.5, radius=250.0, target=(700.0, 700.0, 1030.0)),
}


# `Debug` flags of the colour frames' other outputs, and "depth" (the
# renderer's capture_depth)
OUTPUTS = ("colorize_chunks", "show_num_points", "colorize_overdraw", "show_bounding_box",
           "edl", "depth")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(scene: str, method: str | None, view: str, frames: int, width: int,
            height: int, lod: float, outputs=(), node_budget: float = 0.0,
            budget_points: int | None = None) -> dict:
    from ..app import build_methods
    from ..engine.potree_resource import PotreeData
    from ..render.methods.loop_nodes_compressed import ComputeLoopNodesCompressed, WgData

    Debug.lod = lod
    Debug.node_budget = node_budget
    for flag in OUTPUTS[:-1]:
        setattr(Debug, flag, flag in outputs)
    r = Renderer(width, height, "cuda")
    r.capture_depth = "depth" in outputs
    r.apply_setting(VIEWS[view])
    if scene.endswith(".wg"):
        m = ComputeLoopNodesCompressed(r, WgData.create(scene, "cuda"))
    else:
        build_methods(r, scene)
        if method:
            Runtime.set_selected(method)
        m = Runtime.selected
        if budget_points is not None and hasattr(m, "potree"):
            m.potree = PotreeData.create(scene, "cuda", budget_points)
    resource = getattr(m, "las", None) or getattr(m, "wg", None) or getattr(m, "potree", None)
    m.update(r)
    if resource is not None:
        resource.wait_loaded(r)
    r.loop(m.update, m.render, frames=2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.loop(m.update, m.render, frames=frames)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.loop(m.update, m.render, frames=frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    kernels = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        kernels[e.name][0] += (t - s) / 1e3 / frames
        kernels[e.name][1] += 1
    busy = busy_us(intervals) / 1e3 / frames
    host = {e.key: (e.self_cpu_time_total / 1e3 / frames, e.count / frames)
            for e in prof.key_averages() if e.self_cpu_time_total > 0}
    out = dict(method=m.name, wall_ms=wall_ms, plain_wall_ms=plain_wall_ms, busy_ms=busy,
               idle_share=1.0 - busy / wall_ms if wall_ms else float("nan"),
               peak_bytes=torch.cuda.max_memory_allocated(),
               kernels={k: (ms, n / frames) for k, (ms, n) in kernels.items()},
               host=host)
    if resource is not None:
        resource.unload()
    Runtime.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True)
    ap.add_argument("--method", default=None, help="default: the scene's first")
    ap.add_argument("--view", default="orbit", choices=sorted(VIEWS))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--lod", type=float, default=1.0)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--outputs", nargs="*", default=[], choices=OUTPUTS,
                    help="the colour frame's other outputs to render")
    ap.add_argument("--node-budget", type=float, default=0.0,
                    help="Potree: Debug.node_budget, the budget's density (0: none)")
    ap.add_argument("--budget-points", type=float, default=None,
                    help="Potree: the residency cap, in points")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: no card", file=sys.stderr)
        return 1
    cap = None if args.budget_points is None else int(args.budget_points)
    res = profile(args.scene, args.method, args.view, args.frames, args.width,
                  args.height, args.lod, args.outputs, args.node_budget, cap)
    shown = f" +{'+'.join(args.outputs)}" if args.outputs else ""
    shown += f" node_budget {args.node_budget}" if args.node_budget else ""
    # the `pcr_*` ranges around the port's launches show on the device too
    launched = sum(n for k, (_ms, n) in res["kernels"].items() if not k.startswith("pcr_"))
    print(f"[profile] {res['method']}{shown} {args.view} {args.scene}: wall "
          f"{res['wall_ms']:.3f} ms/frame (without the profiler "
          f"{res['plain_wall_ms']:.3f}), device busy {res['busy_ms']:.3f} "
          f"ms/frame, idle share {res['idle_share']:.3f}, {launched:g} device kernels "
          f"and copies a frame, peak "
          f"{res['peak_bytes']:,} B ({args.frames} frames under the profiler, "
          f"{torch.cuda.get_device_name(0)})")
    top = sorted(res["kernels"].items(), key=lambda kv: -kv[1][0])
    rest = sum(ms for _k, (ms, _n) in top[args.top:])
    # and the port's own kernels (their profiler ranges: `pcr_*`) wherever they rank
    top = top[: args.top] + [kv for kv in top[args.top:] if kv[0].startswith("pcr_")]
    for name, (ms, n) in top:
        share = ms / res["busy_ms"] if res["busy_ms"] else 0.0
        print(f"[profile]   {ms:.3f} ms/frame ({share:.1%} of busy), {n:g} "
              f"launches/frame: {name[:90]}")
    print(f"[profile]   {rest:.3f} ms/frame in {max(len(res['kernels']) - args.top, 0)} "
          f"other device kernels and copies")
    host = sorted(res["host"].items(), key=lambda kv: -kv[1][0])
    total = sum(ms for _k, (ms, _n) in host)
    print(f"[profile] host self time in torch ops and CUDA runtime calls: "
          f"{total:.3f} ms/frame of the {res['wall_ms']:.3f} ms wall")
    for name, (ms, n) in host[: args.top]:
        print(f"[profile]   host {ms:.3f} ms/frame, {n:g} calls/frame: {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
