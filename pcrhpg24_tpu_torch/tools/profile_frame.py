"""Where a frame's time goes on the card: a `torch.profiler` breakdown.

Renders a scene through its method for a few warm frames, then traces
`--frames` more with CPU and CUDA activity and prints, per frame: the
host wall time (and that of as many frames run before, without the
profiler), the device busy time (union of the kernels' and copies'
device intervals), the device idle share (1 - busy / the wall without
the profiler, which slows the host and not the card), the idle split
into lead (a `renderer.frame` range's start to its first device
interval), starved (gaps between its first and last device interval)
and tail time, each device kernel's time and launch count, the host's
self time in each torch op and CUDA runtime call that takes the most of
it (what the host spends its share of the frame on), each program span
(`engine/timing.span`: `renderer.*`, `las.*`, `tpc.*`) with its host
and self time, each counter, and the peak device memory.  Scenes: a
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
import bisect
import sys
import time
from collections import defaultdict

import torch

from ..engine import timing
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


# the program's spans (`engine/timing.span`); `pcr_*` names a kernel's launch
PROGRAM = ("renderer.", "las.", "tpc.")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def program_spans(ranges) -> dict:
    """name -> [total, self, count] of the program's spans among the host
    ranges (name, start, end); a span's self time is its length less
    that of the program spans directly inside it."""
    out = defaultdict(lambda: [0.0, 0.0, 0])
    stack = []  # [name, start, end, children's time]

    def close(name, s, e, inner):
        total = out[name]
        total[0] += e - s
        total[1] += e - s - inner
        total[2] += 1

    for name, s, e in sorted((r for r in ranges if r[0].startswith(PROGRAM)),
                             key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= s:
            close(*stack.pop())
        if stack:
            stack[-1][3] += e - s
        stack.append([name, s, e, 0.0])
    while stack:
        close(*stack.pop())
    return dict(out)


def frame_idle(frames, device) -> dict:
    """The card's idle time in the frames' ranges (start, end), summed:
    `lead` from a frame's start to its first device interval's start (the
    whole frame where it has none), `starved` the gaps in the union of
    its device intervals, `tail` from its last device end to its end;
    `busy` that union, and `outside` the count of device intervals that
    lie inside no frame (0 where the spans share the device's clock)."""
    frames = sorted(frames)
    starts = [s for s, _e in frames]
    inside = defaultdict(list)
    outside = 0
    for s, e in device:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= frames[i][1]:
            inside[i].append((s, e))
        else:
            outside += 1
    lead = starved = tail = busy = 0.0
    for i, (fs, fe) in enumerate(frames):
        iv = sorted(inside.get(i, ()))
        if not iv:
            lead += fe - fs
            continue
        lead += iv[0][0] - fs
        end = iv[0][0]
        for s, e in iv:
            if s > end:
                starved += s - end
            busy += max(e, end) - max(s, end)
            end = max(end, e)
        tail += fe - end
    return dict(lead=lead, starved=starved, tail=tail, busy=busy, outside=outside)


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
    timing.take_counters()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.loop(m.update, m.render, frames=frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    counters = timing.take_counters()["counters"]
    kernels = defaultdict(lambda: [0.0, 0])
    intervals, ranges = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type != torch.autograd.DeviceType.CUDA:
            ranges.append((e.name, s, t))
            continue
        # a range (the program's spans, the kernels' `pcr_*` launches) laid
        # over the device time of the work launched inside it
        annotation = e.is_user_annotation or e.name.startswith((*PROGRAM, "pcr_"))
        if not annotation:
            intervals.append((s, t))
        if not annotation or e.name.startswith("pcr_"):
            kernels[e.name][0] += (t - s) / 1e3 / frames
            kernels[e.name][1] += 1
    busy = busy_us(intervals) / 1e3 / frames
    host = {e.key: (e.self_cpu_time_total / 1e3 / frames, e.count / frames)
            for e in prof.key_averages() if e.self_cpu_time_total > 0}
    idle = frame_idle([(s, t) for n, s, t in ranges if n == "renderer.frame"], intervals)
    out = dict(method=m.name, wall_ms=wall_ms, plain_wall_ms=plain_wall_ms, busy_ms=busy,
               idle_share=1.0 - busy / plain_wall_ms if plain_wall_ms else float("nan"),
               peak_bytes=torch.cuda.max_memory_allocated(),
               kernels={k: (ms, n / frames) for k, (ms, n) in kernels.items()},
               host=host,
               idle={k: v if k == "outside" else v / 1e3 / frames for k, v in idle.items()},
               spans={k: (tot / 1e3 / frames, own / 1e3 / frames, n / frames)
                      for k, (tot, own, n) in program_spans(ranges).items()},
               counters={k: v / frames for k, v in counters.items()})
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
          f"ms/frame, idle share {res['idle_share']:.3f} of the wall without the "
          f"profiler, {launched:g} device kernels "
          f"and copies a frame, peak "
          f"{res['peak_bytes']:,} B ({args.frames} frames under the profiler, "
          f"{torch.cuda.get_device_name(0)})")
    idle = res["idle"]
    print(f"[profile] card idle in a traced frame: lead {idle['lead']:.3f} ms, starved "
          f"{idle['starved']:.3f}, tail {idle['tail']:.3f} (busy {idle['busy']:.3f}); "
          f"device intervals outside any frame: {idle['outside']}")
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
    for name, (ms, own, n) in sorted(res["spans"].items()):
        print(f"[profile] span {name}: host {ms:.3f} ms/frame (self {own:.3f}), "
              f"{n:g}/frame")
    for name, v in sorted(res["counters"].items()):
        print(f"[profile] counter {name}: {v:g}/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
