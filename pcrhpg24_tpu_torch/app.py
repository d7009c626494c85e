"""Application entry: scene, method, render loop — the port's CLI.

Counterpart of `pcrhpg24_tpu/app.py` for `.huffman` scenes (the
reference's own format: `huffman_mem_iter`, the default, `huffman_hqs`,
and `huffman_tpu` on the load-time transcode to fbatch), `.tpc` scenes
(v2 fbatch or v1 tbatch, BC1 colours: the colour frame `huffman_tpu` or
the HQS blend `huffman_tpu_hqs`), `.las` scenes (the source paper's
baselines, nine methods: `loop_las` (the default), `loop_las2`,
`loop_las_hqs`, `basic`, the four 2021 variants and `2021 hqs`), `.laz`
and multi-file scenes (`a.las,b.laz` or a glob: `basic`) and the
procedural `parametric` scene (a radius-10 sphere at the origin), and
Potree directories (`loop_nodes`, the default, and `loop_nodes_hqs`;
`Debug.node_budget` turns on the per-node point budget, as in the
reference, which has no flag for it).  Rendered on one device, offscreen,
with PNG and depth (EXR or .npy) export, the reference's debug modes,
eye-dome lighting and bounding boxes, a timing report, a
`torch.profiler` trace (`--trace`, Chrome JSON, in place of the
reference's `jax.profiler` trace), or the localhost viewer (`--serve`).

Unlike the reference, a failed `.huffman` load-time transcode is not
caught: its error propagates, so a broken C++ codec core cannot leave
the scene with one method missing unnoticed.

Usage:
  python -m pcrhpg24_tpu_torch.app --scene out/scene.huffman|out/scene.tpc|x.las|
      'a.las,b.laz'|'dir/*.las'|parametric|potree_dir
      [--method huffman_mem_iter|huffman_hqs|huffman_tpu|huffman_tpu_hqs|loop_las|
                loop_nodes|loop_nodes_hqs|...]
      [--frames 3] [--width 1920 --height 1080]
      [--yaw -0.15 --pitch -0.57 --radius 1000 --target x y z]
      [--lod 0.1] [--screenshot out/frame.png] [--depth out/depth.exr|.npy]
      [--colorize-chunks] [--colorize-overdraw] [--show-num-points] [--edl]
      [--no-frustum-culling] [--show-bounding-box] [--list-methods]
      [--stats] [--trace DIR] [--serve PORT] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from .engine.debug import Debug
from .engine.method import Runtime
from .engine.renderer import Renderer, Setting


def build_methods(renderer: Renderer, scene_path: str):
    """Instantiate the loader + method for a scene (main.cpp:244-274)."""
    Runtime.clear()
    if scene_path == "parametric":
        from .render.methods.parametric import Parametric

        Runtime.add_method(Parametric(renderer))
        return Runtime.methods
    if scene_path.endswith(".huffman"):
        from .engine.native_resource import HuffmanNativeData
        from .engine.resource import HuffmanLasData
        from .render.methods.huffman_hqs import HuffmanHQS
        from .render.methods.huffman_mem_iter import HuffmanMemIter
        from .render.methods.huffman_tpu import HuffmanTpu

        data = HuffmanLasData.create(scene_path, renderer.device)
        Runtime.add_method(HuffmanMemIter(renderer, data))
        Runtime.add_method(HuffmanHQS(renderer, data))
        Runtime.add_method(HuffmanTpu(
            renderer, HuffmanNativeData.create(scene_path, renderer.device)))
        return Runtime.methods
    if scene_path.endswith(".tpc"):
        from .engine.native_resource import NativeLasData
        from .render.methods.huffman_tpu import HuffmanTpu
        from .render.methods.huffman_tpu_hqs import HuffmanTpuHqs

        data = NativeLasData.create(scene_path, renderer.device)
        Runtime.add_method(HuffmanTpu(renderer, data))
        Runtime.add_method(HuffmanTpuHqs(renderer, data))
        return Runtime.methods
    if scene_path.endswith(".laz") or "," in scene_path or "*" in scene_path:
        # multi-file / compressed ingestion (LasLoaderSparse equivalent:
        # modules/compute/LasLoaderSparse.cpp), rendered by `basic`
        from .engine.las_sparse import LasSparseData
        from .render.methods.basic import BasicMethod

        Runtime.add_method(BasicMethod(renderer, LasSparseData.create(scene_path,
                                                                      renderer.device)))
        return Runtime.methods
    if scene_path.endswith(".las"):
        from .engine.las_resources import ComputeLasData, ComputeLasDataBasic, LasStandardData
        from .render.methods.basic import BasicMethod
        from .render.methods.compute_2021 import Compute2021, Compute2021Hqs
        from .render.methods.loop_las import ComputeLoopLas, ComputeLoopLas2, ComputeLoopLasHqs

        d1010 = ComputeLasData.create(scene_path, renderer.device)
        std = LasStandardData.create(scene_path, renderer.device)
        Runtime.add_method(ComputeLoopLas(renderer, d1010))
        Runtime.add_method(ComputeLoopLas2(renderer, d1010))
        Runtime.add_method(ComputeLoopLasHqs(renderer, d1010))
        Runtime.add_method(BasicMethod(
            renderer, ComputeLasDataBasic.create(scene_path, renderer.device)))
        for name in Compute2021.VARIANTS:
            Runtime.add_method(Compute2021(renderer, std, name=name))
        Runtime.add_method(Compute2021Hqs(renderer, std))
        return Runtime.methods
    # a Potree directory
    from .engine.potree_resource import PotreeData
    from .render.methods.loop_nodes import ComputeLoopNodes, ComputeLoopNodesHqs

    data = PotreeData.create(scene_path, renderer.device)
    Runtime.add_method(ComputeLoopNodes(renderer, data))
    Runtime.add_method(ComputeLoopNodesHqs(renderer, data))
    return Runtime.methods


def wait_loaded(method, renderer) -> None:
    """Start the method's resource loading and wait until it is resident."""
    method.update(renderer)
    if hasattr(method, "las"):
        method.las.wait_loaded(renderer)
    elif hasattr(method, "potree"):
        method.potree.wait_loaded(renderer)


def trace_frames(renderer, method, frames: int, out_dir: str) -> str:
    """One warm frame, then `frames` frames under `torch.profiler` (the
    card's kernels too when the renderer is on one) -> the Chrome trace
    JSON written into `out_dir`."""
    import torch

    renderer.loop(method.update, method.render, frames=1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if renderer.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        renderer.loop(method.update, method.render, frames=frames)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def run(argv=None) -> Renderer:
    """Parse `argv`, render, save; returns the renderer (frame times,
    last image) for callers that inspect the run."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--method", default=None)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--yaw", type=float, default=-0.15)
    ap.add_argument("--pitch", type=float, default=-0.57)
    ap.add_argument("--radius", type=float, default=1000.0)
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--lod", type=float, default=0.1)
    ap.add_argument("--screenshot", default=None)
    ap.add_argument("--depth", default=None,
                    help="write the depth plane: EXR for .exr paths, .npy otherwise")
    ap.add_argument("--colorize-chunks", action="store_true")
    ap.add_argument("--colorize-overdraw", action="store_true")
    ap.add_argument("--edl", action="store_true",
                    help="eye-dome lighting in the resolve (resolve.cs:143-188)")
    ap.add_argument("--show-num-points", action="store_true")
    ap.add_argument("--no-frustum-culling", action="store_true")
    ap.add_argument("--show-bounding-box", action="store_true")
    ap.add_argument("--list-methods", action="store_true")
    ap.add_argument("--stats", action="store_true", help="print timing report")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome JSON, DIR/trace.json) "
                         "of --frames frames after one warm frame")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="interactive localhost viewer instead of offscreen frames "
                         "(0: a free port)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Debug.lod = args.lod
    Debug.colorize_chunks = args.colorize_chunks
    Debug.colorize_overdraw = args.colorize_overdraw
    Debug.edl = args.edl
    Debug.show_num_points = args.show_num_points
    Debug.frustum_culling_enabled = not args.no_frustum_culling
    Debug.show_bounding_box = args.show_bounding_box
    renderer = Renderer(args.width, args.height, args.device)
    renderer.apply_setting(
        Setting(yaw=args.yaw, pitch=args.pitch, radius=args.radius,
                target=args.target)
    )
    build_methods(renderer, args.scene)
    if args.list_methods:
        for m in Runtime.methods:
            print(f"{m.name:24s} [{m.group}] {m.description}")
        return renderer
    if args.method:
        Runtime.set_selected(args.method)
    method = Runtime.selected

    if args.serve is not None:
        from .engine.viewer import ViewerServer

        wait_loaded(method, renderer)
        ViewerServer(renderer, Runtime.methods, args.serve).serve_forever()
        return renderer

    print(f"rendering {args.frames} frame(s) with {method.name} "
          f"on {renderer.device}")
    renderer.capture_depth = bool(args.depth)
    wait_loaded(method, renderer)
    if args.trace:
        path = trace_frames(renderer, method, args.frames, args.trace)
        print(f"wrote trace {path}")
    else:
        renderer.loop(method.update, method.render, frames=args.frames)

    if args.screenshot:
        renderer.save_screenshot(args.screenshot)
        print(f"wrote {args.screenshot}")
    if args.depth:
        renderer.save_depth_exr(args.depth)
        print(f"wrote {args.depth}")
    if args.stats:
        print(renderer.timings.report())
        if renderer.frame_ms:
            print("device frame ms (CUDA events): "
                  + " ".join(f"{t:.3f}" for t in renderer.frame_ms))
    return renderer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
