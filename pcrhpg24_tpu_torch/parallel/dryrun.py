"""The sharded frames in n rank processes, each image held to the
single-process frame: the port's `dryrun_multichip`.

Counterpart of `__graft_entry__.dryrun_multichip`, which renders the
reference's sharded paths on a virtual 8-device CPU mesh.  Here
`dryrun_multichip(n, tasks, backend, device)` starts n rank processes
(`python -m pcrhpg24_tpu_torch.parallel.dryrun JOB RANK`), which join
one `torch.distributed` group over the `backend` the caller names
(`gloo`, or `nccl` where each rank has a card of its own), through a
rendezvous file in a temporary directory (no port to fight over), each
with torch pinned to one thread, all on `device`.  The kernels are
built once, in the calling process, before the ranks start; a rank only
loads the built library.  Two ranks may share one card over `gloo`,
whose collectives stage CUDA tensors through the host: that is the
transport, and every kernel of the frames still runs on the card.

Each task renders one sharded path, every rank of the task's (dp, sp)
layout its own batches and rows:

* `{"kind": "tpc", "scene": path, "budget": batches or None, "dp", "sp",
  "width", "height", "lod", "views": {name: Setting fields}, "modes":
  ["color", "hqs"]}`: `mesh_native.flagship_frame` / `flagship_hqs` on
  the `.tpc` scene (its first `budget` batches resident), at each view;
  held to `huffman_tpu.render_frame_native` / `huffman_tpu_hqs.
  hqs_frame_native` of the whole scene in the rank;
* `{"kind": "huffman", "scene": path of an .npz, "dp", "sp", "width",
  "height"}`: `mesh.multichip_render` of the `.npz`'s `.huffman` arrays
  (`mesh.BATCH_KEYS`, `encoding`, `separate` and the offsets, as
  `batches_to_device` makes them), `lod_n`, `transform`, `scale` and
  `offset_rel`; held to `mesh.local_raster` over every batch.

A rank writes its rows of each image (`.npy`) and a JSON of its checks
and times into the job's directory; `dryrun_multichip` raises unless
every rank held every image, and returns each whole image (the rows of
the ranks of dp index 0, after checking the other dp ranks' rows equal
them) and the ranks' reports.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TIMEOUT_S = 900  # the ranks' run, and the process group's collectives


def dryrun_multichip(n: int, tasks: list, backend: str, device: str,
                     workdir: str | None = None, reps: int = 5) -> dict:
    """Run `tasks` in `n` rank processes -> {task name: {"images": {frame:
    (height, width) int32}, "ranks": [each rank's report]}, and
    "foreign_modules": the modules of jax or of the JAX package that any
    rank loaded}; raises if a rank fails or a sharded image differs from
    the single-process one.
    Each sharded frame and collective is also timed, the median host ms
    of `reps` calls (0: not timed)."""
    import torch

    if torch.device(device).type == "cuda":
        from ..kernels import build

        build.build()  # once, here: the ranks only load the library
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        job = dict(backend=backend, device=device, world=n, reps=reps,
                   init=f"file://{tmp}/rendezvous", out=tmp, tasks=tasks)
        path = os.path.join(tmp, "job.json")
        with open(path, "w") as f:
            json.dump(job, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [str(REPO),
                                                            os.environ.get("PYTHONPATH")])))
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        try:
            procs = [subprocess.Popen([sys.executable, "-m", __name__, path, str(r)],
                                      cwd=REPO, env=env, stdout=logs[r],
                                      stderr=subprocess.STDOUT) for r in range(n)]
            deadline = time.monotonic() + TIMEOUT_S
            try:
                for p in procs:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                tails = []
                for r in failed:
                    logs[r].seek(0)
                    tails.append(f"rank {r} (rc {procs[r].returncode}):\n"
                                 f"{logs[r].read()[-3000:]}")
                raise RuntimeError("dryrun ranks failed\n" + "\n".join(tails))
        finally:
            for f in logs:
                f.close()
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        return _gather(tmp, tasks, reports)


def _gather(tmp: str, tasks: list, reports: list) -> dict:
    out = {}
    for t in tasks:
        name = t["name"]
        ranks = [rep[name] for rep in reports]
        active = [r for r in ranks if r["active"]]
        bad = [(r["rank"], f) for r in active for f, c in r["frames"].items() if not c["equal"]]
        if bad:
            raise AssertionError(f"{name}: sharded image != single-process frame at "
                                 f"(rank, frame) {bad}")
        images = {}
        for frame in active[0]["frames"]:
            cols = []
            for s in range(t["sp"]):
                rows = [np.load(_rows_path(tmp, name, frame, r["rank"])) for r in active
                        if r["sp_idx"] == s]
                if any(not np.array_equal(x, rows[0]) for x in rows):
                    raise AssertionError(f"{name} {frame}: the dp ranks of column {s} "
                                         f"hold different rows")
                cols.append(rows[0])
            images[frame] = np.concatenate(cols)
        out[name] = dict(images=images, ranks=ranks)
    out["foreign_modules"] = sorted({m for rep in reports for m in rep["foreign_modules"]})
    return out


def _rows_path(tmp: str, task: str, frame: str, rank: int) -> str:
    safe = "".join(c if c.isalnum() else "_" for c in f"{task}_{frame}")
    return os.path.join(tmp, f"{safe}_r{rank}.npy")


def _ms(fn, sync, reps: int):
    """Median host ms of fn() (each ended by `sync`) over `reps` calls."""
    if not reps:
        return None
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _tpc_task(t: dict, device, mesh, sync, out: str, rank: int, reps: int) -> dict:
    import torch
    import torch.distributed as dist

    from ..engine.debug import Debug
    from ..engine.native_resource import NativeLasData
    from ..engine.renderer import Renderer, Setting
    from ..render.methods.huffman_tpu import HuffmanTpu, render_frame_native
    from ..render.methods.huffman_tpu_hqs import hqs_frame_native
    from ..render.raster import BACKGROUND, key_plane, swizzle_dims
    from .mesh_native import (all_reduce_min_u64, batch_range, flagship_frame,
                              flagship_hqs, shard_dev, shard_frame)

    W, H = t["width"], t["height"]
    las = NativeLasData.create(t["scene"], device, budget_batches=t.get("budget"))
    las.wait_loaded()
    r = Renderer(W, H, device)
    m = HuffmanTpu(r, las)
    Debug.lod = t.get("lod", 1.0)
    row0, rows = mesh.row_range(H)
    single = {"color": lambda a: render_frame_native(**a)[2],
              "hqs": lambda a: hqs_frame_native(**a)[2]}
    sharded = {"color": flagship_frame, "hqs": flagship_hqs}
    frames, args = {}, {}
    for view, setting in t["views"].items():  # the whole scene's frames first
        r.apply_setting(Setting(**setting))
        r.controls_update()
        args[view] = m.frame_args(r)
        for mode in t["modes"]:
            frames[f"{view}/{mode}"] = single[mode](args[view])[row0:row0 + rows]
    start, stop = batch_range(las.num_batches, mesh.dp, mesh.dp_idx)
    loaded = las.num_batches_loaded
    dev = shard_dev(las.dev, start, stop)
    las.unload()  # the rank keeps its own batches only
    report = dict(start=start, stop=stop, batches=loaded, frames={})
    for view, a in args.items():
        sa = shard_frame(a, dev, start, stop, loaded)
        for mode in t["modes"]:
            key = f"{view}/{mode}"
            img = sharded[mode](mesh, sa)
            sync()
            ms = _ms(lambda: sharded[mode](mesh, sa), sync, reps)
            np.save(_rows_path(out, t["name"], key, rank), img.cpu().numpy())
            report["frames"][key] = dict(
                equal=bool(torch.equal(img, frames[key])), ms=ms,
                shown=int((img != BACKGROUND).sum()))
    size = swizzle_dims(W, H)[2]
    plane = key_plane(size, dev["anchor"].device)
    sums = torch.zeros((4, size), dtype=torch.int64, device=plane.device)
    report["collective_ms"] = dict(
        plane_entries=size,
        min_u64=_ms(lambda: all_reduce_min_u64(plane, mesh.dp_group), sync, reps),
        sum_4_planes=_ms(lambda: dist.all_reduce(sums, group=mesh.dp_group), sync, reps))
    return report


def _huffman_task(t: dict, device, mesh, sync, out: str, rank: int, reps: int) -> dict:
    import torch

    from ..render.raster import BACKGROUND, EMPTY
    from ..u32 import split_key
    from .mesh import local_raster, multichip_render, rank_scene, shard_streams_host

    W, H = t["width"], t["height"]
    with np.load(t["scene"]) as z:
        scene = {k: z[k] for k in z.files}
    as_t = lambda k: torch.from_numpy(scene[k]).to(device)  # noqa: E731
    lod_n, transform, scale, offset_rel = (as_t(k) for k in ("lod_n", "transform", "scale",
                                                              "offset_rel"))
    row0, rows = mesh.row_range(H)
    whole, _s, _e = rank_scene(shard_streams_host(scene, 1), 1, 0, device)
    pay = split_key(local_raster(whole, 0, lod_n, transform, scale, offset_rel, W, H))[1]
    pay = pay[row0 * W:(row0 + rows) * W]
    want = torch.where(pay != EMPTY, pay, torch.full_like(pay, BACKGROUND)).reshape(rows, W)
    part, start, stop = rank_scene(shard_streams_host(scene, mesh.dp), mesh.dp,
                                   mesh.dp_idx, device)
    args = (mesh, part, start, lod_n[start:stop], transform, scale, offset_rel, W, H)
    img = multichip_render(*args)
    sync()
    ms = _ms(lambda: multichip_render(*args), sync, reps)
    np.save(_rows_path(out, t["name"], "frame", rank), img.cpu().numpy())
    return dict(start=start, stop=stop, batches=int(scene["enc_offsets"].shape[0]),
                stream_words=int(part["encoding"].numel()),
                frames={"frame": dict(equal=bool(torch.equal(img, want)), ms=ms,
                                      shown=int((img != BACKGROUND).sum()))})


def rank_main(job_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from .mesh_native import Mesh

    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        sync = torch.cuda.synchronize
    else:
        sync = lambda: None  # noqa: E731
    dist.init_process_group(job["backend"], init_method=job["init"], world_size=job["world"],
                            rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
    run = {"tpc": _tpc_task, "huffman": _huffman_task}
    report = {}
    try:
        for t in job["tasks"]:
            mesh = Mesh(t["dp"], t["sp"])  # every rank builds every layout's groups
            entry = dict(rank=rank, active=mesh.active, dp_idx=mesh.dp_idx,
                         sp_idx=mesh.sp_idx)
            if mesh.active:
                t0 = time.perf_counter()
                entry.update(run[t["kind"]](t, device, mesh, sync, job["out"], rank,
                                            job["reps"]))
                entry["seconds"] = time.perf_counter() - t0
            report[t["name"]] = entry
            dist.barrier()
    finally:
        dist.destroy_process_group()
    # what a rank loaded of jax or the JAX package: nothing
    report["foreign_modules"] = sorted(
        k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "pcrhpg24_tpu"))
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
