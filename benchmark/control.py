"""The control of the check that decides `correct`: the reference in the
port's place, its projection computed one precision below the f32 the
configuration states (bfloat16), judged against the f32 reference on the
frames a run would check.  It has to come out as not correct.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--frames 4]

Prints, for each seed, the wrong pixels of each frame (the number a run
holds to its limit of 0), and the least over all.  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.reference import common
from benchmark.run import Pool, set_cache_dirs
from benchmark.spec import Spec


def wrong_pixels(spec, seed: int, frames: int, device, dtype=torch.bfloat16,
                 workers: int = 8) -> list:
    """Wrong pixels of the `dtype` reference against the f32 one, on
    `frames` frames of the cell's path spread over one orbit."""
    cfg, traffic = spec.config, spec.traffic
    gen = spec.module("generators", cfg["generator"])
    ref_mod = spec.module("reference", cfg["format"])
    points = gen.make(cfg, seed, device)
    with Pool(workers) as pool:
        ref = ref_mod.Reference(points, traffic, device, pool.map)
    hqs = traffic["mode"] == "hqs"
    step = traffic["orbit"]["steps_per_turn"] // frames
    out = []
    for i in range(0, frames * step, step):
        v = common.view(traffic, cfg, seed, i)
        out.append(int((ref.frame(v, hqs) != ref.frame(v, hqs, dtype)).sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)
    set_cache_dirs()
    spec = Spec.load(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    readings = {s: wrong_pixels(spec, s, args.frames, "cuda") for s in args.seeds}
    for s, r in readings.items():
        print(f"[control] {args.workload} seed {s}: wrong pixels {r}")
    print(json.dumps(dict(workload=args.workload, device=torch.cuda.get_device_name(0),
                          least=min(min(r) for r in readings.values()),
                          readings={str(s): r for s, r in readings.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
