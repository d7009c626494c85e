"""What to sort in front of B6: the card's counterpart of the TPU probe
`experiments/r3_rows_prefix.py` (pallas_call at :146).

The TPU probe sorted a frame's stream in 64, 96 or 128 independent rows
(`lax.sort` along each row), and built its window tables over each
row's live prefix only (off-screen pids sort to the row tails), before
the merge (`pm._merge_nk1_kernel_ilp` through `_dense_rows_group`).  The
port's frames sort the whole stream by pid (`raster.sort_by_pid`) and
resolve it with B6 (`csrc/merge.cuh`), which is exact on any
segmentation of the stream.  The paths, each held bit-exact to
`u64_min_planes_plain` of the unsorted stream:

- whole: `sort_by_pid` on everything, then B6 (the shipped path);
- live-mask: a boolean index of the live entries (pid < size; the
  library call), then the sort, then B6;
- live-kernel: `pcr_probe_compact` (`r3_rows_prefix.cu`: one pass, a warp
  `__ballot_sync` and one `atomicAdd` a warp for its output offset,
  order not kept), then the sort, then B6;
- rows-S, S = 64 and 128: `torch.sort(dim=1)` over an (S, n / S) view
  (the TPU's row sort; the stream padded with dead entries to a multiple
  of S), then B6 on the flattened rows.

The compaction's prefix, sorted by the full key, is held equal to its
plain version's (`compact_plain`, the boolean index).  Printed for each
path: the live share, the selection, the sort and B6 (each timed alone,
device ms; a selection includes its device->host read of the live
count, which the sort's length needs) and their total.  On a host with a
card:

    python -m pcrhpg24_tpu_torch.experiments.r3_rows_prefix \\
        [--scene parametric --scene out/chip_smoke_256.wg --scene out/chip_smoke_256.las]

(`chip_smoke.py` runs it on the parametric near stream, the `.wg` orbit
stream and the `.las` orbit part.)
"""

from __future__ import annotations

import sys

import torch

from ..kernels.build import L, P, I, check_cuda
from ..render.raster import key_views, sort_by_pid, u64_min_planes_plain
from ..u32 import INT32_MIN, widen
from . import probes

COMPACT = probes.probe_kernel("pcr_probe_compact", [P, P, P, P, P, P, P, L, I])
ROWS = (64, 128)
PATHS = ("whole", "live-mask", "live-kernel", *(f"rows-{s}" for s in ROWS))


def compact_launch(stream, size: int, out, count) -> None:
    """One launch of `pcr_probe_compact`: the live entries of `stream`
    into the front of `out` (three int32 tensors as long), their number
    added to `count` (one int64)."""
    n = stream[0].numel()
    for name, t in zip(("pid", "dep", "pay", "out pid", "out dep", "out pay"), (*stream, *out)):
        check_cuda(name, t, torch.int32, (n,))
    check_cuda("count", count, torch.int64, (1,))
    COMPACT.launch(*(t.data_ptr() for t in (*stream, *out)), count.data_ptr(), n, size)


def compact(stream, size: int):
    """The live entries of `stream` (int32 CUDA tensors) in a dense
    prefix, in no order -> (pid, dep, pay) of the live count."""
    out = tuple(torch.empty_like(t) for t in stream)
    count = torch.zeros(1, dtype=torch.int64, device=stream[0].device)
    compact_launch(stream, size, out, count)
    live = int(count.item())
    return tuple(t[:live] for t in out)


def compact_plain(stream, size: int):
    """The live entries of `stream` in stream order: a boolean index."""
    live = widen(stream[0]) < size
    return tuple(t[live] for t in stream)


def rows_sort(stream, rows: int):
    """Sort each of `rows` equal rows of the stream by pid (as u32), the
    stream padded with dead entries (pid all ones) to a multiple of
    `rows` -> the rows laid end to end."""
    pad = (-stream[0].numel()) % rows
    pid, dep, pay = (torch.cat([t, t.new_full((pad,), -1 if k == 0 else 0)])
                     .reshape(rows, -1) for k, t in enumerate(stream))
    spid, order = torch.sort(pid ^ INT32_MIN, dim=1)  # signed order == u32 order
    return tuple(t.reshape(-1) for t in (spid ^ INT32_MIN, dep.gather(1, order),
                                         pay.gather(1, order)))


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """Each path on `stream` (unsorted int32 CUDA tensors), held to
    `u64_min_planes_plain`; prints a `[probe]` line for each; raises on a
    mismatch.  -> {path: {"select", "sort", "b6", "total"}: ms, "live":
    entries, "compact": the kernel alone, ms, "plain": compact_plain's ms}."""
    probes.require_cuda([stream])
    stream = tuple(t.reshape(-1) for t in stream)
    want = u64_min_planes_plain([stream], size)
    n = stream[0].numel()
    got, plain = compact(stream, size), compact_plain(stream, size)
    if not all(torch.equal(a, b) for a, b in zip(probes.sort_by_key3(*got),
                                                 probes.sort_by_key3(*plain))):
        raise AssertionError(f"r3_rows_prefix: the compaction of {label} != its plain version")
    live = plain[0].numel()
    selects = {"whole": None, "live-mask": lambda: compact_plain(stream, size),
               "live-kernel": lambda: compact(stream, size)}
    sorts = {**{p: sort_by_pid for p in selects},
             **{f"rows-{s}": lambda *x, s=s: rows_sort(x, s) for s in ROWS}}
    out = dict(live=live)
    for path in PATHS:
        select = selects.get(path)
        picked = stream if select is None else select()
        s = sorts[path](*picked)
        b6, b6_plane = probes.b6_alone(s, size)
        b6_plane.fill_(-1)
        b6()
        if not all(torch.equal(g, w) for g, w in zip(key_views(b6_plane), want)):
            raise AssertionError(f"r3_rows_prefix {path} on {label} != u64_min_planes_plain")
        res = dict(select=0.0 if select is None else probes.time_ms(select, reps),
                   sort=probes.time_ms(lambda: sorts[path](*picked), reps),
                   b6=probes.time_ms(b6, reps, lambda: b6_plane.fill_(-1)))
        res["total"] = res["select"] + res["sort"] + res["b6"]
        out[path] = res
        print(f"[probe] r3_rows_prefix {path} {label}: {picked[0].numel():,} of {n:,} entries "
              f"sorted (live share {live / n:.3f}); select {res['select']:.4f} ms, sort "
              f"{res['sort']:.4f}, B6 {res['b6']:.4f} on {s[0].numel():,} entries, total "
              f"{res['total']:.4f} ({res['total'] / out['whole']['total']:.2f}x whole); "
              f"bit-exact [{card}]")
    outs = tuple(torch.empty_like(t) for t in stream)
    count = torch.zeros(1, dtype=torch.int64, device=stream[0].device)
    out["compact"] = probes.time_ms(lambda: compact_launch(stream, size, outs, count), reps,
                                    count.zero_)
    out["plain"] = out["live-mask"]["select"]
    print(f"[probe] r3_rows_prefix compaction {label}: pcr_probe_compact {out['compact']:.4f} ms "
          f"device, one launch alone; the boolean index {out['plain']:.4f} with its read of the "
          f"count [{card}]")
    return out


def main(argv=None) -> int:
    return probes.b6_main("r3_rows_prefix", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
