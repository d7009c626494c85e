"""Head stores after a full-key sort, against B6 after a pid sort and B3
on the unsorted stream: the card's counterpart of the TPU probe
`experiments/r3_matscatter.py` (pallas_calls at :237 and :294).

The TPU probe sorted its rows by the full key (pid, dep, pay), so that
each pid run's first entry is its pixel's exact minimum, and then
scattered the run heads into the tile by a head-masked one-hot matmul
(`make_matscatter`, :237), against B6 with no suffix-min on the same
rows (`pm._merge_nk1_kernel_ilp(suffix_steps=0)`, :294).  The card's
question is the same: does a sort by the full key and a store of each
run's head beat the shipped resolves?  `r3_matscatter.cu` builds two
instances of B6's body (`csrc/merge.cuh`):

- atomic-head: B6 with no scan; each warp-local head's own key goes to
  one atomicMin (exact on a key-sorted stream; its plain version is
  `probes.truncated_plain(0)`);
- store-head: each head of a run of the whole stream (i == 0 or
  pid[i - 1] != pid[i]) stores its key with one plain u64 store (exact
  only on one stream sorted by the full key; its plain version is B8's,
  `merge.dense_from_sorted_plain`).

The sorts, each timed alone: pid (`raster.sort_by_pid`, the shipped
sort), key3 (three stable sorts: payload, depth, pid) and key2 (two
stable sorts: the biased u64 key, then pid; asserted equal to key3 on
every stream).  The resolves, each one launch alone from an EMPTY plane:
atomic-head and store-head on the key-sorted stream, the shipped B6
(`pcr_merge_nk1`) on the key-sorted and on the pid-sorted stream, the
shipped B8 (`pcr_merge_heads`) on the key-sorted stream, and the shipped
flat B3 (`pcr_u64_min_flat`) on the unsorted stream.  Every path's planes
are held bit-exact to `u64_min_planes_plain` of the unsorted stream, and
each path's sort + resolve is printed beside flat B3 with no sort.  On a
host with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_matscatter \\
        [--scene parametric --scene out/chip_smoke_256.wg --scene out/chip_smoke_256.las]

(`chip_smoke.py` runs it on the parametric near stream, the `.wg` orbit
stream, the `.las` orbit part and Potree 5e7's steady parts laid end to
end: store-head needs one globally sorted stream.)
"""

from __future__ import annotations

import sys

import torch

from ..render.merge import MERGE_HEADS, dense_from_sorted_plain
from ..render.raster import (key_plane, key_views, sort_by_pid, u64_min_planes,
                             u64_min_planes_plain)
from . import probes
from .probes import B6

HEADS = probes.probe_kernel("pcr_probe_heads", probes.B6_ARGS)
VARIANTS = {"atomic-head": B6(steps=0), "store-head": B6(steps=0, head="run")}
# their plain versions on a stream sorted by the full key
PLAIN = {"atomic-head": lambda s, size: probes.truncated_plain(s, size, 0),
         "store-head": lambda s, size: dense_from_sorted_plain(*s, size)}
SORTS = {"pid": sort_by_pid, "key3": probes.sort_by_key3, "key2": probes.sort_by_key2}
# each resolve: the sort it takes (None: the unsorted stream)
RESOLVES = {"flat B3": None, "B6": "pid", "B6 on key": "key", "B8": "key",
            "atomic-head": "key", "store-head": "key"}


def heads(variant: str, s, size: int, plane, sums) -> None:
    """One launch of atomic-head or store-head over the key-sorted `s`."""
    probes.launch_b6(HEADS, VARIANTS[variant], s, size, plane, sums)


def run(label: str, stream, size: int, card: str, reps: int = 20) -> dict:
    """Each sort and each resolve on `stream` (unsorted int32 CUDA
    tensors), every path held bit-exact to `u64_min_planes_plain` of the
    stream; prints a `[probe]` line for each and each path's total;
    raises on a mismatch or if key2's order is not key3's.  -> {"sorts":
    {sort: ms}, "resolves": {resolve: ms}, "totals": {path: ms}}."""
    probes.require_cuda([stream])
    stream = tuple(t.reshape(-1) for t in stream)
    device = stream[0].device
    want = u64_min_planes_plain([stream], size)
    by = {k: f(*stream) for k, f in SORTS.items()}
    if not all(torch.equal(a, b) for a, b in zip(by["key2"], by["key3"])):
        raise AssertionError(f"r3_matscatter {label}: key2's order is not key3's")
    sorts = {k: probes.time_ms(lambda f=f: f(*stream), reps) for k, f in SORTS.items()}
    inputs = {None: stream, "pid": by["pid"], "key": by["key2"]}
    plane, sums = key_plane(size, device), probes.new_sums(device)
    fb = torch.empty((2, size), dtype=torch.int32, device=device)  # B8's planes
    b6_pid, b6_pid_plane = probes.b6_alone(by["pid"], size)
    b6_key, b6_key_plane = probes.b6_alone(by["key2"], size)
    ks = by["key2"]
    launches = {  # (launch, reset, its planes)
        "flat B3": (lambda: u64_min_planes([stream], size, plane=plane, layout="flat"),
                    lambda: plane.fill_(-1), lambda: key_views(plane)),
        "B6": (b6_pid, lambda: b6_pid_plane.fill_(-1), lambda: key_views(b6_pid_plane)),
        "B6 on key": (b6_key, lambda: b6_key_plane.fill_(-1), lambda: key_views(b6_key_plane)),
        "B8": (lambda: MERGE_HEADS.launch(*(t.data_ptr() for t in ks), fb[0].data_ptr(),
                                          fb[1].data_ptr(), ks[0].numel(), size),
               lambda: fb.fill_(-1), lambda: (fb[0], fb[1])),
        **{v: (lambda v=v: heads(v, ks, size, plane, sums), lambda: plane.fill_(-1),
               lambda: key_views(plane)) for v in VARIANTS},
    }
    resolves = {}
    for name, (launch, reset, planes) in launches.items():
        reset()
        launch()
        if not all(torch.equal(g, w) for g, w in zip(planes(), want)):
            raise AssertionError(f"r3_matscatter {name} on {label} != u64_min_planes_plain")
        resolves[name] = probes.time_ms(launch, reps, reset)
    key_sort = min(("key2", "key3"), key=sorts.get)
    totals = {name: resolves[name] + (0.0 if RESOLVES[name] is None else
                                      sorts["pid" if RESOLVES[name] == "pid" else key_sort])
              for name in RESOLVES}
    n = stream[0].numel()
    print(f"[probe] r3_matscatter sorts {label} ({n:,} entries): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorts.items())
          + f"; key2's order equals key3's [{card}]")
    for name, sort in RESOLVES.items():
        what = ("no sort" if sort is None else
                f"{'pid' if sort == 'pid' else key_sort} sort {totals[name] - resolves[name]:.4f}")
        print(f"[probe] r3_matscatter {name} {label}: resolve {resolves[name]:.4f} ms device, "
              f"one launch alone; {what}; total {totals[name]:.4f} ms, "
              f"{totals[name] / totals['flat B3']:.2f}x flat B3; bit-exact [{card}]")
    best = min((k for k in RESOLVES if RESOLVES[k]), key=totals.get)
    verdict = "beats" if totals[best] < totals["flat B3"] else "does not beat"
    print(f"[probe] r3_matscatter {label}: the best sorted path, {best} "
          f"({totals[best]:.4f} ms), {verdict} flat B3 with no sort ({totals['flat B3']:.4f} "
          f"ms) [{card}]")
    return dict(sorts=sorts, resolves=resolves, totals=totals)


def main(argv=None) -> int:
    return probes.b6_main("r3_matscatter", run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
