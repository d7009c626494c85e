"""What the probe modules share: their library, B3's variants, the plain
versions of their checksums, a device timer, the frames' parts and the
`.tpc` chunks the decoders' probes take.

The probes' CUDA sources (`*.cu` beside this file, `probes.cuh`, which
includes the package's `csrc/tiles.cuh` and B6's device code in
`csrc/merge.cuh`, and the decoders' in `csrc/decode_native.cuh` and
`csrc/decode_fixed.cuh`) build at first use, one
nvcc each in parallel with the package's flags (`kernels/build.py`,
`-fmad=false`), into `build/probes/<source hash>/libpcr_probes.so`,
and load with ctypes.  Each probe's C entry point is a `Kernel` of this
library, entered in `PROBES` (not the package's `KERNELS`), and counts
its launches.  A probe launches its kernel on CUDA tensors and raises on
any other: it has no plain fallback.  The plain versions here and in
the modules are what the kernels' results are held to.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
import re
import statistics
import subprocess
from pathlib import Path

import torch

from ..kernels.build import (BUILD_ROOT, CSRC, MAX_PARTS, I, Kernel, L, P, check_cuda,
                             compile_library, open_library, part_groups)
from ..render.raster import u64_min_planes_plain
from ..u32 import INT32_MIN, INT64_MAX, MASK32, biased_key, unbias_key, widen
from ..utils.devtime import SPIN_CYCLES

HERE = Path(__file__).resolve().parent
# the package's headers the probes include (`-I csrc`)
HEADERS = ("tiles.cuh", "async_copy.cuh", "decode_native.cuh", "decode_fixed.cuh", "merge.cuh")
PROBES: dict[str, Kernel] = {}  # the probes' kernels, by C symbol

# b3_probe's template values (`probes.cuh`)
LAYOUTS = {"chain": 0, "flat": 1}
LESIONS = {"full": 0, "atomic-all": 1, "no-atomic": 2, "floor": 3, "no-load": 4, "count": 5,
           "noop": 6, "combine": 7, "combine-count": 8, "combine-would-be": 9, "depth-pass": 10,
           "pay-pass": 11, "half-gather": 12}
# how a warp reads its tile (b3_probe's kForm): the shipped loads, the chain
# tile's row read into registers, or transposed by shuffles (16 columns at
# once, or 8 a pass), position tiles
FORMS = {"staged": 0, "rowload": 1, "shfl": 2, "position": 3, "rowload-8": 4, "shfl-8": 5}
SHIPPED_WIDTH = {"chain": 16, "flat": 8}  # chain tile columns, flat columns a pass
XOR_FOLDS = ("floor", "noop", "read-only", "grid")  # the other checksums add
SLOTS, SLOT_PITCH = 32, 32  # the checksum words
ROW = 1024  # entries of a chain row (`tiles::kRow`)
FLAT_TILE = 512  # entries of a flat tile
B3_ARGS = [I, I, I, P, P, P, P, I, P, I, P]  # layout, lesion, width, pcr_u64_min's, sums
B3_FORM_ARGS = [I, I, I, I, P, P, P, P, I, P, I, P]  # the same with the form after the width


@functools.lru_cache(maxsize=1)
def build() -> tuple[Path, float, str]:
    """Compile the probes' library if its hash has no build yet ->
    (library, seconds compiling, nvcc's log)."""
    return compile_library([*sorted(HERE.glob("*.cu")), CSRC / "runtime.cu"],
                           [HERE / "probes.cuh", *(CSRC / h for h in HEADERS)],
                           BUILD_ROOT.parent / "probes", "libpcr_probes.so",
                           ["-I", str(CSRC)])


@functools.lru_cache(maxsize=1)
def load():
    return open_library(build()[0])


def probe_kernel(symbol: str, argtypes: list) -> Kernel:
    return Kernel(symbol, argtypes, library=load, registry=PROBES)


def require_cuda(parts) -> None:
    """Raise unless every tensor of every part is on a card: a probe
    measures the card and has no plain fallback."""
    for part in parts:
        for t in part:
            if not t.is_cuda:
                raise ValueError(f"the probes run on a card: got a tensor on {t.device}")


def require_card(device) -> None:
    """Raise unless `device` is a card: a probe that makes its own inputs
    measures the card and has no plain fallback."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the probes run on a card, not on {device}")


def new_sums(device) -> torch.Tensor:
    return torch.zeros(SLOTS * SLOT_PITCH, dtype=torch.int32, device=device)


def launch_b3(kernel: Kernel, parts, size: int, layout: str, lesion: str, width: int,
              plane: torch.Tensor, sums: torch.Tensor, form: str | None = None) -> None:
    """One launch of b3_probe<layout, lesion, width> per group of up to 64
    parts into `plane` (`key_plane`) and the checksum words `sums`; a
    kernel whose C entry point takes a form (`B3_FORM_ARGS`) gets `form`
    (`FORMS`)."""
    check_cuda("plane", plane, torch.int64, (size,))
    check_cuda("sums", sums, torch.int32, (SLOTS * SLOT_PITCH,))
    head = [LAYOUTS[layout], LESIONS[lesion], width] + ([] if form is None else [FORMS[form]])
    for group in part_groups(parts):
        kernel.launch(*head, *group, plane.data_ptr(), size, sums.data_ptr())


def folded(sums: torch.Tensor, lesion: str) -> int:
    """The lesion's checksum: its slots XORed (floor, noop) or added (as
    u32 words)."""
    slots = widen(sums[::SLOT_PITCH])
    return xor_reduce(slots) if lesion in XOR_FOLDS else int(slots.sum()) & MASK32


def xor_reduce(x: torch.Tensor) -> int:
    """XOR of every element of an integer tensor, as a u32 value."""
    x = x.reshape(-1).to(torch.int64)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return int(x.sum()) & MASK32 if x.numel() else 0


# ---- plain versions of the lesions' checksums and streams ----

def tiles_of(n: int, layout: str, width: int) -> int:
    """Tiles of a part of n entries: chain tiles of `width` columns
    (32-row bands x 1024 / width column blocks), or flat tiles of 512."""
    if layout == "flat":
        return -(-n // FLAT_TILE)
    return -(-(-(-n // ROW)) // 32) * (ROW // width)


def live_parts(parts) -> list:
    """The parts a launch takes, in order: the non-empty ones."""
    return [p for p in parts if p[0].numel()]


def floor_plain(parts, layout: str, width: int) -> int:
    """The floor lesion's checksum: XOR of every (pid ^ dep ^ pay) loaded,
    and of pid all ones (dep and pay 0) for each entry of a tile past its
    part's end."""
    acc, pads = 0, 0
    for pid, dep, pay in live_parts(parts):
        n = pid.numel()
        acc ^= xor_reduce(pid.reshape(-1) ^ dep.reshape(-1) ^ pay.reshape(-1))
        pads += tiles_of(n, layout, width) * (FLAT_TILE if layout == "flat" else 32 * width) - n
    return acc ^ (MASK32 if pads % 2 else 0)


def would_be_plain(parts, size: int) -> int:
    """The no-atomic lesion's count: against a plane that stays EMPTY,
    every live entry whose key is not all ones."""
    count = 0
    for pid, dep, pay in live_parts(parts):
        ones = (dep == -1) & (pay == -1)
        count += int(((widen(pid) < size) & ~ones).sum())
    return count


def noop_plain(parts, layout: str, width: int) -> int:
    """The noop lesion's checksum: XOR over each launch's tiles of the
    tile's index in its part ^ (the part's index in the launch << 24)."""
    acc = 0
    for k, (pid, _dep, _pay) in enumerate(live_parts(parts)):
        local = torch.arange(tiles_of(pid.numel(), layout, width), dtype=torch.int64)
        acc ^= xor_reduce(local ^ ((k % MAX_PARTS) << 24))
    return acc


def mix(x: torch.Tensor) -> torch.Tensor:
    """`probes.cuh`'s lowbias32 hash on int64 tensors of u32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for u32 values x, without overflowing int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def as_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor of their bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def made_parts(parts, size: int) -> list:
    """The no-load lesion's entries as streams (its plain version): entry
    e of the k-th part of a launch has pixel h % size and depth
    mix(h ^ 0x5bd1e995), h = mix(e + k * 0x9e3779b9 mod 2**32), and
    payload e."""
    out = []
    for k, (pid, _dep, _pay) in enumerate(live_parts(parts)):
        e = torch.arange(pid.numel(), dtype=torch.int64, device=pid.device)
        h = mix((e + (k % MAX_PARTS) * 0x9E3779B9) & MASK32)
        out.append(tuple(as_u32_bits(x) for x in (h % size, mix(h ^ 0x5BD1E995), e & MASK32)))
    return out


def landed_pixels(planes) -> int:
    """Pixels a resolve's planes hold a key in (not EMPTY in both halves):
    the fewest atomics that could have produced them."""
    dep, pay = planes
    return int(((dep != -1) | (pay != -1)).sum())


def live_entries(parts, size: int) -> int:
    return sum(int((widen(p[0]) < size).sum()) for p in parts)


# ---- timing ----

def time_ms(fn, reps: int = 20, setup=None) -> float:
    """Median device ms of fn() over `reps` calls after one warm call,
    each enqueued behind a ~1 ms device spin so the events bracket device
    work alone; `setup()` runs before each call, outside the events (and
    before the spin)."""
    return statistics.median(paired_ms([fn], reps, setup)[0])


def paired_ms(fns, reps: int, setup=None) -> list[list[float]]:
    """Device ms of each of `fns` in turns, `reps` rounds (after one warm
    round), each call as in `time_ms` -> one list of times per fn."""
    times = [[] for _ in fns]
    for rep in range(reps + 1):
        for k, fn in enumerate(fns):
            if setup:
                setup()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            if rep:
                times[k].append(e0.elapsed_time(e1))
    return times


def amin_library(parts, size: int):
    """The one PyTorch call that computes B3's planes,
    `scatter_reduce_(..., "amin")` of the biased keys, on inputs prepared
    here -> (that call, a setup that resets its plane)."""
    pid = torch.cat([widen(p[0].reshape(-1)) for p in parts])
    idx = torch.where(pid < size, pid, torch.full_like(pid, size))
    keys = torch.cat([biased_key(p[1].reshape(-1), p[2].reshape(-1)) for p in parts])
    plane = torch.empty(size + 1, dtype=torch.int64, device=pid.device)
    return (lambda: plane.scatter_reduce_(0, idx, keys, reduce="amin"),
            lambda: plane.fill_(INT64_MAX))


def plain_ms(parts, size: int, reps: int = 3) -> float:
    """Device ms of the plain version `u64_min_planes_plain` on the parts."""
    return time_ms(lambda: u64_min_planes_plain(parts, size), reps)


# ---- the card and the frames' parts, for the modules' `main` ----

def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def views() -> dict:
    """bench.py's three views and the `.tpc` corner close-up (as
    `chip_smoke.py` renders them), and the Potree views of
    `tools/profile_frame.py`."""
    from ..engine.renderer import Setting
    from ..tools.profile_frame import VIEWS

    tpc = {k: VIEWS[k] for k in ("orbit", "closeup", "oblique")}
    tpc["tpc corner"] = Setting(yaw=0.3, pitch=-0.9, radius=50.0,
                                target=(1900.0, 1850.0, 50.0))
    return {**tpc, **{k: VIEWS[k] for k in ("steady", "overview", "corner")}}


def scene_parts(scene: str, view, width: int = 1920, height: int = 1080,
                device: str = "cuda"):
    """The parts a colour frame of `scene` at `view` (a `Setting`) hands
    B3, at LOD 1.0 -> (parts, plane size, layout): a `.tpc` frame's live
    chunks (chain rows, swizzled pixels), a `.las` scene's `loop_las`
    parts or a Potree directory's `loop_nodes` parts (flat, linear
    pixels)."""
    from ..app import build_methods, wait_loaded
    from ..engine.debug import Debug
    from ..engine.method import Runtime
    from ..engine.renderer import Renderer
    from ..render.methods.huffman_tpu import frame_streams
    from ..render.methods.loop_las import loop_las_parts
    from ..render.methods.loop_nodes import node_parts

    Debug.lod = 1.0
    r = Renderer(width, height, device)
    r.apply_setting(view)
    m = build_methods(r, scene)[0]
    wait_loaded(m, r)
    r.controls_update()
    if scene.endswith(".tpc"):
        parts, size, _dev = frame_streams(**m.frame_args(r))
        layout = "chain"
    elif scene.endswith(".las"):
        parts = loop_las_parts(**{k: v for k, v in m.frame_args(r).items() if k != "hqs"})
        size, layout = width * height, "flat"
    else:
        parts = list(node_parts(**m.frame_args(r, m.frame_tables(r, cull=True))))
        size, layout = width * height, "flat"
    Runtime.clear()
    return parts, size, layout


SMOKE_SCENES = ("out/chip_smoke_256_v2.tpc", "out/chip_smoke_256.las")


def parts_main(stem: str, run, doc: str, argv=None, layout: bool = False) -> int:
    """A probe module's `main`: `run(label, parts, size, card)` on each
    `--scene`'s frame parts at `--view`, and for a `.tpc` scene first on
    its most populated chunk alone; the card line last.  With `layout`,
    `run` also gets the parts' layout (`layout=`)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--scene", action="append", default=None,
                    help="a .tpc, .las or Potree scene (repeatable; default: the smoke's "
                         ".tpc v2 and .las at 256 batches under out/)")
    ap.add_argument("--view", default="orbit", choices=sorted(views()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{stem}: no card", file=sys.stderr)
        return 1
    card = card_line()
    for scene in args.scene or [p for p in SMOKE_SCENES if os.path.exists(p)]:
        parts, size, kind = scene_parts(scene, views()[args.view])
        name = f"{os.path.basename(scene)} {args.view}"
        kw = {"layout": kind} if layout else {}
        if kind == "chain":
            run(f"{name} chunk", [busiest(parts, size)], size, card, **kw)
        run(f"{name} frame's {len(parts)} parts", parts, size, card, **kw)
    print(card)
    return 0


def busiest(parts, size: int):
    """The part with the most live entries (a frame's most populated
    chunk)."""
    return max(parts, key=lambda p: int((widen(p[0]) < size).sum()))


# ---- the decoders' probes: ptxas's resources of an instance, the chunks ----

def ptxas_instances(log: str) -> dict:
    """ptxas's lines for each kernel entry of an nvcc `-Xptxas -v` log ->
    {mangled entry name: dict(lines, registers, smem, stack, spill_stores,
    spill_loads)}: the lines after its "Compiling entry function" up to
    the next one."""
    out, name = {}, None
    fields = {"registers": r"(\d+) registers", "smem": r"(\d+) bytes smem",
              "stack": r"(\d+) bytes stack frame", "spill_stores": r"(\d+) bytes spill stores",
              "spill_loads": r"(\d+) bytes spill loads"}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(lines=[], **{k: 0 for k in fields})
            continue
        if name is None or not line.strip() or line.startswith(("nvcc", "/")):
            continue
        if "Compiling" in line or "bytes gmem" in line:
            name = None
            continue
        out[name]["lines"].append(line.strip())
        for key, pattern in fields.items():
            found = re.search(pattern, line)
            if found:
                out[name][key] = int(found.group(1))
    return out


def instance_resources(pattern: str, log: str | None = None) -> dict:
    """The ptxas resources of the probe library's kernel instances whose
    mangled name matches `pattern` (a regex whose groups are the
    template arguments) -> {groups: resources}."""
    log = build()[2] if log is None else log
    return {m.groups(): res for name, res in ptxas_instances(log).items()
            if (m := re.search(pattern, name))}


def busiest_chunk(frame_args: dict) -> slice:
    """The 64-batch chunk of a `.tpc` frame with the most points in view
    (the batches' LOD counts summed, as `chip_smoke.py` picks the chunk
    its gates time), from `huffman_tpu.frame_args` -> its batch slice."""
    from ..render.camera import frame_setup_device
    from ..render.methods.huffman_tpu import CHUNK

    a, fp = frame_args, frame_args["frame_params"]
    dev = a["dev"]
    lod_n = torch.clamp(frame_setup_device(
        fp[0:16].reshape(4, 4), fp[16:22], dev["bbox_min"], dev["bbox_max"],
        fp[23].to(torch.int32), a["width"], a["height"], fp[22], True), max=a["points"])
    c = int(lod_n[: a["nchunks"] * CHUNK].reshape(-1, CHUNK).sum(1).argmax())
    return slice(c * CHUNK, (c + 1) * CHUNK)


def chunk_args(frame_args: dict, sl: slice) -> dict:
    """A chunk's decoder and projection inputs from a `.tpc` frame's
    `frame_args`: the batches' dev arrays (B1's or B5's keys, the colours
    and anchors), their folded translations `tb`, and `frame12` (the wvp
    rows 0, 1 and 3 by columns 0..2, then the scale), as `frame_streams`
    hands them to B2."""
    dev, fp = frame_args["dev"], frame_args["frame_params"]
    keys = ("widths", "lj", "streams", "ptrs", "dD", "lut", "starts", "colors_k", "anchor")
    out = {k: dev[k][sl] for k in keys if k in dev}
    t = fp[24:40].reshape(4, 4)
    out["tb"] = frame_args["tb"][sl]
    out["frame12"] = torch.cat([t[0, :3], t[1, :3], t[3, :3], frame_args["scale"][:3]])
    return out


def tpc_chunk(scene: str, view: str = "orbit", width: int = 1920, height: int = 1080,
              device: str = "cuda") -> tuple[dict, str]:
    """`chunk_args` of a `.tpc` scene's busiest 64-batch chunk at `view`
    (LOD 1.0) -> (dict, label)."""
    from ..app import build_methods, wait_loaded
    from ..engine.debug import Debug
    from ..engine.method import Runtime
    from ..engine.renderer import Renderer

    Debug.lod = 1.0
    r = Renderer(width, height, device)
    r.apply_setting(views()[view])
    m = build_methods(r, scene)[0]
    wait_loaded(m, r)
    r.controls_update()
    a = m.frame_args(r)
    sl = busiest_chunk(a)
    chunk = chunk_args(a, sl)
    Runtime.clear()
    return chunk, f"{os.path.basename(scene)} {view} chunk {sl.start // (sl.stop - sl.start)}"


# ---- B6's variants (`csrc/merge.cuh`), their plain versions, the sorts ----

B6_LESIONS = {"full": 0, "no-atomic": 1, "read-only": 2, "grid": 3, "count": 4}
B6_LOADS = {"arrays": 0, "interleaved": 1}
B6_CUTS = {"uniform": 1, "distinct": 2, "early": 4, "gather-first": 8}
B6_HEADS = {"warp": 0, "run": 1}
# lesion, steps, groups, stages, load, cut, head; pcr_merge_nk1's; the sums
B6_ARGS = [I, I, I, I, I, I, I, P, P, P, P, L, I, P]
SHIPPED_TOLERANCE = 0.03  # a variant that restates a shipped kernel, same call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet: the bounds' rate


@dataclass(frozen=True)
class B6:
    """One variant of B6's body: `csrc/merge.cuh`'s template values by
    name.  The defaults are the shipped kernel; `steps=0` is no scan."""

    lesion: str = "full"
    steps: int = 5
    groups: int = 1
    stages: int = 0
    load: str = "arrays"
    cuts: tuple = ()
    head: str = "warp"

    def args(self) -> list:
        return [B6_LESIONS[self.lesion], self.steps, self.groups, self.stages,
                B6_LOADS[self.load], sum(B6_CUTS[c] for c in self.cuts), B6_HEADS[self.head]]


def launch_b6(kernel: Kernel, variant: B6, stream, size: int, plane: torch.Tensor,
              sums: torch.Tensor) -> None:
    """One launch of `variant` over `stream`, int32 CUDA tensors: (pid,
    dep, pay) of one length, or for the interleaved load the one (n, 4)
    array of `interleave`; into `plane` (`key_plane`) and the checksum
    words `sums`."""
    check_cuda("plane", plane, torch.int64, (size,))
    check_cuda("sums", sums, torch.int32, (SLOTS * SLOT_PITCH,))
    if variant.load == "interleaved":
        (rows,) = stream
        check_cuda("rows", rows, torch.int32, (rows.shape[0], 4))
        if rows.data_ptr() % 16:
            raise ValueError("the interleaved rows must start on a 16-byte boundary")
        ptrs, n = [rows.data_ptr()] * 3, rows.shape[0]
    else:
        pid = stream[0]
        for name, t in zip(("pid", "dep", "pay"), stream):
            check_cuda(name, t, torch.int32, (pid.numel(),))
        ptrs, n = [t.data_ptr() for t in stream], pid.numel()
    kernel.launch(*variant.args(), *ptrs, plane.data_ptr(), n, size, sums.data_ptr())


def interleave(stream) -> torch.Tensor:
    """(pid, dep, pay) -> the (n, 4) int32 rows (pid, dep, pay, 0) of the
    interleaved load."""
    pid, dep, pay = (t.reshape(-1) for t in stream)
    return torch.stack([pid, dep, pay, torch.zeros_like(pid)], 1).contiguous()


def sort_by_key3(pid, dep, pay):
    """Sort a stream by (pid, depth, payload) as u32: three stable sorts,
    least significant key first (B8's input, `lax.sort(num_keys=3)`)."""
    order = None
    for k in (pay, dep, pid):
        k = k.reshape(-1) ^ INT32_MIN  # signed order == u32 order
        _, idx = torch.sort(k if order is None else k[order], stable=True)
        order = idx if order is None else order[idx]
    return tuple(x.reshape(-1)[order] for x in (pid, dep, pay))


def sort_by_key2(pid, dep, pay):
    """The order of `sort_by_key3` in two stable sorts: by the biased u64
    key (depth << 32 | payload), then by pid as u32."""
    _, order = torch.sort(biased_key(dep.reshape(-1), pay.reshape(-1)), stable=True)
    _, idx = torch.sort(pid.reshape(-1)[order] ^ INT32_MIN, stable=True)
    order = order[idx]
    return tuple(x.reshape(-1)[order] for x in (pid, dep, pay))


def warp_segments(pid: torch.Tensor):
    """B6's warp-local run segments of a stream: maximal stretches of one
    pid within an aligned warp of 32 entries -> (each entry's pid as u32
    (int64), its position in its segment, whether it heads one)."""
    q = widen(pid.reshape(-1))
    e = torch.arange(q.numel(), device=q.device)
    head = (e % 32) == 0
    head[1:] |= q[1:] != q[:-1]
    start = torch.cummax(torch.where(head, e, torch.zeros_like(e)), 0).values
    return q, e - start, head


def warp_runs_plain(pid: torch.Tensor, size: int) -> int:
    """The stream's longest segment of a live pid (< size) within an
    aligned warp of 32 entries: B6's scan is exact at any depth whose
    2**steps covers it (the card's `pm._runs_bounded`, pallas_merge.py:662)."""
    q, pos, _head = warp_segments(pid)
    live = q < size
    return int(pos[live].max()) + 1 if bool(live.any()) else 0


def steps_needed(runs: int) -> int:
    """The fewest doubling steps whose 2**steps covers `runs` entries."""
    return max(runs - 1, 0).bit_length()


def truncated_plain(stream, size: int, steps: int):
    """The planes of B6 at `steps` doubling steps: each warp-local head
    takes the min of the first 2**steps entries of its segment, and the
    heads min-combine per pixel."""
    pid, dep, pay = (t.reshape(-1) for t in stream)
    _q, pos, _head = warp_segments(pid)
    kept = torch.where(pos < (1 << steps), pid, torch.full_like(pid, -1))  # -1: all ones
    return u64_min_planes_plain([(kept, dep, pay)], size)


def heads_fold_plain(stream, size: int) -> int:
    """The no-atomic lesion's checksum: over the live warp-local heads,
    the sum (mod 2**32) of hi ^ lo of their segment's min key."""
    pid, dep, pay = (t.reshape(-1) for t in stream)
    q, _pos, head = warp_segments(pid)
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    nseg = int(seg[-1]) + 1 if seg.numel() else 0
    best = torch.full((nseg,), INT64_MAX, dtype=torch.int64, device=q.device)
    best.scatter_reduce_(0, seg, biased_key(dep, pay), reduce="amin")
    key = unbias_key(best[seg[head & (q < size)]])
    return int(((key >> 32) ^ key).remainder(2**32).sum()) & MASK32


def read_plain(stream) -> int:
    """The read-only lesion's checksum: XOR of every pid ^ dep ^ pay."""
    pid, dep, pay = (t.reshape(-1) for t in stream)
    return xor_reduce(pid ^ dep ^ pay)


def grid_plain(n: int) -> int:
    """The grid lesion's checksum: XOR of the entry indices 0 .. n - 1."""
    if n == 0:
        return 0
    m = n - 1
    return (m, 1, m + 1, 0)[m % 4] & MASK32


def count_plain(stream, size: int) -> int:
    """The count lesion's atomics with no cut: one for each live warp-local
    head."""
    q, _pos, head = warp_segments(stream[0])
    return int((head & (q < size)).sum())


def warp_shapes(stream, size: int) -> dict:
    """What B6's cuts key on, per aligned warp of 32 entries: warps that
    are one run ("uniform"), warps whose lanes all head a segment
    ("distinct"), and all warps; and the segments' longest live run.  The
    lanes past the stream's end hold pid all ones, as in the kernel."""
    pid = stream[0].reshape(-1)
    pad = (-pid.numel()) % 32
    _q, _pos, head = warp_segments(torch.cat([pid, pid.new_full((pad,), -1)]))
    heads = head.reshape(-1, 32).sum(1)
    return dict(warps=heads.numel(), uniform=int((heads == 1).sum()),
                distinct=int((heads == 32).sum()), runs=warp_runs_plain(stream[0], size))


def b6_alone(stream, size: int, plane: torch.Tensor | None = None):
    """The shipped B6 (`pcr_merge_nk1`) as one launch alone over `stream`
    into `plane` (a new one if None) -> (the launch, its plane): time it
    with `plane.fill_(-1)` as the setup."""
    from ..render.merge import MERGE_NK1

    pid, dep, pay = stream
    if plane is None:
        plane = torch.full((size,), -1, dtype=torch.int64, device=pid.device)
    return (lambda: MERGE_NK1.launch(pid.data_ptr(), dep.data_ptr(), pay.data_ptr(),
                                     plane.data_ptr(), pid.numel(), size)), plane


def run_b6(stem: str, kernel: Kernel, label: str, stream, size: int, variants: dict,
           expect: dict, reps: int = 20, inputs: dict | None = None) -> dict:
    """Launch each of `variants` ({name: B6}) once on `stream` (pid-sorted,
    int32 CUDA tensors) and hold it to `expect[name]`: a pair of planes
    bit for bit, a u32 checksum, or a (least, most) pair of ints that a
    count depending on the order warps run in must lie between (both
    included); `inputs[name]` replaces the stream of
    a variant that reads another form of it.  Then time each, one launch
    alone (device ms, median of `reps`, from an EMPTY plane), and `full`,
    if present, in turns with the shipped `pcr_merge_nk1`.  Raises on a
    mismatch or if `full` is more than 3% off the shipped kernel.
    -> {name: ms, "shipped": ms (with full), name + " sum": checksum}."""
    from ..render.raster import key_views

    require_cuda([stream])
    device = stream[0].device
    inputs = inputs or {}
    plane = torch.full((size,), -1, dtype=torch.int64, device=device)
    sums = new_sums(device)

    def reset():
        plane.fill_(-1)
        sums.zero_()

    def launch(name):
        return lambda: launch_b6(kernel, variants[name], inputs.get(name, stream), size,
                                 plane, sums)

    out = {}
    for name, want in expect.items():
        reset()
        launch(name)()
        if isinstance(want, int) or isinstance(want[0], int):
            got = folded(sums, variants[name].lesion)
            out[f"{name} sum"] = got
            if got != want if isinstance(want, int) else not want[0] <= got <= want[1]:
                raise AssertionError(f"{stem} {name} on {label}: checksum {got} is not the "
                                     f"plain version's {want}")
        elif not all(torch.equal(g, w) for g, w in zip(key_views(plane), want)):
            raise AssertionError(f"{stem} {name} on {label} != its plain version")
    for name in variants:
        if name != "full":
            out[name] = time_ms(launch(name), reps, reset)
    if "full" in variants:
        # one plane for both: a second 16.6 MB plane filled beside it would
        # leave one of the two partly out of L2
        shipped, _plane = b6_alone(stream, size, plane)
        full, ship = paired_ms([launch("full"), shipped], reps, reset)
        out["full"], out["shipped"] = statistics.median(full), statistics.median(ship)
        off = out["full"] / out["shipped"] - 1
        if abs(off) > SHIPPED_TOLERANCE:
            raise AssertionError(f"{stem} full on {label}: {out['full']:.4f} ms is {off:+.1%} "
                                 f"off the shipped kernel's {out['shipped']:.4f}")
    return out


def stream_bytes(stream) -> int:
    return sum(t.numel() * t.element_size() for t in stream)


def b6_streams(scenes, width: int = 1920, height: int = 1080, device: str = "cuda") -> list:
    """The unsorted (pid, depth, payload) streams B6's probes take, one for
    each of `scenes` -> [(label, stream, plane size)]: "parametric" is the
    sphere at the near camera; a `.wg` file its orbit frame; a `.las` file
    or Potree directory its orbit or steady parts (`scene_parts`) laid end
    to end as one stream.  The cameras are `tools/profile_frame.VIEWS`',
    the ones `chip_smoke.py` renders."""
    from ..engine.renderer import Renderer
    from ..render.methods.loop_nodes_compressed import WgData, wg_points
    from ..render.methods.parametric import Parametric, surface_points
    from ..render.raster import project_points
    from ..tools.profile_frame import VIEWS

    out = []
    size = width * height
    for scene in scenes:
        r = Renderer(width, height, device)
        if scene == "parametric":
            r.apply_setting(VIEWS["near"])
            r.controls_update()
            m = Parametric(r)
            fx, fy, fz, rgba = surface_points(m.surface, r.device)
            pid, dep = project_points(fx, fy, fz, m.transform(r), width, height)
            out.append(("parametric near", (pid, dep, rgba), size))
        elif scene.endswith(".wg"):
            r.apply_setting(VIEWS["orbit"])
            r.controls_update()
            d = WgData.create(scene, device).wait_loaded().dev
            wvp = torch.from_numpy(r.camera.view_proj().astype("float32")).to(device)
            pid, dep = project_points(*wg_points(d["words"], d["bits"], d["base_bit"],
                                                 d["bmin"], d["bmax"]), wvp, width, height)
            pay = torch.arange(pid.numel(), dtype=torch.int32, device=device)
            out.append((f"{os.path.basename(scene)} orbit", (pid, dep, pay), size))
        else:
            view = "orbit" if scene.endswith(".las") else "steady"
            parts, size_, _layout = scene_parts(scene, views()[view], width, height, device)
            stream = tuple(torch.cat([p[k].reshape(-1) for p in parts]) for k in range(3))
            out.append((f"{os.path.basename(scene.rstrip('/'))} {view}", stream, size_))
    return out


def b6_main(stem: str, run, doc: str, argv=None, default=("parametric",)) -> int:
    """A B6 probe module's `main`: `run(label, stream, size, card)` on each
    `--scene`'s stream (`b6_streams`); the card line last."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--scene", action="append", default=None,
                    help="'parametric', a .wg, a .las or a Potree directory (repeatable; "
                         "default: parametric and the smoke's .wg and .las under out/)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{stem}: no card", file=sys.stderr)
        return 1
    card = card_line()
    scenes = args.scene or [*default, *(p for p in ("out/chip_smoke_256.wg",
                                                     "out/chip_smoke_256.las")
                                        if os.path.exists(p))]
    for label, stream, size in b6_streams(scenes):
        run(label, stream, size, card)
    print(card)
    return 0
