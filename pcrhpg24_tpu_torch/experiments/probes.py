"""What the probe modules share: their library, B3's variants, the plain
versions of their checksums, a device timer, the frames' parts and the
`.tpc` chunks the decoders' probes take.

The probes' CUDA sources (`*.cu` beside this file, `probes.cuh`, which
includes the package's `csrc/tiles.cuh`, and the decoders' device code in
`csrc/decode_native.cuh` and `csrc/decode_fixed.cuh`) build at first use, one
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
import re
import statistics
import subprocess
from pathlib import Path

import torch

from ..kernels.build import (BUILD_ROOT, CSRC, MAX_PARTS, I, Kernel, P, check_cuda,
                             compile_library, open_library, part_groups)
from ..render.raster import u64_min_planes_plain
from ..u32 import INT64_MAX, MASK32, biased_key, widen
from ..utils.devtime import SPIN_CYCLES

HERE = Path(__file__).resolve().parent
# the package's headers the probes include (`-I csrc`)
HEADERS = ("tiles.cuh", "async_copy.cuh", "decode_native.cuh", "decode_fixed.cuh")
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
XOR_FOLDS = ("floor", "noop")  # the other checksums add
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
