"""Variants of B3's and B4's flat layout, timed on the same parts: the
evidence behind the choices of the flat design.

`flat_variants.cu`, beside this file, rebuilds the shipped flat kernels
(variant 0 of each) and, for each choice, a kernel that makes it the
other way:

- B3: plane words through L2 only (`__ldcg`) in place of L1 (`__ldca`);
  one pass of 16 columns in place of two of 8; a drop of keys that the
  next lane beats on the same pixel.
- B4: four atomics a lane, or `__match_any_sync` groups combined before
  the atomics, in place of a quad of lanes adding one entry's row.

`run` holds every variant's planes bit-exact against the plain versions
on the card, times one launch alone behind a device spin; the build prints
ptxas's registers and spills for each instance.  The library builds at
first use into `build/flat_variants/`; the package's kernels do
not include it.  On a host with a card:

    python3 chip_smoke.py --flat-variants

runs it on the `loop_las` orbit frame's parts and the Potree steady
frame's parts after the smoke's kernel times.
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
from pathlib import Path

import torch

from ..kernels.build import BUILD_ROOT, CSRC, NVCC_FLAGS, nvcc_path, part_groups
from ..render.hqs import hqs_sums_plain
from ..render.raster import key_plane, key_views, u64_min_planes_plain

SOURCE = Path(__file__).with_suffix(".cu")
B3_VARIANTS = ("shipped: two passes of 8 columns, L1 gathers", "L2 gathers (__ldcg)",
               "one pass of 16 columns", "drop keys the next lane beats")
B4_VARIANTS = ("shipped: a quad of lanes a row", "four atomics a lane",
               "__match_any_sync groups")


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build and load the variants' library; print ptxas's registers and
    spills for each instance."""
    out = BUILD_ROOT.parent / "flat_variants"
    lib = out / "libpcr_flat_variants.so"
    out.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-shared",
                          str(SOURCE), "-o", str(lib)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{res.stdout}{res.stderr}")
    for line in ptxas_lines(res.stdout + res.stderr):
        print(f"[variant ptxas] {line}")
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.pcr_probe_b3.argtypes = [I, P, P, P, P, I, P, I, P]
    dll.pcr_probe_b4.argtypes = [I, P, P, P, P, I, P, P, I, P]
    dll.pcr_probe_b3.restype = dll.pcr_probe_b4.restype = I
    return dll


def ptxas_lines(log: str) -> list[str]:
    """One line per variant instance: its mangled name, registers and
    spill bytes, from ptxas's -v output."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*_variant\S*)'", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            lines.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}; {spill}")
            name = None
    return lines


def _launch(fn, v: int, parts, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for group in part_groups(parts):
        err = fn(v, *group, *args, stream)
        if err != 0:
            raise RuntimeError(f"{fn.__name__} variant {v}: CUDA error {err}")


def run(label: str, parts, colour, fb, size: int, time_ms, card: str) -> dict:
    """Every variant on flat `parts` (B3) and `colour` (B4: the same parts
    with the colours as payload, against the depth plane `fb`), held to
    the plain versions and timed with `time_ms(fn, spin=True, setup=)`
    -> {(kernel, variant name): device ms}; prints a line for each."""
    dll = load()
    want = u64_min_planes_plain(parts, size)
    want4 = hqs_sums_plain(colour, fb, size)
    plane = key_plane(size, fb.device)
    acc = torch.zeros((size, 4), dtype=torch.int32, device=fb.device)
    times = {}
    for kernel, names, fill, launch, planes, ref in (
            ("B3", B3_VARIANTS, lambda: plane.fill_(-1),
             lambda v: _launch(dll.pcr_probe_b3, v, parts, plane.data_ptr(), size),
             lambda: key_views(plane), want),
            ("B4", B4_VARIANTS, acc.zero_,
             lambda v: _launch(dll.pcr_probe_b4, v, colour, fb.data_ptr(), acc.data_ptr(),
                               size),
             lambda: tuple(acc[:, k] for k in range(4)), want4)):
        for v, name in enumerate(names):
            fill()
            launch(v)
            exact = all(torch.equal(g, w) for g, w in zip(planes(), ref))
            if not exact:
                raise AssertionError(f"{kernel} variant '{name}' != plain on {label}")
            ms = time_ms(lambda v=v: launch(v), spin=True, setup=fill)
            times[(kernel, name)] = ms
            print(f"[variant] {label} {kernel} {name}: {ms:.4f} ms device (one launch "
                  f"alone), bit-exact; {ms / times[(kernel, names[0])]:.2f}x the shipped "
                  f"design [{card}]")
    return times
