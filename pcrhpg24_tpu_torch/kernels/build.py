"""Build and load the port's CUDA kernels (`csrc/*.cu`).

One `nvcc` per source, all started together, compiles the sources to
objects, and one more links them into a shared library with a plain C
interface (no PyTorch headers: seconds, not minutes), which `ctypes`
loads.  The build happens at first use, into
`build/torch_kernels/<hash>/` under the checkout, keyed by a hash of
the sources and flags, so a fresh checkout builds everything on its
first kernel call.

Numerics: `-fmad=false` keeps nvcc from contracting a*b+c into an FMA,
and no fast-math flag is ever passed — the depth key is the f32 bit
pattern of `w`, so the projection must round per op exactly like the
reference (`pallas_project.py:109-122`).

Every C entry point takes its pointers and the stream as `void*`, the
rest as `int` (a count as `long long`), and returns `cudaGetLastError()`
after its launch;
`Kernel.launch` raises if that is not 0 and counts the launch, inside a
`torch.profiler` range named by the C symbol (`pcr_*`) while a profiler
collects (`engine/timing.span`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..engine import timing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libpcr_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [  # per source, with -c
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
LINK_FLAGS = [*ARCH, "-shared"]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def files_hash(files, flags=()) -> str:
    """16 hex digits of the flags and the files' names and bytes."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *LINK_FLAGS, *flags]).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def source_hash() -> str:
    return files_hash(sources() + sorted(CSRC.glob("*.cuh")))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return found


def compile_library(srcs, headers, root: Path, lib_name: str,
                    flags=()) -> tuple[Path, float, str]:
    """Compile `srcs` (one nvcc each, all started together, with
    `NVCC_FLAGS` and `flags`) and link them into `root/<hash>/lib_name`,
    unless that hash, of the sources, the `headers` they include and the
    flags, has a build already.

    Returns (library path, seconds spent compiling — 0 when cached,
    nvcc's output including `-Xptxas -v` register/smem counts).
    """
    out_dir = root / files_hash([*srcs, *headers], flags)
    lib = out_dir / lib_name
    log = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = out_dir / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    text, failed = "", False
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        text += " ".join(cmd) + "\n" + out
        failed |= proc.returncode != 0
    tmp = out_dir / f".{lib_name}.{tag}"
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for _c, o, _p in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        text += " ".join(cmd) + "\n" + res.stdout + res.stderr
        failed = res.returncode != 0
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, seconds, text


@functools.lru_cache(maxsize=1)
def build() -> tuple[Path, float, str]:
    """Compile the library if its hash has no build yet: see
    `compile_library`."""
    return compile_library(sources(), sorted(CSRC.glob("*.cuh")), BUILD_ROOT, LIB_NAME)


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library; each exports `pcr_error_string`
    (`csrc/runtime.cu`)."""
    lib = ctypes.CDLL(str(path))
    lib.pcr_error_string.restype = ctypes.c_char_p
    lib.pcr_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    return open_library(build()[0])


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong


class Kernel:
    """One C entry point of the library and its launch count.

    `launches` is a plain integer: `launch` adds one after each
    successful launch and nothing else touches it but a caller that
    resets it to 0.  `library` loads the library that exports the symbol
    (default: the package's, `load`); `registry` is the dict it is
    entered into by symbol (default: `KERNELS`).
    """

    def __init__(self, symbol: str, argtypes: list, library=None, registry=None):
        self.symbol = symbol
        self.argtypes = argtypes
        self.library = library
        self.launches = 0
        (KERNELS if registry is None else registry)[symbol] = self

    def launch(self, *args) -> None:
        lib = (self.library or load)()
        fn = getattr(lib, self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*self.argtypes, P]  # stream last
        # the symbol names the launch in a torch.profiler trace
        with timing.span(self.symbol):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = lib.pcr_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


# every kernel wrapper of the package, by C symbol
KERNELS: dict[str, Kernel] = {}

# parts per launch of B3 and B4: their pointers ride in the kernel's
# parameters (`csrc/tiles.cuh`)
MAX_PARTS = 64


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def part_groups(parts):
    """Check every (pid, dep, pay) part (int32 CUDA tensors of one shape
    each) and yield, for each group of up to MAX_PARTS non-empty parts,
    the leading arguments of one launch over them: the addresses of the
    three host arrays of the parts' device pointers and of their entry
    counts, then the count.  The arrays live until the next yield."""
    live = []
    for pid, dep, pay in parts:
        for name, t in (("pid", pid), ("dep", dep), ("pay", pay)):
            check_cuda(name, t, torch.int32, pid.shape)
        if pid.numel():
            live.append((pid, dep, pay))
    for start in range(0, len(live), MAX_PARTS):
        group = live[start:start + MAX_PARTS]
        ptrs = [(ctypes.c_void_p * len(group))(*(t[k].data_ptr() for t in group))
                for k in range(3)]
        counts = (ctypes.c_longlong * len(group))(*(t[0].numel() for t in group))
        yield (*(ctypes.addressof(a) for a in ptrs), ctypes.addressof(counts), len(group))
