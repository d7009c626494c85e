"""Which faster f32 forms keep B2's bits: the card's counterpart of the TPU
probe `experiments/r3_div_parity.py` (pallas_calls at :32, `kernel`, and
:62, `kernel2`).

The TPU probe asked whether Mosaic's f32 `1/w`, `x * (1/w)`, the int32
cast of `(x * inv) * 0.5 * 1920`, `x / w` and the affine chain
`t0*a + t1*b + t2*c + t3` match XLA's bit for bit.  B2
(`csrc/project.cu:222-243`) computes each step with an explicitly
rounded intrinsic, and its depth key is `w`'s bits, so a faster form is
usable only where its bits are B2's.  `r3_div_parity.cu` runs
`pcr_probe_parity<op, form>`, two op groups:

- division: `inv` (1/w), `mul` (x * inv), `cast` (the probe's
  `(int)(((x * inv) * 0.5) * 1920)`) and `cast-b2` (B2's
  `(int)((((x * inv) * 0.5) + 0.5) * width)`), each with 1/w as `div_rn`
  (B2's `__fdiv_rn(1, w)`), `rcp_rn` (`__frcp_rn`), `fdividef`
  (`__fdividef(1, w)`) or `rcp_approx` (`rcp.approx.ftz.f32`); and `div`
  (x / w) as `div_rn`, `fdividef` or `x*rcp_approx`;
- affine: `per-op` (B2's order), `fma-chain` (fmaf(t2, c, fmaf(t1, b,
  t0*a)) + t3) and `fma-all` (fmaf(t2, c, fmaf(t1, b, fmaf(t0, a, t3)))).

Each form's output is counted against the per-op plain version (`div_rn`
and `per-op` must show 0, as must `rcp_rn`, a correctly rounded
reciprocal); the exact forms are held bit-exact to their plain versions
(the FMA forms' `fmaf_plain` rounds once, through round-to-odd in f64).
Inputs: the TPU probe's, regenerated exactly (`default_rng(0)`, 65,536
values, `w` in [1e-3, 1e4], so `rcp.approx.ftz` meets no subnormal), and
B2's own: a chunk's decoded points with a view's transform, every form
applied through to w, inv, ndx, px, py and the pid (the per-op `div_rn`
chain also held to `project_plain`'s depth and pid).  Each form is timed
over 16.8M values and by a 64-step dependent chain a value.  On a host
with a card:

    python -m pcrhpg24_tpu_torch.experiments.r3_div_parity \\
        [--scene out/chip_smoke_256_v2.tpc] [--view orbit]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..kernels.build import I, L, P, check_cuda
from ..render.raster import swizzle_dims
from . import probes

PARITY = probes.probe_kernel("pcr_probe_parity", [I, I, I, P, P, P, P, P, I, I, L, P])
OPS = {"inv": 0, "mul": 1, "cast": 2, "cast-b2": 3, "div": 4, "affine": 5}
INV_FORMS = {"div_rn": 0, "rcp_rn": 1, "fdividef": 2, "rcp_approx": 3}
DIV_FORMS = {"div_rn": 0, "fdividef": 2, "x*rcp_approx": 3}
AFFINE_FORMS = {"per-op": 0, "fma-chain": 1, "fma-all": 2}
FORMS = {"inv": INV_FORMS, "mul": INV_FORMS, "cast": INV_FORMS, "cast-b2": INV_FORMS,
         "div": DIV_FORMS, "affine": AFFINE_FORMS}
DEPENDENT = ("inv", "mul", "div", "affine")  # the ops timed by a dependent chain too
EXACT = {"div_rn", "rcp_rn", "per-op", "fma-chain", "fma-all"}
N = 1 << 16  # the TPU probe's values
T = np.array([1.1234567, -2.2345678, 3.3456789, 0.123456], np.float32)  # its t0..t3
PROBE_WIDTH = 1920
BIG = 1 << 24  # values timed
STEPS = 64  # ops of a dependent chain
CHECKED = 1 << 20  # values of a dependent chain held to its plain version
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


# ---- plain versions (torch, any device): f32 ops rounded once each ----

def rn(x: torch.Tensor) -> torch.Tensor:
    """An f64 value rounded to f32.  For +, -, x and / of f32 operands the
    f64 result rounded again is the correctly rounded f32 one (53 >= 2 x
    24 + 2)."""
    return x.to(torch.float32)


def f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def fmaf_plain(a, b, c) -> torch.Tensor:
    """fmaf(a, b, c) on f32 tensors, correctly rounded: the product is
    exact in f64; the f64 sum is rounded to odd (an inexact sum with an
    even last bit moves one ulp toward the exact one, found by TwoSum),
    and rounding that to f32 is exact rounding, since 53 >= 24 + 2."""
    p, c = f64(a) * f64(b), f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return rn(s)


def sat_int(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as the card's cvt.rzi and XLA's convert do: toward
    zero, saturated, NaN -> 0."""
    t = torch.trunc(f64(x)).clamp(INT32_MIN, INT32_MAX)
    return torch.where(torch.isnan(t), torch.zeros_like(t), t).to(torch.int32)


def inv_plain(w):
    return rn(1.0 / f64(w))


def mul_plain(w, x):
    return rn(f64(x) * f64(inv_plain(w)))


def cast_plain(w, x, width: int = PROBE_WIDTH):
    return sat_int(rn(f64(rn(f64(mul_plain(w, x)) * 0.5)) * width))


def cast_b2_plain(w, x, width: int):
    return sat_int(rn(f64(rn(f64(rn(f64(mul_plain(w, x)) * 0.5)) + 0.5)) * width))


def div_plain(w, x):
    return rn(f64(x) / f64(w))


def affine_plain(form: str, a, b, c, t, d):
    """t0*a + t1*b + t2*c + t3 in `form` (t3 = d, broadcast)."""
    t0, t1, t2 = (t[k].to(torch.float32) for k in range(3))
    if form == "per-op":
        s = rn(f64(rn(f64(t0) * f64(a))) + f64(rn(f64(t1) * f64(b))))
        s = rn(f64(s) + f64(rn(f64(t2) * f64(c))))
        return rn(f64(s) + f64(d))
    if form == "fma-chain":
        u = fmaf_plain(t2.expand_as(c), c,
                       fmaf_plain(t1.expand_as(b), b, rn(f64(t0) * f64(a))))
        return rn(f64(u) + f64(d))
    u = fmaf_plain(t0.expand_as(a), a, d.expand_as(a))
    return fmaf_plain(t2.expand_as(c), c, fmaf_plain(t1.expand_as(b), b, u))


def card_bits(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 bits, a NaN as the card writes it (0x7fffffff; torch
    writes 0xffc00000): only its payload differs."""
    return torch.where(torch.isnan(v), torch.full_like(v.view(torch.int32), 0x7FFFFFFF),
                       v.view(torch.int32))


def plain(op: str, form: str, ins: dict, width: int = PROBE_WIDTH) -> torch.Tensor:
    """The plain version of an exact form (or, for any form of the
    division group, B2's), as the kernel writes it: float bits or int."""
    w, x = ins.get("w"), ins.get("x")
    if op == "affine":
        v = affine_plain(form, ins["a"], ins["b"], ins["c"], ins["t"], ins["d"])
    elif op == "cast":
        return cast_plain(w, x)
    elif op == "cast-b2":
        return cast_b2_plain(w, x, width)
    else:
        v = {"inv": lambda: inv_plain(w), "mul": lambda: mul_plain(w, x),
             "div": lambda: div_plain(w, x)}[op]()
    return card_bits(v)


def dependent_plain(op: str, form: str, ins: dict, steps: int = STEPS) -> torch.Tensor:
    """The plain version of an exact form's dependent chain (the kernel's
    `steps` > 0)."""
    w, x = ins.get("w"), ins.get("x")
    if op == "affine":
        v = ins["a"]
        for _ in range(steps):
            v = affine_plain(form, v, ins["b"], ins["c"], ins["t"], ins["d"])
        return card_bits(v)
    step = {"inv": lambda v: inv_plain(v), "mul": lambda v: mul_plain(v, x),
            "div": lambda v: div_plain(v, x)}[op]
    v = w
    for _ in range(steps):
        v = step(v)
    return card_bits(v)


# ---- the kernel ----

def parity(op: str, form: str, ins: dict, width: int = PROBE_WIDTH, steps: int = 0,
           dshift: int = 40) -> torch.Tensor:
    """One launch of pcr_probe_parity at (op, form) over the inputs (f32
    CUDA tensors of one size: w, x for the division group; a, b, c, the
    (3,) t and d, t3 of element i being d[i >> dshift], for affine) ->
    int32: float bits, or the cast."""
    if op == "affine":
        in0, in1, in2 = ins["a"], ins["b"], ins["c"]
        t, d = ins["t"], ins["d"]
    else:
        in0, in1 = ins["w"], ins["x"]
        in2, t, d = in0, in0, in0
    n = in0.numel()
    for name, x in (("in0", in0), ("in1", in1), ("in2", in2)):
        check_cuda(name, x, torch.float32, (n,))
    check_cuda("t", t, torch.float32)
    check_cuda("d", d, torch.float32)
    if op == "affine" and (t.numel() < 3 or ((n - 1) >> dshift) >= d.numel()):
        raise ValueError("t holds t0..t2; d one value a 2**dshift elements")
    out = torch.empty(n, dtype=torch.int32, device=in0.device)
    PARITY.launch(OPS[op], FORMS[op][form], steps, in0.data_ptr(), in1.data_ptr(),
                  in2.data_ptr(), t.data_ptr(), d.data_ptr(), dshift, width, n, out.data_ptr())
    return out


# ---- inputs ----

def probe_inputs(device="cuda") -> dict:
    """The TPU probe's inputs, regenerated exactly (`r3_div_parity.py:15-21`,
    `:50-54`): w, x, then a, b, c (f32, 65,536 each), t = t0..t2, d = t3."""
    rng = np.random.default_rng(0)
    w = (rng.random(N, np.float32) * 1e4 + 1e-3).astype(np.float32)
    x = rng.standard_normal(N).astype(np.float32) * 1e3
    a, b, c = (rng.standard_normal(N).astype(np.float32) for _ in range(3))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in dict(w=w, x=x, a=a, b=b, c=c).items()}
    out["t"] = torch.from_numpy(T[:3].copy()).to(device)
    out["d"] = torch.from_numpy(T[3:].copy()).to(device)
    return out


def big_inputs(n: int | None = None, seed: int = 0, device="cuda") -> dict:
    """n (default `BIG`) values of each input drawn as the TPU probe's, on
    the card."""
    n = BIG if n is None else n
    g = torch.Generator(device=device).manual_seed(seed)
    f = dict(dtype=torch.float32, device=device, generator=g)
    out = dict(w=torch.rand(n, **f) * 1e4 + 1e-3, x=torch.randn(n, **f) * 1e3,
               a=torch.randn(n, **f), b=torch.randn(n, **f), c=torch.randn(n, **f))
    out["t"] = torch.from_numpy(T[:3].copy()).to(device)
    out["d"] = torch.from_numpy(T[3:].copy()).to(device)
    return out


def forms():
    """Every (op, form) of the two groups."""
    return [(op, form) for op, fs in FORMS.items() for form in fs]


def mismatches(card: str, ins: dict, label: str) -> dict:
    """Each form once on `ins`: the exact forms held bit-exact to their
    plain versions; every form's count of values whose bits differ from
    the per-op plain version.  -> {(op, form): count}."""
    out = {}
    for op, form in forms():
        got = parity(op, form, ins)
        ref = plain(op, "per-op" if op == "affine" else "div_rn", ins)
        if form in EXACT and not torch.equal(got, plain(op, form, ins)):
            raise AssertionError(f"r3_div_parity {op} {form} on {label}: != its plain version")
        out[(op, form)] = int((got != ref).sum())
        print(f"[probe] r3_div_parity {op} {form} {label}: {out[(op, form)]:,} of "
              f"{got.numel():,} values differ from the per-op plain version"
              f"{' (exact: bit-exact vs its plain version)' if form in EXACT else ''} [{card}]")
    for form in ("div_rn", "rcp_rn", "per-op"):
        if any(n for (op, f), n in out.items() if f == form):
            raise AssertionError(f"r3_div_parity {form} on {label}: differs from per-op")
    return out


# ---- B2's own inputs ----

def b2_inputs(chunk: dict, coords: torch.Tensor) -> dict:
    """A chunk's projection inputs as B2 forms them (`project_plain`): xs,
    ys, zs flattened, and per row (x, y, w) its t0..t2 and the batches'
    translations (t3 of element i: d[i >> 16], 64 points a chain)."""
    f = chunk["frame12"]
    anchors = chunk["anchor"]
    xyz = [((coords[:, :, k] - anchors[:, k, None, None, None]).to(torch.float32) * f[9 + k])
           .reshape(-1).contiguous() for k in range(3)]
    tb = chunk["tb"]
    rows = {"x": (f[0:3], tb[:, 0]), "y": (f[3:6], tb[:, 1]), "w": (f[6:9], tb[:, 3])}
    return dict(xs=xyz[0], ys=xyz[1], zs=xyz[2],
                rows={k: (t.contiguous(), d.contiguous()) for k, (t, d) in rows.items()})


def b2_chain(b2: dict, affine_form: str, inv_form: str, width: int, height: int,
             kernel: bool = True) -> dict:
    """w, inv, ndx, ndy, px, py and the pid of every point, with the
    affine rows in `affine_form` and 1/w in `inv_form`: by the kernel, or
    (kernel=False, exact forms only) by the plain versions."""
    shift = 16  # points (64) x 1024 chains a batch

    def aff(row):
        t, d = b2["rows"][row]
        ins = dict(a=b2["xs"], b=b2["ys"], c=b2["zs"], t=t, d=d)
        if kernel:
            return parity("affine", affine_form, ins, dshift=shift).view(torch.float32)
        return affine_plain(affine_form, ins["a"], ins["b"], ins["c"], t,
                            d.repeat_interleave(1 << shift))

    cx, cy, w = aff("x"), aff("y"), aff("w")

    def div_op(op, x, size=PROBE_WIDTH):
        if kernel:
            return parity(op, inv_form, dict(w=w, x=x), width=size)
        return plain(op, inv_form, dict(w=w, x=x), width=size)

    out = dict(w=card_bits(w), inv=div_op("inv", cx),
               ndx=div_op("mul", cx), ndy=div_op("mul", cy),
               px=div_op("cast-b2", cx, width), py=div_op("cast-b2", cy, height))
    ndx, ndy = out["ndx"].view(torch.float32), out["ndy"].view(torch.float32)
    px, py = out["px"].to(torch.int64), out["py"].to(torch.int64)
    wt, _ht, size = swizzle_dims(width, height)
    ok = ((w > 0) & (ndx.abs() <= 1) & (ndy.abs() <= 1) & (px >= 0) & (px < width)
          & (py >= 0) & (py < height))
    swz = (((py >> 5) * wt + (px >> 5)) << 10) | ((py & 31) << 5) | (px & 31)
    out["pid"] = torch.where(ok, swz, torch.full_like(swz, size)).to(torch.int32)
    return out


B2_FORMS = [("per-op", "div_rn"), ("fma-chain", "div_rn"), ("fma-all", "div_rn"),
            ("per-op", "rcp_rn"), ("per-op", "fdividef"), ("per-op", "rcp_approx")]
B2_FIELDS = ("w", "inv", "ndx", "ndy", "px", "py", "pid")


def b2_mismatches(label: str, chunk: dict, coords: torch.Tensor, card: str,
                  width: int = 1920, height: int = 1080) -> dict:
    """Every B2 form of `B2_FORMS` through the chain on a chunk's decoded
    coordinates (all 64 points of every chain): the per-op `div_rn` chain
    held to the plain chain and to `project_plain`'s depth and pid (no
    collapse, every point counted); each form's count of differing
    values per field, and of points whose depth or pid differs. ->
    {(affine, inv): {field: count, "depth or pid": count}}."""
    from ..render.project import project_plain

    b2 = b2_inputs(chunk, coords)
    base = b2_chain(b2, "per-op", "div_rn", width, height, kernel=False)
    lodn = torch.full((coords.shape[0],), coords.shape[1], dtype=torch.int32,
                      device=coords.device)
    pid, dep, _pay = project_plain(coords, chunk["colors_k"], chunk["anchor"], chunk["tb"],
                                   lodn, chunk["frame12"], width, height,
                                   points=coords.shape[1], collapse=False)
    if not (torch.equal(pid.reshape(-1), base["pid"]) and torch.equal(dep.reshape(-1),
                                                                      base["w"])):
        raise AssertionError(f"r3_div_parity {label}: the per-op chain != project_plain")
    out = {}
    for aff, inv in B2_FORMS:
        got = b2_chain(b2, aff, inv, width, height)
        if aff in EXACT and inv in EXACT:
            want = b2_chain(b2, aff, inv, width, height, kernel=False)
            bad = [k for k in B2_FIELDS if not torch.equal(got[k], want[k])]
            if bad:
                raise AssertionError(f"r3_div_parity B2 {aff}, {inv} on {label}: {bad} != "
                                     f"their plain versions")
        counts = {k: int((got[k] != base[k]).sum()) for k in B2_FIELDS}
        counts["depth or pid"] = int(((got["w"] != base["w"]) | (got["pid"] != base["pid"]))
                                     .sum())
        out[(aff, inv)] = counts
        print(f"[probe] r3_div_parity B2 chain affine {aff}, 1/w {inv} {label}: of "
              f"{got['w'].numel():,} points, differ from per-op div_rn: "
              + ", ".join(f"{k} {counts[k]:,}" for k in (*B2_FIELDS, "depth or pid"))
              + f" [{card}]")
    if any(out[("per-op", "div_rn")].values()) or any(out[("per-op", "rcp_rn")].values()):
        raise AssertionError(f"r3_div_parity B2 {label}: per-op div_rn or rcp_rn differs")
    return out


# ---- timing ----

def held(what: str, got: torch.Tensor, want: torch.Tensor, ins: dict) -> None:
    """Raise, naming the first values that differ, unless got == want."""
    if torch.equal(got, want):
        return
    bad = torch.nonzero(got != want).flatten()
    show = [f"[{i}] " + ", ".join(f"{k} {ins[k][i].item():.9g}" for k in ("w", "x", "a")
                                  if ins[k].numel() > i)
            + f": {got[i].item() & 0xFFFFFFFF:#010x} != {want[i].item() & 0xFFFFFFFF:#010x}"
            for i in bad[:3].tolist()]
    raise AssertionError(f"r3_div_parity {what}: {bad.numel():,} of {got.numel():,} values "
                         f"!= its plain version; " + "; ".join(show))


def timings(card: str, device="cuda", reps: int = 20) -> dict:
    """Each form over 16.8M values (one launch alone, device ms) and each
    dependent-chain form (64 ops a value); the first 1,048,576 values of
    each exact form, and of its dependent chain, held to its plain
    version. ->
    {(op, form, "elementwise" | "dependent"): ms}, and "plain_ms" (the
    plain 1/w) and "library_ms" (`torch.reciprocal`)."""
    ins = big_inputs(device=device)
    n = ins["w"].numel()
    out = {}
    head = {k: (v[:CHECKED] if v.numel() == n else v) for k, v in ins.items()}
    for op, form in forms():
        if form in EXACT:
            held(f"{op} {form}", parity(op, form, ins)[:CHECKED], plain(op, form, head), head)
        out[(op, form, "elementwise")] = probes.time_ms(lambda: parity(op, form, ins), reps)
        if op not in DEPENDENT:
            continue
        got = parity(op, form, ins, steps=STEPS)
        if form in EXACT:
            held(f"{op} {form}, the dependent chain", got[:CHECKED],
                 dependent_plain(op, form, head), head)
        out[(op, form, "dependent")] = probes.time_ms(
            lambda: parity(op, form, ins, steps=STEPS), reps)
    out["plain_ms"] = probes.time_ms(lambda: inv_plain(ins["w"]), 5)
    out["library_ms"] = probes.time_ms(lambda: torch.reciprocal(ins["w"]), reps)
    for op, form in forms():
        e = out[(op, form, "elementwise")]
        dep = out.get((op, form, "dependent"))
        tail = (f"; dependent chain of {STEPS}: {dep:.4f} ms, {dep * 1e9 / STEPS / n:.3f} ps a "
                f"value-op" if dep is not None else "")
        print(f"[probe] r3_div_parity time {op} {form}: {e:.4f} ms device over {n:,} values, "
              f"one launch alone{tail} [{card}]")
    print(f"[probe] r3_div_parity time: the plain 1/w {out['plain_ms']:.4f} ms, "
          f"torch.reciprocal {out['library_ms']:.4f} ms over {n:,} values [{card}]")
    return out


def run(card: str, b2=None, device="cuda", reps: int = 20) -> dict:
    """The parity table on the TPU probe's inputs, on B2's chain when `b2`
    = (label, chunk, coords) is given, and the timings."""
    probes.require_card(device)
    out = dict(probe=mismatches(card, probe_inputs(device), "TPU probe input"))
    if b2 is not None:
        out["b2"] = b2_mismatches(*b2, card)
    out["times"] = timings(card, device, reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="out/chip_smoke_256_v2.tpc",
                    help="a .tpc v2 scene (default: the smoke's at 256 batches)")
    ap.add_argument("--view", default="orbit", choices=sorted(probes.views()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("r3_div_parity: no card", file=sys.stderr)
        return 1
    from ..render.decode_fixed import decode_fixed_batches

    card = probes.card_line()
    b2 = None
    if os.path.exists(args.scene):
        chunk, label = probes.tpc_chunk(args.scene, args.view)
        coords = decode_fixed_batches(*(chunk[k] for k in ("widths", "streams", "ptrs",
                                                           "starts")))
        b2 = (label, chunk, coords)
    run(card, b2)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
