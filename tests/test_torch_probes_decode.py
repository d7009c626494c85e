"""The decoders' and B2's probes of `pcrhpg24_tpu_torch/experiments/` on
the CPU.

Their kernels run only on a card, so this file holds what the card's
results are held to, against the reference:
- B5's variants (`exp_pallas_variants`, also timed by slope in
  `exp_variant_slope`): each lesion's plain version equals the TPU
  probe's own `mk_kernel(variant)` run through `pl.pallas_call` in
  interpret mode on the probe's seeded batch; the exact variants' plain
  version (`decode_native_plain`) equals `mk_kernel({})`,
  `mk_kernel({"rank": "roll"})` and the reference's B5 in interpret mode;
- B1's (`r3_decode_ilp`): `decode_fixed_plain` equals the reference's
  `decode_fixed_batches` in interpret mode on a batch built here (the
  TPU probe loads a scene when imported, so it cannot be called);
- the table gather (`exp_gather`): its plain versions equal
  `(arange(4096) * 7)[idx]` for the TPU probe's `jax.random` indices
  (`experiments/exp_gather.py` runs when imported) and numpy loops;
- the float forms (`r3_div_parity`): the per-op plain versions equal
  XLA-CPU at O0 on the TPU probe's inputs for all five ops; the count
  that differs from XLA's default build is recorded (XLA contracts the
  affine chain into FMAs); the round-to-odd `fmaf_plain` equals
  `fractions.Fraction` arithmetic; B2's chain of plain versions equals
  `project_plain`.
It also checks that every new entry point raises on CPU tensors, that
importing the modules launches nothing, and the ptxas log parser.
"""

import importlib
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu_torch.experiments import (exp_gather, exp_pallas_variants, exp_variant_slope,
                                            probes, r3_decode_ilp, r3_div_parity)
from pcrhpg24_tpu_torch.u32 import from_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

ev = exp_pallas_variants
rdp = r3_div_parity


@pytest.fixture(scope="module")
def tpu_probe():
    """The reference probe module, imported with `pl.pallas_call` counted:
    importing it must run no TPU work (its `main` is guarded)."""
    from jax.experimental import pallas as pl

    calls = []
    real = pl.pallas_call
    pl.pallas_call = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        sys.modules.pop("experiments.exp_pallas_variants", None)
        mod = importlib.import_module("experiments.exp_pallas_variants")
    finally:
        pl.pallas_call = real
    assert calls == []
    return mod


@pytest.fixture(scope="module")
def batch():
    """The TPU probe's seeded batch, packed (NumPy) and as B5's tensors."""
    packed = ev.probe_batch()
    tensors = [from_u32(packed[k]) if packed[k].dtype == np.uint32
               else torch.from_numpy(packed[k]) for k in ev.KEYS]
    return packed, tensors


_TPU = {}


def _tpu_variant(tpu_probe, packed, switches: dict) -> np.ndarray:
    """The TPU probe's kernel at `switches` on one batch, in interpret
    mode, as its `run` calls it (lj's (1, 1, 16) block of the packed
    (1, 1, 32) array)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    key = tuple(sorted(switches.items()))
    if key not in _TPU:
        G, LANES, PPT = tpu_probe.G, tpu_probe.LANES, tpu_probe.PPT
        maxw = packed["streams"].shape[2]
        f = pl.pallas_call(
            tpu_probe.mk_kernel(switches), grid=(1,),
            in_specs=[pl.BlockSpec((1, 1, 16), lambda b: (b, 0, 0), memory_space=pltpu.SMEM),
                      pl.BlockSpec((1, G, maxw), lambda b: (b, 0, 0)),
                      pl.BlockSpec((1, 384, G), lambda b: (b, 0, 0)),
                      pl.BlockSpec((1, 1, 128), lambda b: (b, 0, 0)),
                      pl.BlockSpec((1, 1, 128), lambda b: (b, 0, 0)),
                      pl.BlockSpec((1, 3, G, LANES), lambda b: (b, 0, 0, 0))],
            out_specs=pl.BlockSpec((1, PPT, 3, G, LANES), lambda b: (b, 0, 0, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((1, PPT, 3, G, LANES), jnp.int32), interpret=True)
        _TPU[key] = np.asarray(f(*(jnp.asarray(packed[k]) for k in ev.KEYS)))
    return _TPU[key]


@pytest.mark.parametrize("variant", ["no-table", "no-window", "no-refill",
                                     "no-refill-no-table"])
def test_b5_lesion_plains_equal_tpu_probe(tpu_probe, batch, variant):
    packed, tensors = batch
    want = _tpu_variant(tpu_probe, packed, ev.TPU_SWITCHES[variant])
    got = ev.plain(variant, tensors).numpy()
    np.testing.assert_array_equal(got, want)
    # a lesion decodes other coordinates than B5: the check has teeth
    assert not np.array_equal(got, ev.plain("full", tensors).numpy())


@pytest.mark.parametrize("reference", ["tpu {}", "tpu rank roll", "pallas_decode"])
def test_b5_exact_plain_equals_tpu_probe(tpu_probe, batch, reference):
    """full, ladder and rank-scan are held to `decode_native_plain`: it
    equals the TPU probe's kernel and its roll rank, and the reference's B5."""
    packed, tensors = batch
    if reference == "pallas_decode":
        from pcrhpg24_tpu.render.pallas_decode import decode_native_batches

        want = np.asarray(decode_native_batches(*(jnp.asarray(packed[k]) for k in ev.KEYS),
                                                interpret=True))
    else:
        want = _tpu_variant(tpu_probe, packed, {} if reference == "tpu {}" else {"rank": "roll"})
    for v in ev.EXACT:
        np.testing.assert_array_equal(ev.plain(v, tensors).numpy(), want, err_msg=v)


def test_b5_variant_plain_without_switches_is_b5(batch):
    _packed, tensors = batch
    got = ev.variant_plain("full", *tensors, points=16)
    assert torch.equal(got, ev.decode_native_plain(*tensors, points=16))
    assert set(ev.VARIANTS) == set(ev.TPU_SWITCHES)
    assert sorted(ev.VARIANTS.values()) == list(range(7))


def test_b1_plain_equals_reference_kernel():
    """B1's variants are held to `decode_fixed_plain`: it equals the
    reference's `decode_fixed_batches` in interpret mode on a batch of
    the TPU probe's random walk, encoded by the port's fixed codec."""
    from pcrhpg24_tpu.render.pallas_decode_fixed import decode_fixed_batches
    from pcrhpg24_tpu_torch.codec.fixed import encode_fixed_batch
    from pcrhpg24_tpu_torch.codec.morton import morton_order
    from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_plain, pack_fixed_batches

    rng = np.random.default_rng(3)
    pts = np.cumsum(rng.integers(-80, 80, size=(65_536, 3)), axis=0).astype(np.int32)
    o = morton_order(*pts.T)
    pk = pack_fixed_batches([encode_fixed_batch(*pts[o].T)])
    t = [from_u32(pk[k]) if pk[k].dtype == np.uint32 else torch.from_numpy(pk[k])
         for k in r3_decode_ilp.KEYS]
    want = np.asarray(decode_fixed_batches(*(pk[k] for k in r3_decode_ilp.KEYS),
                                           interpret=True))
    np.testing.assert_array_equal(decode_fixed_plain(*t).numpy(), want)
    assert set(r3_decode_ilp.VARIANTS) == {"full", "ahead", *(f"{p}u{n}" for p in ("", "ahead-")
                                                               for n in (2, 4, 8, 64))}


def test_gather_tpu_plain_equals_reference():
    """The tpu pattern's plain version at the TPU probe's own indices."""
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 128), 0, 4096,
                                        dtype=jnp.int32)).reshape(-1)
    want = (np.arange(4096, dtype=np.int32) * 7)[idx]
    got = exp_gather.gather_plain(exp_gather.tpu_tables("cpu"), "tpu",
                                  torch.from_numpy(idx.copy()),
                                  lanes=1024)
    np.testing.assert_array_equal(got.numpy(), want)


def _mix(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


@pytest.mark.parametrize("pattern", ["random", "broadcast", "chain"])
def test_gather_plains_equal_numpy_loops(pattern):
    lanes, steps, tables = 256, 7, 4
    tabs = exp_gather.random_tables(tables, seed=3, device="cpu")
    got = exp_gather.gather_plain(tabs, pattern, lanes=lanes, steps=steps).numpy()
    entry = (tabs["val"].numpy().astype(np.int64) + tabs["len"].numpy()) & 0xFFFFFFFF
    want = np.zeros(lanes, np.int64)
    for lane in range(lanes):
        t, acc = lane // (lanes // tables), 0
        i = _mix(lane) & 4095
        for s in range(steps):
            if pattern != "chain":
                i = _mix(((lane if pattern == "random" else lane >> 5) * 256 + s)) & 4095
            r = int(entry[t, i])
            acc = (acc + r) & 0xFFFFFFFF
            i = r & 4095
        want[lane] = acc
    np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF, want)


def _per_op(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _xla_ops(ins, opt0: bool):
    """The TPU probe's XLA sides (`r3_div_parity.py:37-40`, `:67-70`),
    compiled at O0 or by XLA's default build."""
    t0, t1, t2, t3 = 1.1234567, -2.2345678, 3.3456789, 0.123456
    bits = lambda v: jax.lax.bitcast_convert_type(v, jnp.int32)  # noqa: E731
    fns = {"inv": lambda w, x: bits(1.0 / w), "mul": lambda w, x: bits(x * (1.0 / w)),
           "cast": lambda w, x: ((x * (1.0 / w)) * 0.5 * 1920.0).astype(jnp.int32),
           "div": lambda w, x: bits(x / w),
           "affine": lambda a, b, c: bits(t0 * a + t1 * b + t2 * c + t3)}
    out = {}
    for op, fn in fns.items():
        args = [jnp.asarray(ins[k].numpy()) for k in (("a", "b", "c") if op == "affine"
                                                       else ("w", "x"))]
        out[op] = np.asarray(_per_op(fn, *args) if opt0 else jax.jit(fn)(*args))
    return out


def test_parity_per_op_plains_equal_xla_o0(record_property):
    ins = rdp.probe_inputs("cpu")
    xla = _xla_ops(ins, opt0=True)
    default = _xla_ops(ins, opt0=False)
    for op, want in xla.items():
        got = rdp.plain(op, "per-op" if op == "affine" else "div_rn", ins).numpy()
        np.testing.assert_array_equal(got, want, err_msg=op)
        record_property(f"xla_default_{op}_mismatches", int((got != default[op]).sum()))
    # the probe's values never reach a subnormal (rcp.approx.ftz flushes them)
    assert float(ins["w"].min()) >= 1e-3 and float(ins["w"].max()) <= 1e4 + 1e-3


def _round_f32(q: Fraction) -> np.float32:
    """q rounded to the nearest f32, ties to even."""
    f = np.float32(float(q))
    up, down = np.float32(np.inf), np.float32(-np.inf)
    while Fraction(float(f)) > q:
        f = np.nextafter(f, down)
    while Fraction(float(np.nextafter(f, up))) <= q:
        f = np.nextafter(f, up)
    lo, hi = f, np.nextafter(f, up)
    dlo, dhi = q - Fraction(float(lo)), Fraction(float(hi)) - q
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(np.array(lo).view(np.int32)) % 2 == 0 else hi


def test_fmaf_plain_equals_fraction_arithmetic():
    rng = np.random.default_rng(7)
    n = 2000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    # ties: (1 + 2**-12)**2 = 1 + 2**-11 + 2**-24 lies half an ulp from two
    # f32s; with c a multiple of 2**-23 the tie goes either way, and with
    # a tiny c (2**-60) it is just off a tie, which rounding the f64 sum
    # to nearest would land on (double rounding)
    e = np.float32(1 + 2.0**-12)
    tie_c = np.array([0, 2.0**-23, -2.0**-23, 3 * 2.0**-23, 2.0**-60, -2.0**-60, -1, -2],
                     np.float32)
    a = np.r_[a, np.full(tie_c.size, e), -np.full(tie_c.size, e)]
    b = np.r_[b, np.full(2 * tie_c.size, e)]
    c = np.r_[c, tie_c, -tie_c]
    got = rdp.fmaf_plain(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive.view(np.int32) != want.view(np.int32)).any()  # double rounding bites


@pytest.mark.parametrize("form", ["fma-chain", "fma-all"])
def test_parity_fma_forms_plain(form):
    """The FMA forms' plain versions are fmaf_plain chains in the probe's
    order, and differ from per-op on some of the probe's values."""
    ins = rdp.probe_inputs("cpu")
    got = rdp.plain("affine", form, ins)
    t = ins["t"]
    if form == "fma-chain":
        u = rdp.fmaf_plain(t[1].expand(rdp.N), ins["b"], (t[0] * ins["a"]))
        want = rdp.fmaf_plain(t[2].expand(rdp.N), ins["c"], u) + ins["d"]
    else:
        u = rdp.fmaf_plain(t[0].expand(rdp.N), ins["a"], ins["d"].expand(rdp.N))
        want = rdp.fmaf_plain(t[2].expand(rdp.N), ins["c"],
                              rdp.fmaf_plain(t[1].expand(rdp.N), ins["b"], u))
    assert torch.equal(got, want.view(torch.int32))
    assert (got != rdp.plain("affine", "per-op", ins)).any()


def test_parity_dependent_plain_chains():
    ins = {k: v[:64] if v.numel() == rdp.N else v for k, v in rdp.probe_inputs("cpu").items()}
    v = ins["w"]
    for _ in range(5):
        v = 1.0 / v
    assert torch.equal(rdp.dependent_plain("inv", "div_rn", ins, steps=5), v.view(torch.int32))
    v = ins["a"]
    for _ in range(3):
        v = rdp.affine_plain("per-op", v, ins["b"], ins["c"], ins["t"], ins["d"])
    assert torch.equal(rdp.dependent_plain("affine", "per-op", ins, steps=3),
                       v.view(torch.int32))


def test_b2_chain_plain_equals_project_plain():
    """The plain chain `r3_div_parity` holds B2's forms to equals B2's own
    plain version's depth and pid, on a crafted chunk (every point)."""
    from pcrhpg24_tpu_torch.render.project import project_plain
    from pcrhpg24_tpu_torch.tools import crafted

    W, H = 256, 128
    ci = crafted.project_inputs(2, 64, W, H, seed=4)
    t = {k: (from_u32(v) if v.dtype == np.uint32 else torch.from_numpy(v)) for k, v in ci.items()}
    chunk = dict(anchor=t["anchors"], tb=t["tbc"], frame12=t["frame"], colors_k=t["colors_k"])
    coords = t["coords"]
    got = rdp.b2_chain(rdp.b2_inputs(chunk, coords), "per-op", "div_rn", W, H, kernel=False)
    lodn = torch.full((2,), 64, dtype=torch.int32)
    pid, dep, _ = project_plain(coords, t["colors_k"], t["anchors"], t["tbc"], lodn, t["frame"],
                                W, H, collapse=False)
    assert torch.equal(pid.reshape(-1), got["pid"])
    assert torch.equal(dep.reshape(-1), got["w"])
    from pcrhpg24_tpu_torch.render.raster import swizzle_dims

    assert (got["pid"] != swizzle_dims(W, H)[2]).any()


def test_ptxas_instances_parse():
    log = "\n".join([
        "nvcc -c x.cu",
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_12b119decode_fixed_kernelILi8ELb1EEEvPKiPKjS4_S4_Piii' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_12b119decode_fixed_kernelILi8ELb1EEEvPKiPKjS4_S4_Piii",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 43264 bytes smem, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 8 registers, 360 bytes cmem[0]",
    ])
    found = probes.instance_resources(r3_decode_ilp.INSTANCE, log)
    assert list(found) == [("8", "1")]
    r = found[("8", "1")]
    assert (r["registers"], r["smem"], r["stack"], r["spill_stores"], r["spill_loads"]) == \
        (72, 43264, 8, 4, 12)
    assert len(r["lines"]) == 3
    assert r3_decode_ilp.resources(log)["ahead-u8"] == r


def test_entry_points_raise_on_cpu_tensors(batch):
    """Each new probe's launch and `run` raise on CPU tensors, before any
    build, and count no launch."""
    _packed, tensors = batch
    with pytest.raises(ValueError):
        ev.decode(tensors, "full")
    with pytest.raises(ValueError):
        ev.run("cpu", tensors, "no card")
    with pytest.raises(ValueError):
        exp_variant_slope.run("cpu", tensors, "no card")
    fixed = [torch.zeros((1, 3, 8, 128), dtype=torch.int32),
             torch.zeros((1, 8, 8, 128), dtype=torch.int32),
             torch.zeros((1, 1, 64), dtype=torch.int32), torch.zeros((1, 3, 8, 128),
                                                                     dtype=torch.int32)]
    with pytest.raises(ValueError):
        r3_decode_ilp.decode(fixed, "u8")
    with pytest.raises(ValueError):
        r3_decode_ilp.run("cpu", fixed, "no card")
    with pytest.raises(ValueError):
        exp_gather.gather(exp_gather.tpu_tables("cpu"), "smem-int2", "chain", lanes=1024)
    with pytest.raises(ValueError):
        exp_gather.run("no card", device="cpu")
    with pytest.raises(ValueError):
        rdp.parity("inv", "div_rn", rdp.probe_inputs("cpu"))
    with pytest.raises(ValueError):
        rdp.run("no card", device="cpu")
    assert probes.build.cache_info().currsize == 0
    assert all(k.launches == 0 for k in probes.PROBES.values())
