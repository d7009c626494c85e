"""Port B6 and B8 (dense planes from sorted streams) and the sorted
resolves vs the JAX reference, on the CPU.

* `merge.dense_from_sorted_nk1[_multi]` (B6's plain version) gives the
  planes of `pallas_merge.dense_from_sorted_nk1[_multi]` in Pallas
  interpret mode bit for bit, on the same pid-sorted arrays, with the
  reference's ILP kernel and (`ilp=False`) its plain nk1 kernel.
* `merge.dense_from_sorted` (B8's plain version) gives the planes of
  `pallas_merge.dense_from_sorted` in interpret mode.
* `raster.sorted_resolve_u64_min[_parts]` give the reference's (its
  3-key XLA branch, the one the CPU takes).
Sizes are those of `tests/test_pallas_merge.py`: 16 x 1024 entries
into 48 tiles of 1024 pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.render import pallas_merge as ref
from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu_torch.render import merge, raster
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

SIZE = 49_152  # 48 tiles of 1024


def _mk(n, seed, oob_frac=0.4, collide=True):
    """(pid, dep, pay) u32 with sentinels and repeated pids."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, SIZE, n).astype(np.uint32)
    pid[rng.random(n) < oob_frac] = SIZE
    if collide:
        pid[: n // 4] = pid[n // 2: n // 2 + n // 4]
    dep = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return pid, dep, pay


def _sorted(arrays, num_keys):
    """The reference's `lax.sort` of u32 arrays -> numpy."""
    out = jax.lax.sort([jnp.asarray(a) for a in arrays], num_keys=num_keys,
                       is_stable=False)
    return tuple(np.asarray(a) for a in out)


def _port(arrays):
    return tuple(from_u32(a) for a in arrays)


def _assert_planes(got, want):
    got_d, got_p = got
    want_d, want_p = want
    np.testing.assert_array_equal(to_u32(got_p), np.asarray(want_p))
    if want_d is None:
        assert got_d is None
    else:
        np.testing.assert_array_equal(to_u32(got_d), np.asarray(want_d))


@pytest.mark.parametrize("seed,oob", [(3, 0.4), (4, 0.0), (5, 0.95)])
def test_nk1_equals_reference_kernel(seed, oob):
    s = _sorted(_mk(16 * 1024, seed, oob), 1)
    want = ref.dense_from_sorted_nk1(*map(jnp.asarray, s), SIZE, True, interpret=True)
    _assert_planes(merge.dense_from_sorted_nk1(*_port(s), SIZE, True), want)
    assert (to_u32(merge.dense_from_sorted_nk1(*_port(s), SIZE)[1]) != 0xFFFFFFFF).any()


def test_nk1_ties_across_a_tile_border():
    """Everything on five pixels around the 1024 border, depth ties
    broken by the smallest payload."""
    rng = np.random.default_rng(9)
    n = 8192
    pid = rng.choice([1022, 1023, 1024, 1025, 40000], n).astype(np.uint32)
    dep = rng.integers(0, 4, n).astype(np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s = _sorted((pid, dep, pay), 1)
    want = ref.dense_from_sorted_nk1(*map(jnp.asarray, s), SIZE, True, interpret=True)
    got = merge.dense_from_sorted_nk1(*_port(s), SIZE, True)
    _assert_planes(got, want)
    p = 1023
    m = pid == p
    assert to_u32(got[1])[p] == pay[m][dep[m] == dep[m].min()].min()


@pytest.mark.parametrize("ilp", [True, False])
def test_nk1_multi_three_parts_equals_reference_kernel(ilp):
    parts = [_sorted(_mk(8 * 1024, seed, 0.3), 1) for seed in (3, 4, 5)]
    want = ref.dense_from_sorted_nk1_multi(
        [tuple(map(jnp.asarray, p)) for p in parts], SIZE, True, interpret=True,
        ilp=ilp)
    got = merge.dense_from_sorted_nk1_multi([_port(p) for p in parts], SIZE, True,
                                            ilp=ilp)
    _assert_planes(got, want)


def test_nk1_without_depth_plane():
    s = _sorted(_mk(4 * 1024, 6), 1)
    want = ref.dense_from_sorted_nk1(*map(jnp.asarray, s), SIZE, False, interpret=True)
    assert want[0] is None
    _assert_planes(merge.dense_from_sorted_nk1(*_port(s), SIZE, False), want)


@pytest.mark.parametrize("need_depth", [True, False])
def test_heads_equal_reference_kernel(need_depth):
    s = _sorted(_mk(16 * 1024, 3), 3)
    want = ref.dense_from_sorted(*map(jnp.asarray, s), SIZE, need_depth,
                                 interpret=True)
    _assert_planes(merge.dense_from_sorted(*_port(s), SIZE, need_depth), want)


def test_heads_tie_break_and_all_out_of_range():
    pid = np.full(1024, 7, np.uint32)
    dep = np.full(1024, 0x40000000, np.uint32)
    pay = np.arange(1024, 0, -1, dtype=np.uint32)
    s = _sorted((pid, dep, pay), 3)
    want = ref.dense_from_sorted(*map(jnp.asarray, s), SIZE, False, interpret=True)
    got = merge.dense_from_sorted(*_port(s), SIZE, False)
    _assert_planes(got, want)
    assert to_u32(got[1])[7] == 1
    oob = tuple(np.full(2048, v, np.uint32) for v in (SIZE, 0, 0))
    want = ref.dense_from_sorted(*map(jnp.asarray, oob), SIZE, True, interpret=True)
    got = merge.dense_from_sorted(*_port(oob), SIZE, True)
    _assert_planes(got, want)
    assert (to_u32(got[0]) == 0xFFFFFFFF).all()


@pytest.mark.parametrize("need_depth", [True, False])
def test_sorted_resolve_equals_reference(need_depth):
    pid, dep, pay = _mk(16 * 1024 + 77, 12, 0.3)  # not a multiple of 1024
    want = ref_raster.sorted_resolve_u64_min(
        *map(jnp.asarray, (pid, dep, pay)), SIZE, need_depth)
    got = raster.sorted_resolve_u64_min(*_port((pid, dep, pay)), SIZE, need_depth)
    _assert_planes(got, want)
    # the plain resolve of the gate gives the same planes
    _assert_planes(raster.sorted_resolve_u64_min(*_port((pid, dep, pay)), SIZE,
                                                 need_depth, plain=True), want)


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_resolve_parts_equals_reference(presorted):
    parts = [_mk(5000 + 1000 * k, 20 + k, 0.3) for k in range(3)]
    if presorted:
        parts = [_sorted(p, 1) for p in parts]
    want = ref_raster.sorted_resolve_u64_min_parts(
        [tuple(map(jnp.asarray, p)) for p in parts], SIZE, True, presorted=presorted)
    got = raster.sorted_resolve_u64_min_parts([_port(p) for p in parts], SIZE, True,
                                              presorted=presorted)
    _assert_planes(got, want)


def test_sort_by_pid_orders_as_u32():
    pid = np.array([5, 0x80000000, 3, 0xFFFFFFFF, 3, 0], np.uint32)
    dep = np.arange(6, dtype=np.uint32)
    spid, sdep, spay = raster.sort_by_pid(*_port((pid, dep, dep)))
    assert to_u32(spid).tolist() == sorted(pid.tolist())
    np.testing.assert_array_equal(pid[to_u32(sdep)], to_u32(spid))
    np.testing.assert_array_equal(to_u32(sdep), to_u32(spay))
