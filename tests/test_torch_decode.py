"""Port B1 (fbatch decode) vs the JAX reference, bit-exact on the CPU.

Inputs come from a seed with numpy and go through both packages:
`pack_fixed_batches` must build the same arrays, and the port's plain
decoder must give the same coordinates as the reference's XLA decoder,
its Pallas kernel (interpret mode) and the NumPy protocol mirror, on
random clouds and on the crafted corners of `tools/crafted.py` (all-zero
chains, 32-bit fields, every round count 0..3 in one group, the widest
stream the format has).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.codec.fixed import decode_fixed_batch, encode_fixed_batch
from pcrhpg24_tpu.render import pallas_decode_fixed as ref
from pcrhpg24_tpu.render.native_decode_xla import decode_fixed_xla
from pcrhpg24_tpu_torch.render import decode_fixed as port
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)


def _cloud(seed):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-20, 21, (65536, 3)), axis=0)
    base[::7777] += rng.integers(-100000, 100000, (9, 3))
    return [base[:, i].astype(np.int32) for i in range(3)]


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(5)
    fbs = [encode_fixed_batch(*_cloud(s)) for s in (0, 3)]
    # a full-range batch exercises 32-bit fields (W = 96 bits per point)
    x = rng.integers(-(2**31), 2**31, 65536).astype(np.int32)
    y = rng.integers(-(2**31), 2**31, 65536).astype(np.int32)
    fbs.append(encode_fixed_batch(x, y, x))
    return fbs


def test_pack_fixed_batches_equal(batches):
    got = port.pack_fixed_batches(batches)
    want = ref.pack_fixed_batches(batches)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def crafted_batches():
    return crafted.fixed_batches(seed=1)


def test_crafted_batches_reach_the_corners(crafted_batches):
    mixed, wide = crafted_batches
    wb = mixed.widths.astype(np.int64).sum(1).reshape(8, 128)
    assert (wb == 0).any(axis=1).all() and (wb == 96).any(axis=1).all()
    i = np.arange(64)[:, None, None]
    cnt = (((i + 1) * wb + 31) >> 5) - ((i * wb + 31) >> 5)  # (round, group, lane)
    for g in range(8):  # every count 0..3 within one group's round
        assert set(np.unique(cnt[:, g])) == {0, 1, 2, 3}
    assert (wide.widths == 32).all() and wide.streams.shape[1] == 64 * 96 * 128 // 32


@pytest.mark.parametrize("points", [64, 40, 16])
def test_decode_plain_crafted(crafted_batches, points):
    _check_decode(crafted_batches, points)


@pytest.mark.parametrize("points", [64, 48, 16])
def test_decode_plain_bit_exact(batches, points):
    _check_decode(batches, points)


def _check_decode(batches, points):
    pk = ref.pack_fixed_batches(batches)
    t = {k: (from_u32(v) if v.dtype == np.uint32 else torch.from_numpy(v))
         for k, v in pk.items()}
    got = port.decode_fixed_batches(t["widths"], t["streams"], t["ptrs"],
                                    t["starts"], points=points).numpy()
    assert got.shape == (len(batches), points, 3, 8, 128)

    xla = np.asarray(decode_fixed_xla(*(jnp.asarray(pk[k]) for k in
                                        ("widths", "streams", "ptrs", "starts")),
                                      points=points))
    np.testing.assert_array_equal(got, xla)
    kern = np.asarray(ref.decode_fixed_batches(
        pk["widths"], pk["streams"], pk["ptrs"], pk["starts"],
        interpret=True, points=points))
    np.testing.assert_array_equal(got, kern)
    for b, fb in enumerate(batches):
        mirror = decode_fixed_batch(fb).reshape(8, 128, 64, 3)[:, :, :points]
        np.testing.assert_array_equal(np.transpose(got[b], (2, 3, 0, 1)), mirror)
