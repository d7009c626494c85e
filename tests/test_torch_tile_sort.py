"""Port B10 (per-tile 3-key sort) vs the JAX reference, on the CPU.

`pallas_raster.tile_sort3` is jitted for the TPU and takes no
`interpret` argument, so the reference side is the same `pl.pallas_call`
as `pallas_raster.py:119-129` around the reference's own `_sort_kernel`,
in interpret mode.  `tile_sort3_plain` must give its tiles bit for bit,
keys compared as signed int32, on a stream-like input and on each of
`tools.crafted.TILE_KINDS` (the tiles the card's kernel is gated on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pcrhpg24_tpu.render import pallas_raster as ref
from pcrhpg24_tpu_torch.render.tile_sort import tile_sort3
from pcrhpg24_tpu_torch.tools import crafted
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)


def _reference_tile_sort3(pid, dep, pay):
    T = pid.shape[0]
    spec = pl.BlockSpec((1, ref.SUBL, ref.LANES), lambda t: (t, 0, 0))
    return pl.pallas_call(
        ref._sort_kernel,
        grid=(T,),
        in_specs=[spec] * 3,
        out_specs=(spec, spec, spec),
        out_shape=tuple(jax.ShapeDtypeStruct((T, ref.SUBL, ref.LANES), jnp.int32)
                        for _ in range(3)),
        interpret=True,
    )(pid, dep, pay)


def _keys(tiles, seed):
    """Three (T, 8, 128) int32 planes: few distinct k0 and k1 values (many
    ties to break), negatives in every key."""
    rng = np.random.default_rng(seed)
    shape = (tiles, 8, 128)
    k0 = rng.integers(-4, 5, shape).astype(np.int32)
    k1 = rng.integers(-3, 3, shape).astype(np.int32)
    k2 = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    k2[0, 0, :64] = k2[0, 0, 64:]  # whole triples repeat too
    k0[-1] = np.int32(-2**31)  # a tile of equal leading keys at the extreme
    return k0, k1, k2


def test_tile_sort_equals_reference_kernel():
    keys = _keys(4, 1)
    want = _reference_tile_sort3(*map(jnp.asarray, keys))
    got = tile_sort3(*map(torch.from_numpy, keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_lexsorted(got, keys):
    """Each tile of `got` is its tile of `keys` in `np.lexsort` order."""
    k0, k1, k2 = (k.reshape(k.shape[0], ref.SUBL * ref.LANES) for k in keys)
    order = np.lexsort((k2, k1, k0), axis=-1)
    for g, k in zip(got, (k0, k1, k2)):
        np.testing.assert_array_equal(g.numpy().reshape(k.shape),
                                      np.take_along_axis(k, order, axis=1))


@pytest.mark.parametrize("tiles", [1, 37])
def test_tile_sort_equals_lexsort(tiles):
    keys = _keys(tiles, tiles)
    _assert_lexsorted(tile_sort3(*map(torch.from_numpy, keys)), keys)


@pytest.fixture(scope="module")
def crafted_reference():
    """Two tiles of each crafted kind, sorted by one interpret-mode call
    of the reference kernel -> {kind: (keys, sorted planes)}."""
    keys = {kind: crafted.tile_keys(kind, 2, seed=3) for kind in crafted.TILE_KINDS}
    cat = [np.concatenate([keys[kind][i] for kind in crafted.TILE_KINDS]) for i in range(3)]
    want = [np.asarray(w) for w in _reference_tile_sort3(*map(jnp.asarray, cat))]
    return {kind: (keys[kind], [w[2 * j:2 * j + 2] for w in want])
            for j, kind in enumerate(crafted.TILE_KINDS)}


@pytest.mark.parametrize("kind", crafted.TILE_KINDS)
def test_crafted_tiles_equal_reference_kernel(kind, crafted_reference):
    keys, want = crafted_reference[kind]
    got = tile_sort3(*map(torch.from_numpy, keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    _assert_lexsorted(got, keys)


@pytest.mark.parametrize("tiles", [0, 1, 9])
def test_crafted_tiles_equal_lexsort(tiles):
    for kind in crafted.TILE_KINDS:
        keys = crafted.tile_keys(kind, tiles, seed=tiles)
        _assert_lexsorted(tile_sort3(*map(torch.from_numpy, keys)), keys)
