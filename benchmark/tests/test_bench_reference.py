"""The reference against the port on 2-batch scenes on the CPU (the
port's plain paths), its frozen codec copies against the port's codecs,
its control (bfloat16) coming out not correct, and the faults a run can
have coming out not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import bc1, morton
from benchmark.tests.conftest import run_cpu

CELLS = ("tpc_v2.orbit", "las.orbit", "tpc_v2.orbit_hqs", "las.orbit_hqs")


def test_morton_copy():
    from pcrhpg24_tpu_torch.codec.morton import morton_order

    rng = np.random.default_rng(5)
    x, y, z = (rng.integers(-2**31, 2**31 - 1, 5000, dtype=np.int64).astype(np.int32)
               for _ in range(3))
    x[:100] = x[100:200]  # equal keys keep their order
    y[:100], z[:100] = y[100:200], z[100:200]
    got = morton.morton_order(*(torch.from_numpy(a) for a in (x, y, z)))
    assert np.array_equal(got.numpy(), morton_order(x, y, z))


def test_bc1_copy():
    from pcrhpg24_tpu_torch.codec.bc1 import decode_bc1, encode_bc1

    rng = np.random.default_rng(6)
    c = rng.integers(0, 2**24, 4096, dtype=np.int64).astype(np.uint32)
    c[:16] = 0x123456  # a flat block
    want = decode_bc1(encode_bc1(c), np.arange(len(c)))
    assert np.array_equal(bc1.bc1_colors(c), want)


@pytest.mark.parametrize("cell", CELLS)
def test_port_equals_reference(tiny, cell, capsys):
    res = run_cpu(tiny, cell, capsys=capsys)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["wrong_pixels"] == {"value": 0, "limit": 0}
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"points_per_s", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    """The reference computed in bfloat16 in the port's place fails the
    limit of 0 wrong pixels, on each of three seeds."""
    from benchmark.control import wrong_pixels
    from benchmark.spec import Spec

    spec = Spec.load(cell, tiny / "BENCHMARK.json", [tiny])
    for seed in (1, 2**31 + 3, 2**32 + 5):
        assert min(wrong_pixels(spec, seed, 2, "cpu", workers=1)) > 0


def one_frame_late(method, renderer):
    """A step that returns its state unchanged: each frame hands back the
    image of the frame before it."""
    render, last = method.render, []

    def stale(r):
        img = render(r).clone()
        out = last[0] if last else img
        last[:] = [img]
        return out

    method.render = stale


def half_the_batches(method, renderer):
    """Half of the scene's batches left out of every frame."""
    method.las.num_batches_loaded //= 2


def one_pixel_altered(method, renderer):
    """An answer altered where it is produced: one pixel of each image."""
    render = method.render

    def altered(r):
        img = render(r).clone()
        img[90, 160] ^= 0x010101
        return img

    method.render = altered


@pytest.mark.parametrize("fault", (one_frame_late, half_the_batches, one_pixel_altered))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(tiny, cell, fault, capsys):
    res = run_cpu(tiny, cell, hook=fault, capsys=capsys)
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"]["wrong_pixels"]["value"] > 0


@pytest.mark.card
def test_on_the_card(tiny, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.run import main

    for cell in CELLS:
        assert main(["--workload", cell, "--seed", "77", "--seconds", "1", "--trace", "1"],
                    roots=[tiny], bench_path=tiny / "BENCHMARK.json") == 0
        assert '"correct": true' in capsys.readouterr().out.splitlines()[-1]
