"""The yardstick's arithmetic on hand-made inputs: the union of device
intervals, the kernels' least bytes, the roofline share and the readers."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import readers
from benchmark.formats import las, tpc_v2
from benchmark.reference.common import View
from benchmark.roofline import HBM_BYTES_PER_S, share, swizzled_size
from benchmark.trace import busy_us


def test_busy_us_is_the_union():
    assert busy_us([]) == 0.0
    assert busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25.0
    assert busy_us([(20, 30), (0, 10)]) == 20.0


def test_swizzled_size():
    assert swizzled_size(1920, 1080) == 60 * 34 * 1024
    assert swizzled_size(32, 32) == 1024


class FakeTpc:
    """Two live chunks of a 130-batch scene (chunks 0 and 2), 64 points."""

    def live(self, v):
        return np.array([0, 2]), 64


def test_tpc_bytes():
    view = View(0.5, -0.9, 2500.0, (1000, 1000, 100), 64, 32)
    words = [100] * 130  # 130 batches of 100 stream words
    got = tpc_v2.kernel_bytes(dict(stream_words=words), FakeTpc(), [view], hqs=True)
    entries = 2 * 64 * 64 * 1024
    coords = 12 * entries
    tables = 2 * 64 * (2 * 3 * 1024 * 4 + 256)
    assert got["pcr_decode_fixed"] == tables + 4 * (64 * 100 + 2 * 100) + coords
    assert got["pcr_project"] == 2 * coords + 2 * (64 * (32768 + 12 + 16 + 4) + 48)
    size = 2 * 1 * 1024
    assert got["pcr_u64_min"] == coords + 8 * size
    assert got["pcr_hqs_sums"] == coords + 20 * size


class FakeLas:
    B = 3


def test_las_bytes():
    view = View(0.5, -0.9, 2500.0, (1000, 1000, 100), 100, 10)
    got = las.kernel_bytes({}, FakeLas(), [view], hqs=True)
    assert got == {"pcr_u64_min_flat": 12 * 3 * 65536 + 8000,
                   "pcr_hqs_sums_flat": 12 * 3 * 65536 + 20000}


def test_share():
    assert share(HBM_BYTES_PER_S * 1e-3, 2e-3) == pytest.approx(50.0)


def record(**trace):
    rec = dict(setup_s=30.0, load_s=4.0,
               window=dict(seconds=2.0, frames=4, frame_s=[0.4, 0.5, 0.5, 0.6],
                           enqueue_s=[0.1, 0.2, 0.1, 0.2], points=[10**9] * 4))
    if trace:
        rec["trace"] = trace
    return rec


def test_readers():
    rec = record(frames=5, busy_s=1.0, window_s=3.0, device_s=1.5,
                 own_s=dict(pcr_project=0.5), bytes=dict(pcr_project=HBM_BYTES_PER_S * 0.05))
    assert readers.points_per_s(rec) == 2.0
    assert readers.frame_ms_p95(rec) == pytest.approx(585.0)
    assert readers.enqueue_ms(rec) == pytest.approx(150.0)
    assert readers.idle_share(rec) == pytest.approx(1 - 0.2 / 0.5)
    assert readers.torch_ops_ms(rec) == pytest.approx(200.0)
    assert readers.roofline(rec, "pcr_project") == pytest.approx(50.0)
    assert readers.roofline(rec, "pcr_u64_min") is None  # not launched: nothing to read
    assert readers.idle_share(record()) is None
    assert readers.idle_share(record(frames=5, busy_s=0.0, device_s=0.0, own_s={})) is None
