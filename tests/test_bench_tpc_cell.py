"""The benchmark's cell of the `.tpc` v2 flagship, `tpc_v2.orbit`, as
BENCHMARK.json declares it: the metrics it reports, and runs of it on a
2-batch scene at 320x180 on the CPU (the port's plain paths) against the
benchmark's plain reference: a traced run is correct and reads its host
and span metrics, and a run with a fault planted is not correct.  The
64-batch chunk is cut to the scene's 2 batches, as the scene is cut: the
plain paths would decode and project the 62 empty batches of the padded
chunk too (4-5 s a frame on one core)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark.run import process_age_s, run
from benchmark.spec import Spec
from pcrhpg24_tpu_torch.engine import timing
from pcrhpg24_tpu_torch.engine.debug import Debug
from pcrhpg24_tpu_torch.render.methods import huffman_tpu
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
CELL = "tpc_v2.orbit"
SEED = 2**31 + 11
PER_LAYER = {
    "enqueue_ms.tpc", "idle_share.tpc", "torch_ops_ms.tpc", "frame_args_ms.tpc",
    "live_wait_ms.tpc", "chunk_enqueue_ms.tpc", "b1_decode_roofline",
    "b2_project_roofline", "b3_resolve_roofline", "load_s.tpc",
}
# read on the host clock or from the port's spans: a CPU run has them too
HOST = ("enqueue_ms.tpc", "frame_args_ms.tpc", "live_wait_ms.tpc", "chunk_enqueue_ms.tpc",
        "load_s.tpc")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    """A search root whose BENCHMARK.json is the real one with the cell's
    configuration cut to 2 batches and its traffic to 320x180, two
    warm-up frames and one checked frame."""
    root = tmp_path_factory.mktemp("tiny_tpc")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    cuts = dict(config=("configs", dict(batches=2)),
                traffic=("traffic", dict(width=320, height=180, warmup_frames=2,
                                         check_frames=1)))
    for key, (kind, cut) in cuts.items():
        data = json.loads((ROOT / "benchmark" / kind / f"{cell[key]}.json").read_text())
        data.update(cut)
        cell[key] = f"tiny_{cell[key]}"
        (root / kind).mkdir()
        (root / kind / f"{cell[key]}.json").write_text(json.dumps(data))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """One chunk of the scene's 2 batches; no totals left from another
    test; the LOD a run sets restored."""
    monkeypatch.setattr(huffman_tpu, "CHUNK", 2)
    saved = Debug.lod
    timing.take_counters()
    yield
    timing.take_counters()
    Debug.lod = saved


def run_cpu(root: Path, trace: bool = False, hook=None) -> dict:
    """One run of the cell on the CPU -> its result.  `benchmark.run.run`
    and not `main`, which gives no result in a process that has loaded
    JAX, as this suite's workers have."""
    spec = Spec.load(CELL, root / "BENCHMARK.json", [root])
    result, _checks = run(spec, SEED, 0.5, trace, "cpu", -process_age_s(), hook)
    return result


def test_cell_reports_its_metrics():
    spec = Spec.load(CELL)
    assert spec.cell["chips"] == 1 and spec.config["format"] == "tpc_v2"
    assert spec.config["methods"][spec.traffic["mode"]] == "huffman_tpu"
    assert {m["name"] for m in spec.end_to_end} == {"points_per_s", "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in spec.per_layer} == PER_LAYER


def test_no_las_metric_lists_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        cells = m.get("workloads", ())
        if any(w.startswith("las.") for w in cells):
            assert CELL not in cells, m["name"]


def test_traced_run_is_correct(tiny):
    res = run_cpu(tiny, trace=True)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["wrong_pixels"] == {"value": 0, "limit": 0}
    got = res["metrics"]
    assert {n for n in got if n in PER_LAYER} == set(HOST)  # no device metric from a CPU run
    assert all(got[n]["value"] > 0 for n in HOST)


def half_the_batches(method, renderer):
    """Half of the scene's batches left out of every frame."""
    method.las.num_batches_loaded //= 2


def one_frame_late(method, renderer):
    """Each frame hands back the image of the frame before it."""
    render, last = method.render, []

    def stale(r):
        img = render(r).clone()
        out = last[0] if last else img
        last[:] = [img]
        return out

    method.render = stale


@pytest.mark.parametrize("fault", (half_the_batches, one_frame_late))
def test_fault_is_not_correct(tiny, fault):
    res = run_cpu(tiny, hook=fault)
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"]["wrong_pixels"]["value"] > 0
