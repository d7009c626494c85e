"""BENCHMARK.json against its contract, and the files it names found by
name: a new configuration, traffic mix or metric is new files only."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark.spec import Spec, find, load_module
from benchmark.tests.conftest import TPC_CELLS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_and_their_readers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        # every cell, and every cell to come, reports every end-to-end metric
        assert "workloads" not in m
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        reader = load_module("metrics", m["name"])
        assert reader.UNIT == m["unit"]
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        reader = load_module("metrics", m["name"])
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        spec = Spec(BENCH, w)
        assert {m["name"] for m in spec.end_to_end} > {"setup_s"} and spec.per_layer


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_reader_declares_itself(path):
    """Each reader, in BENCHMARK.json or kept for a cell to come, has a
    unit, a `read`, and beside a layer the end-to-end metric it moves, one
    of BENCHMARK.json's."""
    reader = load_module("metrics", path.stem)
    assert UNIT.match(reader.UNIT) and callable(reader.read)
    if hasattr(reader, "LAYER"):
        assert reader.LAYER and reader.MOVES in {m["name"] for m in BENCH["end_to_end"]}


def test_new_files_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric reader in another root
    are found by name, beside the benchmark's own: the new cell is new
    files and one `workloads` entry, and reports every end-to-end metric
    with no entry that is there edited."""
    for kind in ("configs", "traffic", "metrics", "generators"):
        (tmp_path / kind).mkdir()
    cfg = json.loads((ROOT / "benchmark/configs/las_terrain.json").read_text())
    cfg.update(name="las_small", batches=4, generator="terrain_flat")
    (tmp_path / "generators" / "terrain_flat.py").write_text(
        "from benchmark.generators.terrain import make  # noqa: F401\n")
    (tmp_path / "configs" / "las_small.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "closeup.json").write_text(json.dumps(dict(
        name="closeup", mode="color", width=640, height=360, lod=1.0, warmup_frames=2,
        check_frames=1, orbit=dict(yaw=2.4, pitch=-0.25, radius_per_extent=0.2,
                                   target_of_extent=[0.5, 0.5], target_z=60.0,
                                   steps_per_turn=720))))
    (tmp_path / "metrics" / "frames.las.py").write_text(
        'UNIT = "frames"\nLAYER = "renderer loop, tail"\nMOVES = "points_per_s"\n\n\n'
        'def read(rec):\n    return rec["window"]["frames"]\n')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="las_small.closeup", config="las_small",
                                   traffic="closeup", chips=1, why="a test"))
    bench["per_layer"].append(dict(name="frames.las", unit="frames", better="higher",
                                   source="host_clock", layer="renderer loop, tail",
                                   moves="points_per_s",
                                   workloads=["las_small.closeup"]))
    spec = Spec(bench, "las_small.closeup", roots=[tmp_path])
    assert spec.config["batches"] == 4 and spec.traffic["width"] == 640
    assert spec.end_to_end == BENCH["end_to_end"]  # every one, as the file has it
    readers = spec.readers(spec.per_layer)
    assert list(readers) == ["frames.las"]
    assert readers["frames.las"][1].read(dict(window=dict(frames=7))) == 7
    assert find("traffic", "orbit", ".json", [tmp_path]).parent.parent == ROOT / "benchmark"
    gen = spec.module("generators", spec.config["generator"])
    assert Path(gen.__file__).parent == tmp_path / "generators" and callable(gen.make)
    assert spec.module("reference", spec.config["format"]).Reference


@pytest.mark.parametrize("cell", TPC_CELLS, ids=lambda w: w["name"])
def test_tpc_cell_is_one_entry(cell):
    """A `.tpc` v2 cell, whose configuration, traffic, writer, reference and
    readers are in the benchmark already, is one `workloads` entry: with it
    added, it reports `points_per_s`, `frame_ms_p95` and `setup_s`, under
    the bounds the `.las` cells have."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(cell)
    spec = Spec(bench, cell["name"])
    assert spec.end_to_end == BENCH["end_to_end"]
    assert set(spec.readers(spec.end_to_end)) == {"points_per_s", "frame_ms_p95", "setup_s"}
    assert spec.module("formats", spec.config["format"]).kernel_bytes
    assert spec.module("reference", spec.config["format"]).Reference


def test_scene_order():
    """Stored in Morton order, most batches of a scene cover a patch of its
    ground (a batch that straddles a coarse Morton cell spans more), not
    the whole of it as the points in the order drawn would."""
    import numpy as np

    from benchmark.generators.terrain import make

    cfg = json.loads((ROOT / "benchmark/configs/las_terrain.json").read_text())
    cfg.update(batches=16)
    pts = make(cfg, 2**31 + 7, "cpu")
    g = pts.grid[:, :2].reshape(16, -1, 2).astype(np.float64)
    area = np.prod(g.max(1) - g.min(1), axis=1) / np.prod(g.max((0, 1)) - g.min((0, 1)))
    assert np.median(area) < 3 / 16
