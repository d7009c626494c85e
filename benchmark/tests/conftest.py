"""Fixtures of the harness's own tests (run from the repo root:
`python -m pytest benchmark/tests -q`).  Tests that need the card carry
the `card` marker and skip inside the test where there is none."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


# the `.tpc` cells, kept out of BENCHMARK.json while the host paces their
# frames too unevenly for a bound (PERF.md, Open questions), run here
TPC_CELLS = [dict(name=f"tpc_v2.{t}", config="tpc_v2_terrain", traffic=t, chips=1, why="")
             for t in ("orbit", "orbit_hqs")]


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    """A search root whose BENCHMARK.json has the real cells and the
    `.tpc` ones on 2-batch scenes at 320x180 (two warm-up frames, one
    checked frame)."""
    root = tmp_path_factory.mktemp("tiny")
    for kind in ("configs", "traffic"):
        (root / kind).mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += TPC_CELLS
    for path in (ROOT / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["batches"] = 2
        (root / "configs" / f"tiny_{path.name}").write_text(json.dumps(cfg))
    for name in {w["traffic"] for w in bench["workloads"]}:
        t = json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())
        t.update(width=320, height=180, warmup_frames=2, check_frames=1)
        (root / "traffic" / f"tiny_{name}.json").write_text(json.dumps(t))
    for w in bench["workloads"]:
        w["config"], w["traffic"] = f"tiny_{w['config']}", f"tiny_{w['traffic']}"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.5,
            trace: int = 0, hook=None, capsys=None) -> dict:
    """One run of a cell on the CPU (the chip check skipped) -> its result."""
    from benchmark.run import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(trace)], device="cpu", roots=[root],
              bench_path=root / "BENCHMARK.json", hook=hook)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
