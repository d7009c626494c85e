"""`BENCHMARK.json` and the files it names, found by name.

A configuration is `configs/<name>.json`, a traffic mix
`traffic/<name>.json`, a metric's reader `metrics/<name>.py`, a scene
generator `generators/<name>.py`, a scene format's writer
`formats/<name>.py` and its reference `reference/<name>.py`.  Each is
looked up in the search roots in order (the benchmark's own folder
last), so that a test can add files in a directory of its own.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def find(kind: str, name: str, suffix: str, roots=()) -> Path:
    """The file `<root>/<kind>/<name><suffix>` of the first root that has it."""
    for root in (*roots, HERE):
        p = Path(root) / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} in {[*roots, HERE]}")


def load_json(kind: str, name: str, roots=()) -> dict:
    return json.loads(find(kind, name, ".json", roots).read_text())


def load_module(kind: str, name: str, roots=()):
    """Import `<kind>/<name>.py` by its path (a metric's name may hold
    dots), once: the module is kept under `benchmark.<kind>.<name>`, so
    that worker processes can unpickle its functions."""
    path = find(kind, name, ".py", roots).resolve()
    full = f"benchmark.{kind}.{name}"
    mod = sys.modules.get(full)
    if mod is not None and Path(getattr(mod, "__file__", "")).resolve() == path:
        return mod
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """One cell of a benchmark file with its configuration, traffic and metrics."""

    def __init__(self, bench: dict, workload: str, roots=()):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
        self.roots = tuple(roots)
        self.cell = cells[workload]
        self.config = load_json("configs", self.cell["config"], self.roots)
        self.traffic = load_json("traffic", self.cell["traffic"], self.roots)
        self.run_seconds = bench["run_seconds"]
        self.end_to_end = [m for m in bench["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.reports(m)]

    @classmethod
    def load(cls, workload: str, path=None, roots=()):
        path = Path(path) if path else ROOT / "BENCHMARK.json"
        return cls(json.loads(path.read_text()), workload, roots)

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.cell["name"] in metric["workloads"]

    def module(self, kind: str, name: str):
        return load_module(kind, name, self.roots)

    def readers(self, metrics) -> dict:
        """name -> (metric entry, reader module) for each metric."""
        return {m["name"]: (m, self.module("metrics", m["name"])) for m in metrics}
