"""Per-phase frame timing with min/avg/max aggregation, and the tracing
switch: named spans and counters inside the frame.

Role-equivalent of GLTimerQueries (reference: src/GLTimerQueries.cpp:6-153):
label start/end pairs aggregated into min/avg/max stats.  Spans are host
clock; a caller that wants the device's time synchronises
(`torch.cuda.synchronize`) inside the span, or reads the renderer's
CUDA-event `frame_ms`.  A copy of `pcrhpg24_tpu/engine/timing.py`, plus
the switch below.

The switch is on exactly while a `torch.profiler` collects.  Then
`span(name)` is a `torch.profiler.record_function` range, on the same
timeline as the card's kernels, whose host seconds and count are also
added up here, and `count(name, n)` adds `n` to a total;
`take_counters()` hands both out and clears them.  Off, a span or a
count costs one check of the flag.  The names: `renderer.*` (the loop's
`Timings` labels), `las.*` and `tpc.*` (the methods' stages), `pcr_*`
(the kernels' launches, `kernels/build.Kernel`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

# on while a torch.profiler collects
tracing = torch._C._autograd._profiler_enabled
_OFF = nullcontext()
_counters: dict[str, float] = defaultdict(float)
_spans: dict[str, list] = defaultdict(lambda: [0.0, 0])  # name -> [host s, count]


class _Span:
    """A profiler range that adds its host seconds, the range's own cost
    included, to `_spans`."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        dt = time.perf_counter() - self.t0
        total = _spans[self.name]
        total[0] += dt
        total[1] += 1
        return False


def span(name: str):
    """A named range while tracing, else one shared no-op context."""
    return _Span(name) if tracing() else _OFF


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while tracing."""
    if tracing():
        _counters[name] += n


def take_counters() -> dict:
    """What tracing has gathered since the last call, cleared here:
    `counters` {name: total} and `spans` {name: (host seconds, count)}."""
    out = dict(counters=dict(_counters), spans={k: tuple(v) for k, v in _spans.items()})
    _counters.clear()
    _spans.clear()
    return out


@dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class Timings:
    """start/stop label pairs -> per-label min/avg/max milliseconds."""

    def __init__(self, window: int = 0):
        self.stats: dict[str, _Stat] = defaultdict(_Stat)
        self._open: dict[str, float] = {}

    def start(self, label: str) -> None:
        self._open[label] = time.perf_counter()

    def stop(self, label: str) -> None:
        t0 = self._open.pop(label, None)
        if t0 is not None:
            self.stats[label].add((time.perf_counter() - t0) * 1e3)

    @contextmanager
    def span(self, label: str):
        """The label's host time; while tracing also the span
        `renderer.<label>`."""
        with span(f"renderer.{label}"):
            self.start(label)
            try:
                yield
            finally:
                self.stop(label)

    def report(self) -> str:
        lines = [f"{'label':24s} {'min':>8s} {'avg':>8s} {'max':>8s} {'n':>5s}"]
        for label, s in sorted(self.stats.items()):
            lines.append(
                f"{label:24s} {s.min:8.3f} {s.avg:8.3f} {s.max:8.3f} {s.count:5d}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self._open.clear()
