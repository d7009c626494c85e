"""Reduction of a `torch.profiler` trace of the measured window.

From the trace's device events (kernels, copies, sets) and annotations
(the `pcr_*` ranges the port's kernel launches sit in, which the
profiler also lays over the device time of the kernels they launched),
and its host events: the device's busy seconds (the union of the
kernels' intervals, `busy_s`), each port kernel's device seconds by its
C symbol, the device seconds of every other kernel, the device
operations that took most time, and the idle gaps between device work
named by the innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

SPAN_PREFIX = "bench."  # the harness's own ranges
OWN_PREFIX = "pcr_"  # the port's kernel launches (`kernels/build.py`)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals (a copy of
    `tools/profile_frame.busy_us`)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _events(prof):
    """(name, on_device, is_annotation, start_us, end_us) of each event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e3
        out.append((name, e.device_type() != torch.autograd.DeviceType.CPU,
                    e.is_user_annotation() or name.startswith((OWN_PREFIX, SPAN_PREFIX)),
                    start, start + e.duration_ns() / 1e3))
    return out


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its namespaces' noise, cut to `width`."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name[:width]


def _host_name_at(host, starts, t: float) -> str:
    """The innermost host event covering time t (the latest-starting one)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4000, -1), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    return "(host outside any op)"


def reduce(prof, frames: int, window_s: float, top: int = 10) -> dict:
    """The traced window's device and host numbers (seconds)."""
    evs = _events(prof)
    device = [(n, s, e) for n, dev, ann, s, e in evs if dev and not ann]
    own = defaultdict(float)
    for n, dev, ann, s, e in evs:
        if dev and ann and n.startswith(OWN_PREFIX):
            own[n] += (e - s) / 1e6
    host = sorted(((n, s, e) for n, dev, _a, s, e in evs if not dev), key=lambda x: x[1])
    starts = [s for _n, s, _e in host]
    busy = busy_us([(s, e) for _n, s, e in device]) / 1e6
    by_op = defaultdict(float)
    for n, s, e in device:
        by_op[short(n)] += (e - s) / 1e6
    gaps = defaultdict(float)
    iv = sorted((s, e) for _n, s, e in device)
    end = iv[0][1] if iv else 0.0
    for s, e in iv[1:]:
        if s > end:
            gaps[_host_name_at(host, starts, 0.5 * (s + end))] += (s - end) / 1e6
        end = max(end, e)
    return dict(
        frames=frames, window_s=window_s, busy_s=busy,
        device_s=sum(by_op.values()), own_s=dict(own),
        breakdown=dict(
            device_ops=[[n, v] for n, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
            idle_gaps=[[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]),
    )
