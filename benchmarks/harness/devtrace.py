"""What a ``--trace 1`` run reads of the device.

- :func:`profiled`: one more whole sequence under ``torch.profiler`` →
  the seconds in which a kernel, copy or memset ran (the union of their
  intervals), the traced window's length, and the kernels that took the
  most device time.  CUPTI records the kernels inside a CUDA graph's
  conditional bodies only in part, so on the engine's graph paths the
  busy time is a lower bound.
- :func:`call_spans`: the CUDA-event pairs that the window put around
  each engine call → each call's device span and the device's idle gaps
  between calls, laid out on the device's clock, by what the host did in
  them.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a kernel's name as the breakdown keeps it


def _device_events(prof) -> List[Tuple[str, float, float]]:
    """``(name, start µs, end µs)`` of the device's kernels, copies and
    memsets in a finished profile, from its Chrome trace (written under
    ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]


def busy_seconds(spans: List[Tuple[str, float, float]]) -> float:
    """The union of the intervals (µs) → seconds; overlaps count once."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def top_ops(spans: List[Tuple[str, float, float]], n: int = 10) -> List[list]:
    """``[[name, seconds], ...]``: the ``n`` device operations that took the
    most time in all."""
    total: Dict[str, float] = collections.defaultdict(float)
    for name, a, b in spans:
        total[name] += (b - a) / 1e6
    return [[k[:NAME_CHARS], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def profiled(fn) -> dict:
    """``fn()`` under the profiler (the card's activity and the host's) →
    ``{"busy_s", "window_s", "device_ops"}``; ``window_s`` is the host's
    clock around the call, which ends with a host read."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    spans = _device_events(prof)
    return {"busy_s": busy_seconds(spans), "window_s": window, "device_ops": top_ops(spans),
            "kernels": len(spans)}


def call_spans(calls) -> dict:
    """The window's engine calls on the device's clock → ``{"busy_ms": the
    calls' summed spans, "by_kind": {kind: (calls, ms)}, "gaps": {what the
    host did: ms of device idle}, "solve_ms": [span of each trigger that
    solved]}``."""
    torch.cuda.synchronize()
    origin = calls[0].start
    by_kind: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    gaps: Dict[str, float] = collections.defaultdict(float)
    busy, solves, prev_end = 0.0, [], None
    for c in calls:
        a, b = origin.elapsed_time(c.start), origin.elapsed_time(c.end)
        span = b - a
        busy += span
        kind = c.kind + (" (solved)" if c.ran else "")
        by_kind[kind][0] += 1
        by_kind[kind][1] += span
        if c.ran:
            solves.append(span)
        if prev_end is not None and a > prev_end:
            gaps[c.gap] += a - prev_end
        prev_end = b
    return {"busy_ms": busy, "by_kind": {k: tuple(v) for k, v in by_kind.items()}, "gaps": dict(gaps),
            "solve_ms": solves}
