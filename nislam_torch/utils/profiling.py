"""Tracing: a ``torch.profiler`` context for ``run --profile DIR``, and the
device's busy share read back from the trace it writes."""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator

import torch

# Chrome-trace categories of the card's own work, and the host's launches.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on the CPU and, when a card is present, on the
    card; writes ``trace.json`` (Chrome trace format) and
    ``key_averages.txt`` (time by operator and kernel) into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "self_cuda_time_total" if len(acts) > 1 else "self_cpu_time_total"
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


def device_activity(trace_path: str) -> dict:
    """The device's busy share within one trace: the union of its kernel,
    copy and memset intervals (overlaps on several streams count once)
    over the trace's window, from its first event's start to its last
    event's end, host and device alike.  Also counts the host's kernel
    launches.  Returns ``{"busy_ms", "window_ms", "busy_share",
    "launches", "device_events"}``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in _DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
              if events else 0.0)
    launches = sum(e.get("cat") == "cuda_runtime" and e.get("name") in _LAUNCH_NAMES for e in events)
    return {
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "busy_share": busy / window if window else 0.0,
        "launches": launches,
        "device_events": len(spans),
    }
