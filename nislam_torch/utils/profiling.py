"""Tracing and timing: a ``torch.profiler`` context for ``run --profile
DIR``, the device's busy share read back from the trace it writes, and
CUDA-event timings of one kernel (device time per launch, and time per
call with the host's share)."""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Callable, Iterator, Sequence

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


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): device-memory rate, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(nbytes: float, f32_ops: float = 0.0) -> tuple:
    """The least time the card could take for work that moves ``nbytes``
    and does ``f32_ops`` float32 operations → ``(ms, "bytes" or
    "operations")``, whichever bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# Bytes of distinct inputs a many-launch timing cycles through: over twice
# the H100's 50 MB L2, so each launch reads device memory, as the bound
# that the time is held against assumes.
COLD_BYTES = 128 << 20


def cold_copies(x: torch.Tensor, reps: int) -> list:
    """Copies of ``x`` (at most ``reps``) that together exceed
    :data:`COLD_BYTES`, for :func:`device_ms_per_launch`."""
    n = max(1, min(reps, -(-COLD_BYTES // max(1, x.numel() * x.element_size()))))
    return [x] + [x.clone() for _ in range(n - 1)]


def device_ms_per_launch(fn: Callable, inputs: Sequence, reps: int = 100) -> float:
    """Device time per call of ``fn`` in ms: ``reps`` back-to-back calls,
    cycling through ``inputs``, between one pair of CUDA events, divided
    by ``reps``.  A spin kernel (``torch.cuda._sleep``) holds the stream
    while the host queues the calls, so the interval holds the device's
    work and not the host's launch rate.  Warm: three calls first."""
    if reps < 1:
        raise ValueError("reps must be positive")
    for i in range(3):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Cycles at up to 2 GHz: the spin outlasts twice the host's queueing time.
    torch.cuda._sleep(int(4e9 * host_s) + 1000)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn: Callable, reps: int = 20) -> float:
    """Median time of one call of ``fn`` in ms, one CUDA-event pair around
    each call: the device's work and the host's launch path (argument
    checks, allocations, the launch) together, as one caller pays it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
