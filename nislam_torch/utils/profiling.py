"""Tracing and timing: a ``torch.profiler`` context for ``run --profile
DIR``, the device's busy share, kernel counts and the kernels that take
the device's time read back from the trace it writes, CUDA-event timings
of one kernel (device time per launch, the launch floor, and time per
call with the host's share), and the host-side
:class:`StageTimer` with its completion fence :func:`device_fence`
(counterparts of ``nislam_tpu.utils.profiling``)."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

# Chrome-trace categories of the card's own work, and the host's launches.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
_GRAPH_LAUNCH_NAMES = ("cudaGraphLaunch", "cuGraphLaunch")
# The host's API calls: cuFFT launches its kernels through the driver API.
_API_CATS = ("cuda_runtime", "cuda_driver")


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor leaf of ``x`` (tensors inside tuples, lists, dicts
    in key order, dataclasses in field order), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        items = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        items = [x[k] for k in sorted(x)]
    elif isinstance(x, (list, tuple)):
        items = x
    else:
        return None
    for item in items:
        leaf = _first_tensor(item)
        if leaf is not None:
            return leaf
    return None


def device_fence(x) -> None:
    """Block until the work that made ``x``'s first tensor leaf has run:
    one element read back to the host (a read waits for the device; a CPU
    tensor is ready already)."""
    leaf = _first_tensor(x)
    if leaf is None:
        raise TypeError(f"device_fence: no tensor in {type(x).__name__}")
    leaf.reshape(-1)[0].item()


class StageTimer:
    """Wall-clock time accumulated per named stage, with a summary."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *, fence=None) -> Iterator[None]:
        """Times the block; with ``fence`` the time runs until
        :func:`device_fence` of it returns."""
        t0 = time.perf_counter()
        yield
        if fence is not None:
            device_fence(fence)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1e3 * self.total[name] / max(self.count[name], 1)

    def summary(self) -> str:
        """One line per stage, the largest total first."""
        return "\n".join(
            f"{name:24s} {self.total[name]:8.3f}s total {self.mean_ms(name):9.3f}ms/call x{self.count[name]}"
            for name in sorted(self.total, key=lambda n: -self.total[n])
        )


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


def _complete_events(trace_path: str) -> list:
    """The complete ("X") events of a Chrome trace."""
    with open(trace_path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _busy_us(events: list) -> tuple:
    """The union of the device's kernel, copy and memset intervals in µs
    (overlaps on several streams count once) → ``(busy, intervals)``."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in _DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def device_activity(trace_path: str) -> dict:
    """The device's busy share within one trace: the union of its kernel,
    copy and memset intervals (overlaps on several streams count once)
    over the trace's window, from its first event's start to its last
    event's end, host and device alike.  Also counts the host's kernel
    launch calls (as :func:`launch_counts` does).  Returns ``{"busy_ms", "window_ms", "busy_share",
    "launches", "device_events"}``."""
    events = _complete_events(trace_path)
    busy, n_spans = _busy_us(events)
    window = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
              if events else 0.0)
    launches = sum(e.get("cat") in _API_CATS and e.get("name") in _LAUNCH_NAMES for e in events)
    return {
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "busy_share": busy / window if window else 0.0,
        "launches": launches,
        "device_events": n_spans,
    }


def launch_counts(trace_path: str, within: Optional[str] = None) -> dict:
    """The host's launch calls apart from the device's kernels in one
    trace: ``{"kernel_launches": the host's kernel launch calls
    (``cudaLaunchKernel`` and kin, through the runtime or the driver
    API), "graph_launches": its CUDA graph launches (``cudaGraphLaunch``),
    "host_launches": the two summed, "kernels": the device's kernels, a
    replayed graph's included}``.  ``within``: only the calls that start
    inside a host range of that name (``torch.profiler.record_function``)
    on their thread, and ``"ranges"``: how many such ranges there are."""
    events = _complete_events(trace_path)
    api = [e for e in events if e.get("cat") in _API_CATS]
    ranges = []
    if within is not None:
        ranges = [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("name") == within and e.get("cat") == "user_annotation"]
        api = [e for e in api if any(e.get("tid") == tid and a <= e["ts"] <= b for tid, a, b in ranges)]
    calls = [e.get("name") for e in api]
    kernels = sum(1 for name in calls if name in _LAUNCH_NAMES)
    graphs = sum(1 for name in calls if name in _GRAPH_LAUNCH_NAMES)
    out = {"kernel_launches": kernels, "graph_launches": graphs, "host_launches": kernels + graphs,
           "kernels": sum(1 for e in events if e.get("cat") == "kernel")}
    if within is not None:
        out["ranges"] = len(ranges)
    return out


def top_kernels(trace_path: str, n: Optional[int] = None) -> dict:
    """The device kernels of one trace by total time: each kernel name's
    summed duration, launch count and share of the device's busy time
    (the union that :func:`device_activity` reads, copies and memsets
    included), the largest first, the first ``n`` of them (all with
    None).  The counterpart of the leaf-op self times that
    ``scripts/traceparse.py`` reads from an XLA trace.  Returns
    ``{"busy_ms", "kernels": [{"name", "ms", "launches", "share"}, ...]}``."""
    events = _complete_events(trace_path)
    busy, _ = _busy_us(events)
    total: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") == "kernel":
            total[e["name"]] += e.get("dur", 0)
            count[e["name"]] += 1
    names = sorted(total, key=lambda k: (-total[k], k))[:n]
    return {"busy_ms": busy / 1e3, "kernels": [
        {"name": k, "ms": total[k] / 1e3, "launches": count[k], "share": total[k] / busy if busy else 0.0}
        for k in names
    ]}


def kernel_counts(trace_path: str, contains: str) -> dict:
    """``{kernel name: launches}`` of the device kernels in one trace whose
    name contains ``contains``."""
    counts: dict = {}
    for e in _complete_events(trace_path):
        if e.get("cat") == "kernel" and contains in e.get("name", ""):
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


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


# Measurements taken by device_ms_per_launch before it gives up.
HOLD_ATTEMPTS = 8

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
    """Device time per call of ``fn`` in ms: ``reps`` back-to-back calls
    between one pair of CUDA events, divided by the number of calls.  A
    spin kernel (``torch.cuda._sleep``) holds the stream while the host
    queues the calls, so the interval holds the device's work and not the
    host's launch rate.  If the spin has ended by the time the last call
    is queued, the measurement is taken again behind a spin twice as long
    and with half the calls, down to one: the host was slower than in the
    trial loop that sized the spin, or the calls' launches filled the
    stream's launch queue, which blocks the host until the spin ends (a
    call of ~70 kernels, 30 times over, does).  Raises if even one call
    cannot be held.  Warm: three calls first.

    Every call, warm, trial and measured alike, takes the next of
    ``inputs`` in one round: between two reads of an input every other
    input is read, so with :func:`cold_copies` each call reads device
    memory however few calls a measurement keeps."""
    if reps < 1:
        raise ValueError("reps must be positive")
    feed = itertools.cycle(inputs)
    for _ in range(3):
        fn(next(feed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(next(feed))
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Cycles at up to 2 GHz: the spin outlasts twice the host's queueing time.
    spin = int(4e9 * host_s) + 1000
    calls = reps
    for _ in range(HOLD_ATTEMPTS):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn(next(feed))
        end.record()
        held = not start.query()  # the spin was still running when the last call was queued
        end.synchronize()
        if held:
            return start.elapsed_time(end) / calls
        spin *= 2
        calls = max(1, calls // 2)
    raise RuntimeError(f"device_ms_per_launch: {HOLD_ATTEMPTS} spins ended before the calls were queued")


def launch_floor_ms(reps: int = 100) -> float:
    """The card's launch floor: device ms per launch of a kernel that does
    nothing (``csrc/sum_only.cu``'s empty kernel), by
    :func:`device_ms_per_launch`.  No kernel's time per launch can go below
    it, so a share of a bound that is smaller than the floor is read
    against ``max(bound, floor)``."""
    from nislam_torch.ops.sum_only import empty_launch

    stream = torch.cuda.current_stream().cuda_stream
    return device_ms_per_launch(lambda _: empty_launch(stream), [None], reps)


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
