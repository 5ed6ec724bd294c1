"""What the port's measuring scripts share: their sizes, the device a run
was asked for (and never another), the card's name and power limit, and
the time of one call on that device through the port's timing tools."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Optional, Sequence

import torch

# --size → (h, w, rotation_divisor, rotation_channel) of stagebench and
# polarbench, as the JAX scripts size them.
SIZES = {256: (256, 256, 360, 240), 640: (480, 640, 720, 480), 1200: (1200, 1600, 720, 480)}


def asked_device(name: str, prog: str) -> torch.device:
    """``torch.device(name)``; a CUDA device that is not there ends the run
    (exit code 1) with a message that names ``--device cpu``.  Nothing
    falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: --device {name} asked for, but no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``); ``cpu`` for the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def time_call(fn: Callable, inputs: Sequence, reps: int, device: torch.device,
              call_fn: Optional[Callable] = None) -> Dict[str, float]:
    """µs per call of ``fn`` on ``inputs`` (cycled).  On the card:
    ``device_us``, ``reps`` back-to-back calls between one pair of CUDA
    events (:func:`~nislam_torch.utils.profiling.device_ms_per_launch`),
    and ``call_us``, one event pair around each call of ``call_fn`` (None:
    ``fn``; a call that reads the host, which back-to-back calls cannot
    hold), the host's launch path included
    (:func:`~nislam_torch.utils.profiling.call_ms`).  On the CPU:
    ``cpu_us``, the host clock over ``reps`` calls of ``call_fn`` after one."""
    call_fn = fn if call_fn is None else call_fn
    if device.type == "cuda":
        from nislam_torch.utils.profiling import call_ms, device_ms_per_launch

        return {"device_us": 1e3 * device_ms_per_launch(fn, inputs, reps),
                "call_us": 1e3 * call_ms(lambda: call_fn(inputs[0]), reps)}
    fn = call_fn
    fn(inputs[0])
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    return {"cpu_us": 1e6 * (time.perf_counter() - t0) / reps}


def format_times(t: Dict[str, float]) -> str:
    """``time_call``'s result as one column group of a table line."""
    if "device_us" in t:
        return f"{t['device_us']:10.1f} us device  {t['call_us']:10.1f} us with the host"
    return f"{t['cpu_us']:10.1f} us on the CPU (host clock)"
