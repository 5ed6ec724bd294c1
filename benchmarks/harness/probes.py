"""Device time of one layer at a time, after the window, on the window's own
engine and through its public entry points: a ``--trace 1`` run's
per-layer readers call these.

A chunk probe times back-to-back ``run_chunk`` calls with a CUDA-event
pair around each and sums the spans (every call ends with a host read, so
a span is the device's work of that call and the host's launches that it
waited on); a kernel probe queues its launches behind a spin
(:func:`held_device_us`)."""

from __future__ import annotations

import math
import time

import torch

REPS = 6  # chunk calls per probe
KERNEL_COPIES = 64  # cold inputs per kernel timing: 64 responses exceed the 50 MB L2 at 480x640
KERNEL_REPS = 256


def _spans_ms(fn, reps: int) -> float:
    total = 0.0
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total


def chunk_us_per_frame(engine, frames: torch.Tensor, reps: int = REPS) -> float:
    """Device µs per frame of ``run_chunk`` over ``frames`` (n, H, W),
    called ``reps`` times on one state whose keyframe is ``frames[0]``
    (one call first, untimed, which also makes the state)."""
    holder = {"state": engine.run_chunk(engine.init_state(), frames[:1])[0]}

    def call():
        holder["state"], outs = engine.run_chunk(holder["state"], frames)

    call()
    return 1e3 * _spans_ms(call, reps) / (reps * frames.shape[0])


def still_frames(frame: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` copies of ``frame``: each frame tracks against the same
    keyframe, no travel, no turn and a response above the band, so none
    inserts."""
    return frame.expand(n, *frame.shape).contiguous()


def hopping_frames(frame: torch.Tensor, n: int, slam: dict) -> torch.Tensor:
    """``frame`` and its copy shifted (periodically) by 1.5 keyframe travel
    gates along the image's width, in turn: each frame tracks against the
    other and stores a keyframe, whose loop search then runs."""
    cam, kfs = slam["camera"], slam["keyframe_selection"]
    shift = math.ceil(1.5 * kfs["max_distance"] * cam["intrinsics"][0] / cam["height"])
    pair = torch.stack([frame, torch.roll(frame, shifts=shift, dims=-1)])
    return pair.repeat((n + 1) // 2, 1, 1)[:n].contiguous()


def held_device_us(fn, reps: int = KERNEL_REPS, attempts: int = 8) -> float:
    """Device µs per call of ``fn(i)``: ``reps`` back-to-back calls between
    one pair of CUDA events, queued while a spin kernel
    (``torch.cuda._sleep``) holds the stream, so the interval holds the
    device's work and not the host's launch rate.  Where the spin ended
    before the last call was queued, again behind a spin twice as long
    with half the calls."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin, calls = int(4e9 * host_s) + 1000, reps
    for _ in range(attempts):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for i in range(calls):
            fn(i)
        b.record()
        held = not a.query()
        b.synchronize()
        if held:
            return 1e3 * a.elapsed_time(b) / calls
        spin, calls = spin * 2, max(1, calls // 2)
    raise RuntimeError("the spin ended before the calls were queued")


def registration_stats_us(h: int, w: int, device: torch.device) -> float:
    """Device µs per launch of the program's ``registration_stats`` on (h, w)
    responses, cycling over cold copies."""
    from nislam_torch.ops.peak_stats import registration_stats

    g = torch.Generator(device=device)
    g.manual_seed(0)
    copies = torch.randn((KERNEL_COPIES, h, w), generator=g, device=device)
    return held_device_us(lambda i: registration_stats(copies[i % KERNEL_COPIES], (h, w)))


def registration_stats_bytes(h: int, w: int) -> int:
    """Bytes the kernel must move, each once: the (h, w) float32 response
    read, its 8-word record (trans, psr, peak, index, Σg, Σg², pad)
    written."""
    return 4 * h * w + 4 * 8
