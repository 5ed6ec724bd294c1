"""Per-frame step-mode latency: ``engine.step_packed`` one frame at a time.

Counterpart of ``scripts/stepbench.py``.  The reference runs a live loop
of at most 50 Hz and prints each frame's latency; this measures, per
frame at the flagship config, the upload of the u8 frame, the step
(``step_packed``) and one read of its packed (17,) output, which waits
for the device, as p50/p90/p99/max over N frames, for both drivers:

- deferred: the step, then the ``optimize`` trigger (two host calls; on
  a card the trigger is one solve-graph launch and one read);
- the same with the trigger as the host loop (``optimize_host_loop``),
  its reference;
- inline: the pose-graph trigger inside the step (``optimizer.inline``):
  on a card a chunk of one through the chunk graph, the inline trigger in
  its stored body;
- the same through the track-graph path (the keyframe branch and the
  inline trigger's host loop launched eagerly after a flag read), its
  reference.

Each is timed on a second pass over the frames, after a first that
captures every graph the pass needs; the two deferred drivers run in
turns, twice each, and so do the two inline ones; each line holds both
of its passes.

Beside them, the dispatch+fence floor measured in the same run: one tiny
operation and a one-element read, the least a frame can cost.

    python -m nislam_torch.scripts.stepbench [--frames 500] [--size 640|1200|256] [--device cuda]

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same loop on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

FLOOR_READS = 50


def make_config(size: int):
    """The flagship config at ``size`` (640: 480×640, 1200: 1200×1600,
    256: 256×256) → ``(config, world size, step in px)``."""
    from nislam_torch.core.config import (
        CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig, SlamConfig,
        derive_response_thresholds,
    )

    if size == 640:
        h, w, rd, rc, world_n, step_px = 480, 640, 720, 480, 4096, 8.0
    elif size == 1200:
        h, w, rd, rc, world_n, step_px = 1200, 1600, 720, 480, 4096, 8.0
    elif size == 256:
        h, w, rd, rc, world_n, step_px = 256, 256, 360, 64, 2048, 4.0
    else:
        raise ValueError(f"--size must be 640, 1200 or 256, got {size}")
    px = 1.0 / w
    thr = derive_response_thresholds(w, h, rd, rc)
    config = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=10.0 * step_px * px, max_angle=0.05236,
            lower_response_thr=thr["lower_response_thr"],
            upper_response_thr=thr["upper_response_thr"],
            lower_rotation_response_thr=thr["lower_rotation_response_thr"],
            upper_rotation_response_thr=thr["upper_rotation_response_thr"],
        ),
        map=MapConfig(
            grid_scale=0.3 * h * px, keyframe_capacity=256 if size != 1200 else 128,
            edge_capacity=1024, store_images=False, cache_filters=True, bank_dtype="bf16",
        ),
        loop_closure=LoopClosureConfig(
            to_find_loop=True, position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"], frame_gap_thr=30,
            distance_thr=16 * step_px * px, max_candidates=8,
        ),
        camera=CameraConfig(image_width=w, image_height=h, height=1.0, intrinsics=(float(w), w / 2.0, float(w), h / 2.0)),
    )
    return config, world_n, step_px


def dispatch_floor_ms(device: torch.device, reads: int = FLOOR_READS) -> np.ndarray:
    """ms of one tiny operation and a one-element read, ``reads`` times."""
    z = torch.zeros((), device=device)
    (z + 1.0).item()
    out = []
    for _ in range(reads):
        t0 = time.perf_counter()
        (z + 1.0).item()
        out.append(1e3 * (time.perf_counter() - t0))
    return np.array(out)


def track_graph_step(engine, state, image):
    """``step_packed`` through the track-graph path: the track graph's
    replay over the chain, the flag read, the keyframe branch (with the
    inline solve's host loop) launched eagerly → (state, packed (17,))."""
    from nislam_torch.core.slam import _graph_track_step

    feats = engine._features(image)
    if not bool(state.track.initialized):
        return engine._init(state, feats)
    engine.track_graph.load(state)
    return _graph_track_step(state, feats, engine.track_graph, **engine._steps())


def step_latencies(config, frames_u8: np.ndarray, device: torch.device, deferred: bool, host_loop: bool = False,
                   track_graph: bool = False):
    """Per-frame ms of upload + ``step_packed`` (``track_graph``: through
    :func:`track_graph_step`) (+ ``optimize`` if ``deferred``,
    ``optimize_host_loop`` with ``host_loop``) + one read of the packed
    output, after a warm-up pass over every frame on a state thrown away
    (the graphs, the keyframe branch's kinds and the solve graph's steps
    captured there, not in the timed pass) → ``(ms (N,), tracked, loops,
    inline solves)``."""
    from nislam_torch.core.slam import make_engine, optimize_host_loop, unpack_step_output

    engine = make_engine(config, device)
    trigger = (lambda s: optimize_host_loop(engine, s)) if host_loop else engine.optimize
    step = (lambda s, x: track_graph_step(engine, s, x)) if track_graph else engine.step_packed
    state = engine.init_state()
    for frame in frames_u8:
        state, out = step(state, torch.from_numpy(frame).to(device))
        if deferred:
            state, _ = trigger(state)
    out.cpu()
    state = engine.init_state()
    lat, tracked, loops, solves = [], 0, 0, 0
    for frame in frames_u8:
        t0 = time.perf_counter()
        state, out = step(state, torch.from_numpy(frame).to(device))  # upload in the budget
        if deferred:
            state, _ = trigger(state)
        o = unpack_step_output(out.cpu())  # the one read: waits for the device
        lat.append(1e3 * (time.perf_counter() - t0))
        tracked += int(o.tracked)
        loops += int(o.loop_found)
        solves += int(o.optimized)
    return np.array(lat), tracked, loops, solves


def latency_line(label: str, runs) -> str:
    """The percentiles over ``runs`` (passes over the frames, one after
    another, each ``(ms, tracked, loops, inline solves)``; the counts the
    fewest of any pass)."""
    lat = np.concatenate([r[0] for r in runs])
    tracked, loops, solves = (min(r[k] for r in runs) for k in (1, 2, 3))
    p50, p90, p99 = np.percentile(lat, [50, 90, 99])
    each = f" in each of {len(runs)} passes" if len(runs) > 1 else ""
    return (f"{label}: p50 {p50:6.1f} ms  p90 {p90:6.1f} ms  p99 {p99:6.1f} ms  max {lat.max():6.1f} ms  "
            f"| tracked {tracked}/{len(lat) // len(runs)} loops {loops} inline solves {solves}{each} | "
            f"sustainable {1e3 / p99:.0f} Hz @p99")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--size", type=int, default=640, choices=(640, 1200, 256))
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"stepbench: --device {args.device} asked for, but no CUDA device is available", file=sys.stderr)
        return 2
    if args.frames < 1:
        ap.error("--frames must be positive")

    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    config, world_n, step_px = make_config(args.size)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}  {config.cf.height}x{config.cf.width} polar "
          f"{config.cf.rotation_divisor}x{config.cf.rotation_channel}", flush=True)
    t0 = time.perf_counter()
    poses = heading_loop_path(args.frames, step_px, start=(world_n / 2.0,) * 2)
    frames = render_sequence(make_world(world_n, 3.0), config.cf.height, config.cf.width, poses)
    # u8: the camera's native payload; the engine normalizes on the device.
    frames_u8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    print(f"data gen: {time.perf_counter() - t0:.1f}s", flush=True)

    floor = dispatch_floor_ms(device)
    print(f"dispatch+fence floor: p50 {np.percentile(floor, 50):.3f} ms  p99 {np.percentile(floor, 99):.3f} ms",
          flush=True)
    # The two deferred drivers in turns, twice each, then the two inline
    # ones: one line each over both passes.
    passes = {False: [], True: []}
    for host_loop in (False, True) * 2:
        passes[host_loop].append(step_latencies(config, frames_u8, device, deferred=True, host_loop=host_loop))
    for host_loop, label in ((False, "deferred (step, then optimize), packed out"),
                             (True, "deferred, the host-loop trigger, packed out")):
        print(latency_line(label, passes[host_loop]), flush=True)
    inline = dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=True))
    passes = {False: [], True: []}
    for track in (False, True) * 2:
        passes[track].append(step_latencies(inline, frames_u8, device, deferred=False, track_graph=track))
    for track, label in ((False, "inline (solve inside the step), the chunk graph, packed out"),
                         (True, "inline, the track-graph path (its host-loop solve), packed out")):
        print(latency_line(label, passes[track]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
