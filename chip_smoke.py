#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nislam_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``nislam_torch/csrc`` and prints the build time.
2. Holds the ``peak_stats`` kernel against its plain PyTorch version at
   every response shape of the main path (the 480×640 flagship and the
   1200×1600 HD size, tracking and loop-search batches), on constructed
   ties and on a ragged shape; times both with CUDA events.
3. Drives the flagship workload (480×640 frames, 720×480 polar grid, bf16
   bank with cached filters, 8 loop candidates, the 512-frame heading loop)
   through ``make_engine(config, cuda)`` and ``run_sequence(chunk_frames=128)``
   and ``finalize``: one warm-up run, one timed run with the kernel's launch
   count reset before it.  Checks tracking, loops, solves, ATE and that the
   run went through the kernel.
4. Runs the first 96 frames again on the CPU (plain path) and holds the
   card's per-frame decisions and poses against it.

Prints one JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero at the first failed
check, and when no CUDA device is available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 512
CHUNK = 128
N_CPU_FRAMES = 96
SUM_RTOL = 1e-5  # sum / sumsq: f32 sums in another order than torch.sum


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Median time of ``fn()`` on the card in ms (CUDA events, warm)."""
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


def kernel_cases(dev: torch.device):
    """(label, response) pairs: path shapes with random data, then ties."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [
        (360, 480), (480, 640), (8, 360, 480), (8, 2, 480, 640),
        (1200, 1600), (8, 2, 1200, 1600), (20, 130),
    ]
    for shape in shapes:
        yield str(shape), torch.randn(shape, generator=gen, device=dev)
    # Equal maxima: within one row, and in row bands far apart (different
    # pass-1 blocks).  Column-major first wins: (300, 0) before (5, 1), and
    # (2, 1) before (2, 3).
    t = torch.zeros((480, 640), device=dev)
    t[5, 1] = t[300, 0] = t[2, 3] = t[2, 1] = 7.0
    yield "ties (480, 640)", t
    t = torch.zeros((1200, 1600), device=dev)
    t[10, 5] = t[1100, 4] = 3.0
    yield "ties (1200, 1600)", t
    t = torch.zeros((8, 2, 480, 640), device=dev)
    t[3, 1, 400, 9] = t[3, 1, 7, 9] = t[3, 1, 7, 10] = 2.0
    yield "ties (8, 2, 480, 640)", t
    t = torch.full((20, 130), -1.0, device=dev)
    t[19, 0] = t[0, 129] = 5.0
    yield "ties (20, 130)", t


def check_kernel(dev: torch.device) -> dict:
    from nislam_torch.ops.peak_stats import peak_stats

    worst = 0.0
    times = {}
    for label, g in kernel_cases(dev):
        got = peak_stats(g, force="kernel")
        want = peak_stats(g, force="reference")
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"peak differs at {label}")
        check(torch.equal(got[1], want[1]), f"argmax differs at {label}")
        atol = 1e-5 * g.abs().sum(dim=(-2, -1))
        for k, name in ((2, "sum"), (3, "sumsq")):
            err = (got[k] - want[k]).abs()
            check(bool((err <= SUM_RTOL * want[k].abs() + atol).all()), f"{name} differs at {label}")
            worst = max(worst, float(err.max()))
        if not label.startswith("ties") and label != "(20, 130)":
            times[label] = (
                cuda_ms(lambda: peak_stats(g, force="kernel")),
                cuda_ms(lambda: peak_stats(g, force="reference")),
            )
            print(f"peak_stats {label}: kernel {times[label][0]:.4f} ms, "
                  f"plain {times[label][1]:.4f} ms")
        print(f"peak_stats {label}: equal to the plain version")
    return {"max_abs_err": worst, "times": times}


def flagship_config():
    from nislam_torch.core.config import (
        CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig,
        MapConfig, SlamConfig, derive_response_thresholds,
    )

    h, w, rd, rc = 480, 640, 720, 480
    step_px = 8.0
    px = 1.0 / w
    thr = derive_response_thresholds(w, h, rd, rc)
    return SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=10.0 * step_px * px, max_angle=0.05236,
            lower_response_thr=thr["lower_response_thr"],
            upper_response_thr=thr["upper_response_thr"],
            lower_rotation_response_thr=thr["lower_rotation_response_thr"],
            upper_rotation_response_thr=thr["upper_rotation_response_thr"],
        ),
        map=MapConfig(
            grid_scale=0.3 * h * px, keyframe_capacity=max(256, N_FRAMES // 2 + 16),
            edge_capacity=2 * N_FRAMES, store_images=False, cache_filters=True,
            bank_dtype="bf16",
        ),
        loop_closure=LoopClosureConfig(
            position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"],
            frame_gap_thr=30, distance_thr=16 * step_px * px, max_candidates=8,
            coarse_scale=1,
        ),
        camera=CameraConfig(image_width=w, image_height=h, height=1.0,
                            intrinsics=(float(w), w / 2.0, float(w), h / 2.0)),
    )


def flagship_frames():
    from nislam_torch.utils.synthetic import (
        add_sensor_noise, heading_loop_path, make_world, render_sequence,
    )

    world_n, step_px, w = 4096, 8.0, 640
    world = make_world(world_n, 3.0)
    poses = heading_loop_path(N_FRAMES, step=step_px, start=(world_n / 2.0, world_n / 2.0))
    frames = add_sensor_noise(render_sequence(world, 480, w, poses))
    gt = np.array([(p[0] - world_n / 2.0, p[1] - world_n / 2.0) for p in poses]) / w
    return frames, gt


def run_slice(engine, frames_d):
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK,
                                      solve_tally=tally)
    state, ran = engine.finalize(state)
    return state, outs, sum(tally) + int(ran)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nislam_torch.core.slam import make_engine
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.kernels.build import build
    from nislam_torch.ops import peak_stats as ps

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    build("peak_stats")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")

    # --- 2. kernel against the plain version ---------------------------
    kres = check_kernel(dev)

    # --- 3. the slice on the card --------------------------------------
    t0 = time.perf_counter()
    config = flagship_config()
    frames, gt = flagship_frames()
    engine = make_engine(config, dev)
    frames_d = torch.from_numpy(frames).to(dev)
    print(f"set-up (data, tables): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_slice(engine, frames_d)
    print(f"warm-up run: {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    state, outs, solves = run_slice(engine, frames_d)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ps.peak_stats.launches
    tracked = int(outs.tracked.sum())
    loops = int(outs.loop_found.sum())
    times = np.arange(N_FRAMES) / 30.0
    ate = ate_rmse(times, outs.pose[:, :2], times, gt)
    print(f"slice: {N_FRAMES} frames in {dt:.3f} s = {N_FRAMES / dt:.1f} frames/s "
          f"(incl. deferred solves and finalize) | tracked {tracked} | keyframes "
          f"{int(state.bank.count)} | loops {loops} | solves {solves} | ATE {ate:.5f} m "
          f"| peak_stats launches {launches}")
    check(tracked == N_FRAMES, f"tracked_frac {tracked / N_FRAMES} != 1.0")
    check(loops >= 1, "no loop found")
    check(solves >= 1, "no pose-graph solve ran")
    check(ate < 0.02, f"ATE {ate} m >= 0.02 m")
    check(launches >= 2 * tracked, f"{launches} kernel launches < 2 x {tracked} tracked frames")
    check(bool(np.isfinite(outs.pose).all()), "non-finite poses")

    # --- 4. card against CPU ---------------------------------------------
    t0 = time.perf_counter()
    cpu_engine = make_engine(config, torch.device("cpu"))
    _, cpu_outs = cpu_engine.run_sequence(cpu_engine.init_state(), frames[:N_CPU_FRAMES],
                                          chunk_frames=CHUNK)
    _, gpu_outs = engine.run_sequence(engine.init_state(), frames_d[:N_CPU_FRAMES],
                                      chunk_frames=CHUNK)
    for name in ("tracked", "inserted", "keyframe_slot"):
        check(np.array_equal(getattr(cpu_outs, name), getattr(gpu_outs, name)),
              f"card and CPU disagree on {name}")
    resp_err = np.abs(gpu_outs.response[1:] - cpu_outs.response[1:])  # frame 0: inf
    check(bool(np.allclose(gpu_outs.response, cpu_outs.response, rtol=1e-3, atol=0)),
          f"response differs (max abs {resp_err.max()})")
    pose_err = float(np.abs(gpu_outs.pose - cpu_outs.pose).max())
    check(pose_err <= 2e-3, f"pose differs by {pose_err}")
    print(f"card vs CPU over {N_CPU_FRAMES} frames: decisions equal, max pose diff "
          f"{pose_err:.2e}, max response rel diff "
          f"{float((resp_err / np.abs(cpu_outs.response[1:])).max()):.2e} "
          f"({time.perf_counter() - t0:.1f} s)")

    flag_ms, flag_plain = kres["times"]["(480, 640)"]
    # One CUDA kernel replaces both Pallas kernels (pallas_kernels.py:49
    # and :88, the row-blocked variant for responses over 4 MB).
    print(json.dumps({"kernels": [{
        "name": "peak_stats",
        "route": "cuda",
        "source": "nislam_torch/csrc/peak_stats.cu",
        "replaces": "nislam_tpu/ops/pallas_kernels.py:49",
        "launches": launches,
        "max_abs_err": kres["max_abs_err"],
        "ms": flag_ms,
        "plain_ms": flag_plain,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
