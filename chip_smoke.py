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
5. The HD deployment through the command line: writes a synthetic
   1200×1600 dataset (``heading_loop_path`` with sensor noise, u8 frames in
   a NISF file, no PNGs) with a config that takes every field of
   ``configs/config_HD.yaml`` (720×480 polar grid, ``coarse_scale: 4``,
   bf16 bank without cached filters or images, 1024 keyframe slots, 4096
   edges) and changes only the paths and the texture-dependent thresholds
   and distances, then runs ``python -m nislam_torch run --device cuda``
   on it in this process: a short warm-up, then the timed run with
   ``--save-state``.  Checks every frame tracked, ATE, loops, solves, the
   kernel's launches and the trajectory files; prints frames/s.
6. Resumes from that checkpoint (``--load-state``).
7. Step mode on the HD set (``--mode step --max-frames 64``): p50 and p90
   per-frame latency.  Then a profiled scan over 64 HD frames
   (``--profile``): the device's busy share within that one trace and the
   kernel launches per frame.
8. The inline solve and the online stitcher (``store_images: true``) at
   the flagship size over a 96-frame loop, card against CPU: decisions
   equal, poses within 2e-3, the online canvas equal to ``recompute`` of
   the bank on the card; against the CPU's scatter of the same bank, all
   but 1 % of the cells equal; against both it and the CPU's own canvas,
   the same pixel count and intensity total.

Every phase prints its time.  Prints one JSON line of per-kernel results,
then, as the last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
at the first failed check, and when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

N_FRAMES = 512
CHUNK = 128
N_CPU_FRAMES = 96
N_HD_FRAMES = 192
N_STEP_FRAMES = 64
N_PROFILE_FRAMES = 64
N_OPTION_FRAMES = 96
SUM_RTOL = 1e-5  # sum / sumsq: f32 sums in another order than torch.sum
POSE_ATOL = 2e-3
ROOT = os.path.dirname(os.path.abspath(__file__))


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
        # the HD coarse-to-fine loop search: two hypotheses of 8 candidates
        # at 1/4 resolution, then the winner's two at full resolution
        (8, 2, 300, 400), (2, 1200, 1600),
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
    t = torch.zeros((300, 400), device=dev)
    t[10, 7] = t[299, 3] = t[250, 3] = 4.0  # column-major first: (250, 3)
    yield "ties (300, 400)", t


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


def run_cli(argv) -> str:
    """``python -m nislam_torch`` in this process; prints and returns its
    output (without the per-frame lines of step mode)."""
    from nislam_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if "processing for one frame" not in line and "Insert a keyframe" not in line:
            print(f"  | {line}")
    check(rc == 0, f"nislam_torch {' '.join(argv[:1])} exited {rc}")
    return out


RUN_LINE = re.compile(
    r"(\d+) frames in ([\d.]+)s = ([\d.]+) frames/s \| tracked (\d+)/\d+ \| keyframes (\d+) "
    r"\| edges \d+ \| loops (\d+) \| optimized (\d+)x"
)


def parse_run(out: str) -> dict:
    m = RUN_LINE.search(out)
    check(m is not None, "no summary line in the CLI's output")
    keys = ("frames", "seconds", "fps", "tracked", "keyframes", "loops", "solves")
    vals = dict(zip(keys, (float(x) if "." in x else int(x) for x in m.groups())))
    ate = re.search(r"ATE RMSE \(optimized keyframes\): ([\d.]+) m", out)
    vals["ate"] = float(ate.group(1)) if ate else None
    return vals


def write_hd_dataset(root: str) -> str:
    """A synthetic HD sequence at ``root`` (names, times, ground truth,
    camera, u8 NISF frames) and its config; returns the config path.

    The config is ``configs/config_HD.yaml`` with the dataset paths, the
    saving root and the texture-dependent thresholds and distances
    replaced, sized as ``nislam_torch.io.synth_dataset`` sizes them."""
    import yaml

    from nislam_torch.core.config import load_config
    from nislam_torch.io.synth_dataset import synthetic_sizing
    from nislam_torch.io.trajectory import write_tum
    from nislam_torch.utils.synthetic import add_sensor_noise, heading_loop_path, make_world, render_frame

    with open(os.path.join(ROOT, "configs", "config_HD.yaml")) as f:
        node = yaml.safe_load(f)
    cf = node["correlation_flow"]
    h, w = cf["height"], cf["width"]
    world_n = 1 << int(np.ceil(np.log2(4 * max(h, w))))
    # Steps of w/16 as the synthetic dataset writer takes; fx = width and
    # the camera 1 m above the floor, so one pixel is 1/w m.
    step_px, px = w / 16.0, 1.0 / w
    start = (world_n / 2.0, world_n / 2.0)
    poses = heading_loop_path(N_HD_FRAMES, step=step_px, start=start)
    world = make_world(world_n, 3.0, seed=11)
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        frames = np.stack(list(ex.map(lambda p: render_frame(world, h, w, *p), poses)))
    frames = (np.clip(add_sensor_noise(frames), 0.0, 1.0) * 255.0).astype(np.uint8)
    times = np.arange(N_HD_FRAMES) / 30.0

    with open(os.path.join(root, "frames.nisf"), "wb") as f:
        f.write(struct.pack("<4sIIII", b"NISF", 2, N_HD_FRAMES, h, w))  # v2: u8 frames
        f.write(times.astype("<f8").tobytes())
        f.write(frames.tobytes())
    with open(os.path.join(root, "image_names.txt"), "w") as f:
        f.write("".join(f"{i:06d}.png\n" for i in range(N_HD_FRAMES)))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6f}\n" for t in times))
    gt = np.array([((p[0] - start[0]) * px, (p[1] - start[1]) * px, p[2]) for p in poses])
    write_tum(os.path.join(root, "groundtruth.txt"), times, gt)
    camera = os.path.join(root, "camera.yaml")
    with open(camera, "w") as f:
        yaml.safe_dump({
            "image_size": [w, h], "height": 1.0, "accurate_height": True,
            "intrinsics": {"data": [float(w), w / 2.0, float(w), h / 2.0]},
            "distortion": {"data": [0.0] * 5},
            "extrinsics": {"data": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]},
        }, f)

    sz = synthetic_sizing(w, h, cf["rotation_divisor"], cf["rotation_channel"],
                          N_HD_FRAMES, step_px, px)
    node["dataset"].update(dataroot=root, camera_config=camera)
    kfs = node["keyframe_selection"]
    kfs["max_distance"] = sz["max_distance"]
    for k in ("lower_response_thr", "upper_response_thr", "lower_rotation_response_thr",
              "upper_rotation_response_thr"):
        kfs[k] = sz[k]
    node["map"]["grid_scale"] = sz["grid_scale"]
    lc = node["loop_closure"]
    lc.update(position_response_thr=sz["position_response_thr"],
              angle_response_thr=sz["angle_response_thr"], distance_thr=sz["distance_thr"])
    node["saving"]["saving_root"] = os.path.join(root, "saving")
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(node, f, sort_keys=False)
    c = load_config(path)
    check((c.cf.height, c.cf.width, c.cf.polar_shape) == (1200, 1600, (360, 480))
          and c.loop_closure.coarse_scale == 4 and c.loop_closure.max_candidates == 8
          and c.map.bank_dtype == "bf16" and not c.map.cache_filters and not c.map.store_images
          and (c.map.keyframe_capacity, c.map.edge_capacity) == (1024, 4096),
          f"the HD config lost a field of configs/config_HD.yaml: {c}")
    return path


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_hd(ps, dev) -> dict:
    """Phases 5–7: the HD deployment through the command line."""
    with tempfile.TemporaryDirectory(prefix="nislam_hd_") as root:
        return _run_hd(ps, dev, root)


def _run_hd(ps, dev, root: str) -> dict:
    t0 = time.perf_counter()
    cfg = write_hd_dataset(root)
    print(f"HD dataset: {N_HD_FRAMES} frames written in {time.perf_counter() - t0:.1f} s")
    base = ["run", "--config", cfg, "--device", dev.type, "--nisf", os.path.join(root, "frames.nisf")]
    ck = os.path.join(root, "state.npz")

    t0 = time.perf_counter()
    run_cli(base + ["--max-frames", "24", "--saving-root", os.path.join(root, "warm")])
    print(f"HD warm-up run (24 frames): {time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--groundtruth", os.path.join(root, "groundtruth.txt"),
                          "--save-state", ck, "--saving-root", os.path.join(root, "saving")])
    launches = ps.peak_stats.launches
    hd = parse_run(out)
    print(f"HD via the CLI: {hd['frames']} frames at {hd['fps']} frames/s (the CLI's clock, "
          f"deferred solves and finalize included) | tracked {hd['tracked']} | keyframes "
          f"{hd['keyframes']} | loops {hd['loops']} | solves {hd['solves']} | ATE {hd['ate']} m | "
          f"peak_stats launches {launches} | phase {time.perf_counter() - t0:.1f} s incl. checkpoint")
    check(hd["frames"] == N_HD_FRAMES and hd["tracked"] == N_HD_FRAMES,
          f"HD: tracked {hd['tracked']} of {hd['frames']} frames")
    check(hd["ate"] is not None and hd["ate"] < 0.02, f"HD: ATE {hd['ate']} m >= 0.02 m")
    check(hd["loops"] >= 1, "HD: no loop found")
    check(hd["solves"] >= 1, "HD: no pose-graph solve ran")
    check(launches >= 2 * hd["tracked"], f"HD: {launches} kernel launches < 2 x {hd['tracked']}")
    for name in ("KCC_Keyframe.txt", "optimized_keyframe.txt"):
        path = os.path.join(root, "saving", name)
        with open(path) as f:
            rows = [ln.split() for ln in f if ln.strip()]
        check(len(rows) == hd["keyframes"] and all(np.isfinite(float(v)) for r in rows for v in r),
              f"HD: {name} does not hold {hd['keyframes']} finite keyframe poses")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--load-state", ck, "--max-frames", "16",
                          "--saving-root", os.path.join(root, "resume")])
    resume_launches = ps.peak_stats.launches
    check(f"({hd['keyframes']} keyframes)" in out, "HD: the resumed state lost its keyframes")
    print(f"HD resume: {hd['keyframes']} keyframes loaded, 16 frames run | peak_stats launches "
          f"{resume_launches} | {time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--mode", "step", "--max-frames", str(N_STEP_FRAMES),
                          "--saving-root", os.path.join(root, "step")])
    step_launches = ps.peak_stats.launches
    m = re.search(r"step latency over (\d+) frames: p50 ([\d.]+) ms, p90 ([\d.]+) ms", out)
    check(m is not None and int(m.group(1)) == N_STEP_FRAMES, "HD step mode: no latency line")
    step = parse_run(out)
    check(step["tracked"] == N_STEP_FRAMES, f"HD step mode: tracked {step['tracked']}")
    check(step_launches >= 2 * step["tracked"], f"HD step mode: {step_launches} launches")
    print(f"HD step mode: {N_STEP_FRAMES} frames, per-frame latency p50 {m.group(2)} ms, "
          f"p90 {m.group(3)} ms | peak_stats launches {step_launches} | "
          f"{time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--max-frames", str(N_PROFILE_FRAMES), "--profile", os.path.join(root, "prof"),
                          "--saving-root", os.path.join(root, "prof_out")])
    prof_launches = ps.peak_stats.launches
    b = re.search(r"profiled window ([\d.]+) ms: device busy ([\d.]+) ms \(share ([\d.]+)\), "
                  r"(\d+) kernel launches", out)
    check(b is not None and float(b.group(2)) > 0, "HD profile: no device activity in the trace")
    check(prof_launches >= 2 * N_PROFILE_FRAMES, f"HD profile: {prof_launches} launches")
    print(f"HD profiled scan over {N_PROFILE_FRAMES} frames: device busy {b.group(2)} ms of the "
          f"trace's {b.group(1)} ms window = busy share {b.group(3)} (under the profiler) | "
          f"{int(b.group(4)) / N_PROFILE_FRAMES:.0f} kernel launches per frame | "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches + resume_launches + step_launches + prof_launches, **hd,
            "step_p50_ms": float(m.group(2)), "step_p90_ms": float(m.group(3))}


def option_frames(h: int, w: int):
    """A 96-frame loop that closes early (steps of w/23 px): a 24-frame
    tail back over the start gives loops on consecutive keyframes, then the
    keyframe that finds none fires the inline solve."""
    from nislam_torch.utils.synthetic import add_sensor_noise, heading_loop_path, make_world, render_sequence

    world_n = 4 * w
    poses = heading_loop_path(N_OPTION_FRAMES, step=w / 23.0, start=(world_n / 2.0, world_n / 2.0),
                              tail=24)
    frames = add_sensor_noise(render_sequence(make_world(world_n, 3.0, seed=5), h, w, poses))
    return frames, [(p[0] - world_n / 2.0, p[1] - world_n / 2.0) for p in poses]


def option_config(config, offsets):
    """``config`` with ``optimizer.inline`` and the online stitcher on
    stored keyframe images, the canvas sized and centred to the path as the
    synthetic dataset writer does."""
    import dataclasses

    xs, ys = [p[0] for p in offsets], [p[1] for p in offsets]
    extent = max(max(xs) - min(xs), max(ys) - min(ys)) + 2 * config.cf.width
    size = int(-(-extent // 1024) * 1024)
    center = (int(round((max(xs) + min(xs)) / 2)), int(round((max(ys) + min(ys)) / 2)))
    return dataclasses.replace(
        config,
        map=dataclasses.replace(config.map, store_images=True),
        optimizer=dataclasses.replace(config.optimizer, inline=True),
        map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=size,
                                         canvas_center=center),
    )


def run_options(ps, dev) -> int:
    """Phase 8: inline solve and online stitcher, card against CPU."""
    from nislam_torch.core.slam import make_engine
    from nislam_torch.core.stitcher import make_canvas, recompute

    t0 = time.perf_counter()
    config = flagship_config()
    frames, offsets = option_frames(config.cf.height, config.cf.width)
    config = option_config(config, offsets)
    engine = make_engine(config, dev)
    frames_d = torch.from_numpy(frames).to(dev)
    engine.run_sequence(engine.init_state(), frames_d[:8], chunk_frames=CHUNK)  # warm-up
    sync(dev)
    ps.peak_stats.launches = 0
    gstate, gouts = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK)
    gstate, _ = engine.finalize(gstate)
    sync(dev)
    launches = ps.peak_stats.launches
    cpu = make_engine(config, torch.device("cpu"))
    cstate, couts = cpu.run_sequence(cpu.init_state(), frames, chunk_frames=CHUNK)
    cstate, _ = cpu.finalize(cstate)
    tracked, loops, solves = int(gouts.tracked.sum()), int(gouts.loop_found.sum()), int(gouts.optimized.sum())
    check(tracked == N_OPTION_FRAMES and loops >= 1 and solves >= 1,
          f"inline/online: tracked {tracked}, loops {loops}, inline solves {solves}")
    check(launches >= 2 * tracked, f"inline/online: {launches} kernel launches")
    for name in ("tracked", "inserted", "loop_found", "optimized", "keyframe_slot", "loop_slot"):
        check(np.array_equal(getattr(gouts, name), getattr(couts, name)),
              f"inline/online: card and CPU disagree on {name}")
    pose_err = float(np.abs(gouts.pose - couts.pose).max())
    check(pose_err <= POSE_ATOL, f"inline/online: pose differs by {pose_err}")
    fresh = recompute(make_canvas(config.map_stitcher, dev), gstate.bank, engine.camera)
    check(torch.equal(fresh.weight, gstate.canvas.weight), "online canvas weights != recompute(bank)")
    data_err = float((fresh.data - gstate.canvas.data).abs().max())
    check(data_err <= 1e-5 * float(fresh.data.abs().max()) + 1e-3, f"online canvas data off by {data_err}")
    # The card's scatter against the CPU's on the same inputs: the card's
    # stored images at the card's poses, rasterized on the CPU.  The two
    # devices round the pixel coordinates (cos, sin, the pose chain)
    # differently in the last bit, so a pixel lying on a cell boundary may
    # truncate into the neighbouring cell: all but a few cells agree, and
    # the pixel count and intensity total are the same.
    bank = gstate.bank
    on_cpu = SimpleNamespace(images=bank.images.cpu(), poses=bank.poses.cpu(), count=bank.count.cpu())
    ref = recompute(make_canvas(config.map_stitcher, torch.device("cpu")), on_cpu, cpu.camera)
    gw, gd = gstate.canvas.weight.cpu(), gstate.canvas.data.cpu()
    touched = int((ref.weight != 0).sum())
    flipped = int((gw != ref.weight).sum())
    check(flipped <= 1e-2 * touched, f"card scatter: {flipped} of {touched} cells differ from the CPU's")
    # Against the CPU's own run the poses differ by up to pose_err, which
    # moves whole frames by a fraction of a pixel; again the same pixels
    # and intensities land on the canvas.
    cw, cd = cstate.canvas.weight, cstate.canvas.data
    moved = int((gw != cw).sum())
    total = float(ref.data.double().sum())
    for w, d, what in ((ref.weight, ref.data, "the CPU's scatter of the card's bank"),
                       (cw, cd, "the CPU's run")):
        check(float(gw.double().sum()) == float(w.double().sum()) > 0,
              f"the card's canvas and {what} hold different pixel counts")
        check(abs(float(gd.double().sum()) - float(d.double().sum())) <= 1e-5 * total,
              f"the card's canvas and {what} hold different intensity totals")
    print(f"inline + online at {config.cf.height}x{config.cf.width}, {N_OPTION_FRAMES} frames, card vs CPU: "
          f"decisions equal, {loops} loops, {solves} inline solves, max pose diff {pose_err:.2e}; "
          f"online canvas = recompute(bank) (data within {data_err:.2e}); the card's scatter vs the "
          f"CPU's: {flipped} of {touched} cells differ; card vs CPU run: {moved} cells differ; "
          f"same pixel count and intensity total | peak_stats launches {launches} | {time.perf_counter() - t0:.1f} s")
    return launches


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
    t0 = time.perf_counter()
    kres = check_kernel(dev)
    print(f"kernel checks and timings: {time.perf_counter() - t0:.1f} s")

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

    # --- 5-7. the HD deployment through the CLI ----------------------------
    t0 = time.perf_counter()
    hd = run_hd(ps, dev)
    print(f"HD phases: {time.perf_counter() - t0:.1f} s")

    # --- 8. inline solve + online stitcher, card against CPU -------------------
    option_launches = run_options(ps, dev)

    flag_ms, flag_plain = kres["times"]["(480, 640)"]
    # One CUDA kernel replaces both Pallas kernels (pallas_kernels.py:49
    # and :88, the row-blocked variant for responses over 4 MB).  Its
    # launches are those of every path run above, each counted from 0.
    print(json.dumps({"kernels": [{
        "name": "peak_stats",
        "route": "cuda",
        "source": "nislam_torch/csrc/peak_stats.cu",
        "replaces": "nislam_tpu/ops/pallas_kernels.py:49 and nislam_tpu/ops/pallas_kernels.py:88",
        "launches": launches + hd["launches"] + option_launches,
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
