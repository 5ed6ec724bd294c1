"""Benchmark: registered frames/s on one card at the flagship configuration.

    python -m nislam_torch.scripts.bench [--quick|--small] [--frames N] [--chunk N]
        [--batch B] [--size H W] [--polar D C] [--scaling N] [--device cuda]

Counterpart of ``bench.py``.  Builds the same config field for field from
``nislam_torch.core.config`` (the 480×640 image and 720×480 polar grid,
bf16 bank with cached filters, 8 loop candidates; ``--quick`` 120×160,
``--small`` 256×256; ``--full`` is the default and a no-op), renders the
same synthetic heading loop with ``nislam_torch.utils.synthetic`` and
moves the frames to the device.  Warm-up: every chunk once, each
followed by ``optimize``, then a host read.  ``bench.py`` warms up on one
chunk because XLA compiles both branches of the deferred solve there; the
port builds a kernel, makes a cuFFT plan and sets up the solver at their
first call, and the flagship's first solve comes in its last chunk, so
only the whole sequence reaches every program that the window runs.
Then, on a fresh state, the timed window: ``run_chunk`` and ``optimize``
for each chunk, ended by the read of the last chunk's poses; ``finalize``
runs after it.  The kernel libraries loaded, the cuFFT plans made and the
CUDA graphs captured inside the window are counted and printed (all 0
when the warm-up did its job: the engine captures its tracked frame there).

Prints to stderr the device, the data generation, the warm-up, ``N
frames in … | tracked | keyframes | loops | ate`` and what the window
loaded, and to stdout ONE JSON
line with ``bench.py``'s keys: ``metric``, ``value`` (frames/s),
``unit``, ``vs_baseline`` (frames/s / 500, BASELINE.md's target),
``ate_rmse_m``, ``tracked_frac``, ``device`` (``cuda:<name>, <power
limit>`` from ``nvidia-smi``, or ``cpu``), ``image``, ``polar``,
``semantics`` and ``loop_truncated_frames``.  ``--batch B`` adds
``batch_size`` and ``batch_frames_per_sec_per_chip`` (B lanes through
``make_batch_engine``).  ``--scaling N`` (default 0) adds the four keys
of ``utils.scaling.shard_work_stats``, exact from shapes; JAX's
collective bytes and efficiency bound need ranks or a virtual mesh and
are not reported.

Environment knobs, as ``bench.py`` reads them: ``NISLAM_BENCH_NO_LOOP=1``
turns the loop search off, ``NISLAM_BENCH_MAX_CAND`` sets the candidates,
``NISLAM_BENCH_COARSE`` the coarse-to-fine scale, ``NISLAM_BENCH_UNROLL``
goes to ``scan_unroll`` (which the port ignores).

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same path on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nislam_torch.scripts.common import asked_device, card_line


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small config (CPU smoke)")
    ap.add_argument("--full", action="store_true",
                    help="the 640x480 / polar 720x480 flagship (the default; a no-op)")
    ap.add_argument("--small", action="store_true", help="256x256 / polar 360x64 config")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--batch", type=int, default=0,
                    help="also measure B lanes through the batch engine (BASELINE config 4)")
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="override the image size (e.g. 448 448 geekplus, 1200 1600 HD)")
    ap.add_argument("--polar", type=int, nargs=2, default=None, metavar=("D", "C"),
                    help="override (rotation_divisor, rotation_channel)")
    ap.add_argument("--scaling", type=int, default=0, metavar="N",
                    help="add the sharded loop search's exact per-rank work at N ranks (0: off)")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    if args.scaling < 0:
        ap.error("--scaling must be 0 or positive")
    return args


def workload(args: argparse.Namespace) -> dict:
    """``bench.py``'s problem size → ``{h, w, rd, rc, n_frames, world_n,
    step_px, chunk}``."""
    if args.quick:
        h, w, rd, rc = 120, 160, 180, 96
        n_frames, world_n, step_px, chunk = args.frames or 128, 1024, 3.0, min(args.chunk, 64)
    elif args.small:
        h, w, rd, rc = 256, 256, 360, 64
        n_frames, world_n, step_px, chunk = args.frames or 256, 2048, 4.0, min(args.chunk, 64)
    else:
        h, w, rd, rc = 480, 640, 720, 480
        n_frames, world_n, step_px, chunk = args.frames or 512, 4096, 8.0, args.chunk
    if args.size:
        h, w = args.size
    if args.polar:
        rd, rc = args.polar
    return dict(h=h, w=w, rd=rd, rc=rc, n_frames=n_frames, world_n=world_n, step_px=step_px, chunk=chunk)


def make_config(h: int, w: int, rd: int, rc: int, n_frames: int, step_px: float, *,
                keyframe_capacity: Optional[int] = None, edge_capacity: Optional[int] = None,
                coarse_scale: Optional[int] = None):
    """``bench.py``'s ``SlamConfig``, field for field.  The keywords
    override its capacities (``max(256, n_frames // 2 + 16)`` slots,
    ``2 * n_frames`` edges) and its coarse scale (``NISLAM_BENCH_COARSE``,
    default 1)."""
    from nislam_torch.core.config import (
        CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig, SlamConfig,
        derive_response_thresholds,
    )

    fx = float(w)
    px = 1.0 / fx
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
            grid_scale=0.3 * h * px,
            keyframe_capacity=keyframe_capacity or max(256, n_frames // 2 + 16),
            edge_capacity=edge_capacity or 2 * n_frames, store_images=False, cache_filters=True, bank_dtype="bf16",
        ),
        loop_closure=LoopClosureConfig(
            to_find_loop=os.environ.get("NISLAM_BENCH_NO_LOOP", "") in ("", "0"),
            position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"],
            frame_gap_thr=30, distance_thr=16 * step_px * px,
            max_candidates=int(os.environ.get("NISLAM_BENCH_MAX_CAND", "8")),
            coarse_scale=coarse_scale or int(os.environ.get("NISLAM_BENCH_COARSE", "1")),
        ),
        camera=CameraConfig(image_width=w, image_height=h, height=1.0, intrinsics=(fx, w / 2.0, fx, h / 2.0)),
        scan_unroll=int(os.environ.get("NISLAM_BENCH_UNROLL", "1")),
    )


def run(args: argparse.Namespace) -> dict:
    """The benchmark → ``{"result": the JSON line's dict, "outs": the timed
    run's per-frame outputs (numpy), "state": the state after
    ``finalize``, "ate": the unrounded ATE, "window_launches":
    ``peak_stats`` kernel launches inside the timed window, "window":
    ``{"loaded_before"/"loaded": the kernel libraries loaded before it /
    first loaded inside it, "fft_plans_before"/"fft_plans": the cuFFT
    plans made before it / inside it (None on the CPU),
    "graphs_before"/"graphs": the CUDA graphs captured before it / inside
    it (None on the CPU)}``}``."""
    from nislam_torch.core.slam import make_engine, outputs_to_numpy
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.kernels.build import loaded
    from nislam_torch.ops.peak_stats import peak_stats
    from nislam_torch.utils.synthetic import add_sensor_noise, heading_loop_path, make_world, render_sequence

    dev = asked_device(args.device, "bench")
    card = card_line(dev)
    print(f"device: {card}", file=sys.stderr)
    wl = workload(args)
    h, w, rd, rc, n_frames, chunk = (wl[k] for k in ("h", "w", "rd", "rc", "n_frames", "chunk"))
    world_n, step_px = wl["world_n"], wl["step_px"]
    px = 1.0 / w
    config = make_config(h, w, rd, rc, n_frames, step_px)

    t0 = time.time()
    world = make_world(world_n, 3.0)
    poses = heading_loop_path(n_frames, step=step_px, start=(world_n / 2.0, world_n / 2.0))
    frames = add_sensor_noise(render_sequence(world, h, w, poses))
    gt = np.array([(p[0] - world_n / 2.0, p[1] - world_n / 2.0) for p in poses]) * px
    print(f"data gen: {time.time() - t0:.1f}s ({n_frames} frames {h}x{w})", file=sys.stderr)

    engine = make_engine(config, dev)
    n_chunks = n_frames // chunk
    n_use = n_chunks * chunk
    frames_d = torch.from_numpy(frames[:n_use]).to(dev).reshape(n_chunks, chunk, h, w)

    # Warm-up: every chunk the window runs, so every kernel build and load,
    # cuFFT plan and solver set-up falls here; ends with a host read.
    t0 = time.time()
    state = engine.init_state()
    for i in range(n_chunks):
        state, _ = engine.run_chunk(state, frames_d[i])
        state, _ = engine.optimize(state)
    int(state.bank.count)
    print(f"warm-up ({n_chunks} chunks with optimize, kernel builds and cuFFT plans included): "
          f"{time.time() - t0:.1f}s", file=sys.stderr)

    # The timed window, on a fresh state.
    state = engine.init_state()
    outs_all = []
    launches, libs, plans, graphs = peak_stats.launches, set(loaded()), fft_plans(dev), graphs_captured(dev)
    t0 = time.time()
    for i in range(n_chunks):
        state, outs = engine.run_chunk(state, frames_d[i])
        state, _ = engine.optimize(state)  # the deferred trigger between chunks
        outs_all.append(outs)
    outs_all[-1].pose.cpu()  # the read ends the window: the last pose depends on every frame
    dt = time.time() - t0
    launches = peak_stats.launches - launches
    window = {"loaded_before": sorted(libs), "loaded": sorted(set(loaded()) - libs),
              "fft_plans_before": plans, "fft_plans": None if plans is None else fft_plans(dev) - plans,
              "graphs_before": graphs, "graphs": None if graphs is None else graphs_captured(dev) - graphs}
    fps = n_use / dt
    outs = outputs_to_numpy(outs_all)
    state, _ = engine.finalize(state)
    tracked = int(outs.tracked.sum())
    n_kf = int(state.bank.count)
    times = np.arange(len(outs.pose)) / 30.0
    try:
        ate = ate_rmse(times, outs.pose[:, :2], times, gt[: len(outs.pose)])
    except ValueError:
        ate = float("nan")
    print(f"{n_use} frames in {dt:.2f}s | tracked {tracked} | keyframes {n_kf} | "
          f"loops {int(outs.loop_found.sum())} | ate {ate:.4f} m", file=sys.stderr)
    plans_line = ("n/a" if plans is None
                  else f"{window['fft_plans_before']} before it, {window['fft_plans']} made inside it")
    graphs_line = ("n/a" if graphs is None
                   else f"{window['graphs_before']} before it, {window['graphs']} inside it")
    print(f"in the timed window: kernel libraries loaded before it {window['loaded_before']}, "
          f"{len(window['loaded'])} inside it {window['loaded']} | cuFFT plans {plans_line} | "
          f"CUDA graphs captured {graphs_line}", file=sys.stderr)

    result = {
        "metric": "registered_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 500.0, 3),
        "ate_rmse_m": round(ate, 4) if ate == ate else None,
        "tracked_frac": round(tracked / n_use, 3),
        "device": f"cuda:{card}" if dev.type == "cuda" else "cpu",
        "image": f"{h}x{w}",
        "polar": f"{rd}x{rc}",
        "semantics": "exact_per_frame",
        # frames whose loop search saw more eligible candidates than it registers
        "loop_truncated_frames": int((outs.loop_eligible > config.loop_closure.max_candidates).sum()),
    }
    if args.batch:
        result.update(run_batch(config, frames, args.batch, chunk, n_frames, dev))
    if args.scaling:
        from nislam_torch.utils.scaling import shard_work_stats

        work = shard_work_stats(keyframe_capacity=256, nshards=args.scaling,
                                max_candidates=config.loop_closure.max_candidates)
        result["scaling_devices"] = args.scaling
        result["scaling_slots_per_shard"] = work["slots_per_shard"]
        result["scaling_registrations_per_shard"] = work["registrations_per_shard"]
        result["scaling_work_balance"] = work["balance"]
    return {"result": result, "outs": outs, "state": state, "ate": ate, "window_launches": launches,
            "window": window}


def fft_plans(dev: torch.device) -> Optional[int]:
    """The plans in the card's cuFFT plan cache (None on the CPU).  The
    cache keeps up to 4096 plans, so its growth counts the plans made."""
    if dev.type != "cuda":
        return None
    return torch.backends.cuda.cufft_plan_cache[dev.index if dev.index is not None else torch.cuda.current_device()].size


def graphs_captured(dev: torch.device) -> Optional[int]:
    """The CUDA graphs this process has captured (None on the CPU, where
    nothing is captured): the engine captures its track graph and its
    keyframe branch once each and builds its chunk graph over them (a
    build counts as a capture), in the warm-up."""
    if dev.type != "cuda":
        return None
    from nislam_torch.core.track_graph import CapturedStep

    return CapturedStep.captures


def run_batch(config, frames: np.ndarray, b: int, chunk: int, n_frames: int, dev: torch.device) -> dict:
    """B lanes of the first frames through ``make_batch_engine``, one chunk
    warm and one timed on fresh states (``bench.py``'s batch measure) →
    the two batch keys.  Prints the lanes' tracked frames, and the CUDA
    graphs captured before and inside the timed chunk (the warm-up
    captures the batch's track graph and each lane's keyframe branch), to
    stderr."""
    from nislam_torch.parallel import make_batch_engine

    beng = make_batch_engine(config, batch=b, device=dev)
    per_seq = max(1, min(chunk, n_frames // 4))
    imgs = torch.from_numpy(frames[:per_seq]).to(dev).expand(b, -1, -1, -1).contiguous()
    _, bouts = beng.run_chunk(beng.init_states(), imgs)
    bouts.pose.cpu()
    states = beng.init_states()
    graphs = graphs_captured(dev)
    t0 = time.time()
    states, bouts = beng.run_chunk(states, imgs)
    bouts.pose.cpu()
    bdt = time.time() - t0
    print(f"batch: {b} lanes x {per_seq} frames in {bdt:.2f}s | tracked per lane "
          f"{bouts.tracked.sum(dim=1).tolist()}", file=sys.stderr)
    print("batch timed chunk: CUDA graphs captured " + ("n/a" if graphs is None else
          f"{graphs} before it, {graphs_captured(dev) - graphs} inside it"), file=sys.stderr)
    return {"batch_size": b, "batch_frames_per_sec_per_chip": round(b * per_seq / bdt, 1)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    print(json.dumps(run(parse(argv))["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
