"""Command line of the PyTorch port: ``python -m nislam_torch``.

Counterpart of ``nislam_tpu.cli``, flag for flag, plus ``--device``: the
device is always the user's choice (``cuda``, ``cuda:N`` or ``cpu``),
never guessed.

    python -m nislam_torch synth --out DATA --frames 120 --height 120 --width 160
    python -m nislam_torch run --config DATA/config.yaml --device cuda
    python -m nislam_torch run --config DATA/config.yaml --device cuda --mode step
    python -m nislam_torch pack --dataroot DATA --out DATA/frames.nisf
    python -m nislam_torch calibrate --config DATA/config.yaml --device cuda

    python -m nislam_torch eval --config DATA/config.yaml --device cuda --model slam

``run`` writes ``KCC_Keyframe.txt`` (raw odometry at each keyframe) and
``optimized_keyframe.txt`` (the optimized keyframe poses), both in TUM
format, under the saving root.  ``eval`` prints one JSON line (frames,
frames/s, ATE, tracked fraction, keyframes, device; loops and solves for
``slam``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import List

import numpy as np


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", required=True,
        help="torch device to run on: cuda, cuda:N or cpu (no default)",
    )


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True, help="YAML config path")
    _add_device_arg(p)
    p.add_argument("--dataroot", default=None, help="override dataset.dataroot")
    p.add_argument(
        "--mode", choices=["scan", "step"], default="scan",
        help="scan: chunked, outputs read once at the end (fast); step: one "
        "frame at a time with a per-frame latency print",
    )
    p.add_argument("--chunk", type=int, default=64, help="scan chunk length")
    p.add_argument("--max-frames", type=int, default=0, help="truncate dataset")
    p.add_argument("--saving-root", default=None, help="override saving.saving_root")
    p.add_argument("--load-state", default=None, help="resume from checkpoint")
    p.add_argument("--save-state", default=None, help="write final state checkpoint")
    p.add_argument("--groundtruth", default=None, help="TUM groundtruth file for ATE")
    p.add_argument("--plot", action="store_true", help="save trajectory plot (matplotlib)")
    p.add_argument(
        "--stitch", action="store_true",
        help="rasterize the occupancy mosaic and save it as PNG",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR",
    )
    p.add_argument(
        "--nisf", default=None, metavar="PATH",
        help="stream frames from a packed NISF file instead of decoding "
        "images; 'auto' (the default) uses DATAROOT/frames.nisf when "
        "present; 'off' disables",
    )
    p.add_argument(
        "--calibrate", type=int, default=0, metavar="K", nargs="?", const=32,
        help="before running, measure the PSR anchors on the first K "
        "(default 32) frames and rescale every response threshold to the "
        "measured texture",
    )
    p.add_argument(
        "--snapshot-every", type=int, default=0, metavar="N",
        help="in step mode: save trajectory/occupancy snapshot PNGs to "
        "saving_root every N frames (0 disables)",
    )


def _nisf_path(arg, dataroot: str):
    """The NISF file to stream, or None for the image reader."""
    if arg == "off":
        return None
    path = arg if arg not in (None, "auto") else os.path.join(dataroot, "frames.nisf")
    if os.path.exists(path):
        return path
    if arg not in (None, "auto"):
        print(f"WARNING: NISF file {path} not found; using the image reader")
    return None


def cmd_run(args: argparse.Namespace) -> int:
    import torch

    from nislam_torch.core.config import load_config
    from nislam_torch.core.slam import make_engine, streamed_deferred_drive, unpack_step_output
    from nislam_torch.io.checkpoint import load_state, save_state
    from nislam_torch.io.dataset import open_dataset
    from nislam_torch.io.native_loader import NativeChunkReader
    from nislam_torch.io.trajectory import ate_rmse, read_tum, write_tum

    device = torch.device(args.device)
    config = load_config(args.config)
    dataroot = args.dataroot or config.dataset.dataroot
    dataset = open_dataset(dataroot, config.dataset.image_dir_name or "rgb")
    n = len(dataset)
    if args.max_frames:
        n = min(n, args.max_frames)
    print(f"dataset: {dataroot} ({n} frames)")
    nisf_path = _nisf_path(args.nisf, dataroot)

    if args.calibrate:
        from nislam_torch.core.calibrate import apply_thresholds, calibrate_thresholds

        k = min(args.calibrate, n)
        if nisf_path is not None:
            reader = NativeChunkReader(nisf_path, chunk=k, threads=0)
            probe = next(iter(reader))[0]
            reader.close()
        else:
            probe = np.stack([dataset.get_raw(i)[0] for i in range(k)])
        thr, diag = calibrate_thresholds(config, probe, device)
        config = apply_thresholds(config, thr)
        print(
            f"calibrated thresholds on {k} frames "
            f"(texture ratio t={diag['texture_ratio_translation']} "
            f"r={diag['texture_ratio_rotation']}; tracking margin "
            f"{diag['margin_tracking']}x, loop separation "
            f"{diag['separation_position']}x): "
            + ", ".join(f"{kk}={vv}" for kk, vv in thr.items())
        )

    engine = make_engine(config, device)
    state = engine.init_state()
    if args.load_state:
        state = load_state(args.load_state, state)
        print(f"resumed from {args.load_state} ({int(state.bank.count)} keyframes)")

    if args.profile:
        from nislam_torch.utils.profiling import trace

        prof_ctx = trace(args.profile)
    else:
        prof_ctx = contextlib.nullcontext()

    # With the deferred solve the trigger runs after every frame in step
    # mode (after every chunk in scan mode, inside the driver); with
    # optimizer.inline the step itself solves.
    deferred = not config.optimizer.inline
    mid_run_solves = 0
    all_times: List[float] = []
    t_start = time.time()
    with prof_ctx:
        if args.mode == "step":
            snap = None
            if args.snapshot_every:
                from nislam_torch.io.visualization import RunSnapshotter

                snap = RunSnapshotter(args.saving_root or config.saving.saving_root, engine, config)
            if nisf_path is not None:
                reader = NativeChunkReader(nisf_path, chunk=1, threads=0)
                n = min(n, len(reader))
                times_nisf = reader.timestamps()
                print(f"NISF reader: {nisf_path} ({len(reader)} frames)")

                def get_frame(i):
                    return reader.frame(i), float(times_nisf[i])
            else:
                get_frame = dataset.get_raw  # u8 when 8-bit: 4x fewer upload bytes

            outs_list, lat_ms = [], []
            for i in range(n):
                img, ts = get_frame(i)
                all_times.append(ts)
                t1 = time.perf_counter()
                state, packed = engine.step_packed(state, torch.from_numpy(np.array(img)))
                if deferred:
                    state, ran = engine.optimize(state)
                    mid_run_solves += int(ran)
                out = unpack_step_output(packed.cpu().numpy())  # the one read of the frame
                lat_ms.append(1e3 * (time.perf_counter() - t1))
                print(f"{i}: processing for one frame is {lat_ms[-1]:.2f}ms")
                outs_list.append(out)
                if out.inserted:
                    print("Insert a keyframe !")
                if snap is not None and (i + 1) % args.snapshot_every == 0:
                    snap.emit(state, outs_list, i + 1)
            outs = type(outs_list[0])(*(np.stack(xs) for xs in zip(*outs_list)))
            if lat_ms:
                p50, p90 = np.percentile(lat_ms, [50, 90])
                print(f"step latency over {len(lat_ms)} frames: p50 {p50:.3f} ms, p90 {p90:.3f} ms")
        else:
            if nisf_path is not None:
                # Bound for the card, the reader threads copy each chunk
                # into pinned memory, ready for an asynchronous upload.
                reader = NativeChunkReader(nisf_path, args.chunk, pin=device.type == "cuda")
                n = min(n, len(reader))
                print(f"NISF reader: {nisf_path} ({len(reader)} frames)")
                chunk_iter = iter(reader)
            else:
                chunk_iter = dataset.chunks(args.chunk, raw=True)
            state, outs, times_arr, ran_flags = streamed_deferred_drive(
                engine, state, chunk_iter, max_frames=n,
            )
            if nisf_path is not None:
                reader.close()  # joins its read-ahead threads
            all_times = times_arr.tolist()
            mid_run_solves = int(sum(ran_flags))
        state, ran = engine.finalize(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    elapsed = time.time() - t_start
    if args.profile:
        print(f"profiler trace written to {args.profile}")
        if device.type == "cuda":
            from nislam_torch.utils.profiling import device_activity, launch_counts

            path = os.path.join(args.profile, "trace.json")
            act, lc = device_activity(path), launch_counts(path)
            print(
                f"profiled window {act['window_ms']:.1f} ms: device busy {act['busy_ms']:.1f} ms "
                f"(share {act['busy_share']:.4f}), {act['launches']} kernel launches "
                f"({act['launches'] / max(n, 1):.0f} per frame) and {lc['graph_launches']} graph launches "
                f"({lc['graph_launches'] / max(n, 1):.1f} per frame) from the host, {lc['kernels']} device "
                f"kernels ({lc['kernels'] / max(n, 1):.0f} per frame)"
            )
    n_kf = int(state.bank.count)
    inline_solves = int(outs.optimized.sum())
    print(
        f"{n} frames in {elapsed:.2f}s = {n / elapsed:.1f} frames/s | "
        f"tracked {int(outs.tracked.sum())}/{n} | "
        f"keyframes {n_kf} | edges {int(state.edges.count)} | "
        f"loops {int(outs.loop_found.sum())} | "
        f"optimized {inline_solves + mid_run_solves + int(ran)}x"
    )
    print(f"mid-run pose-graph solves: {mid_run_solves + inline_solves}")
    edge_ovf = int(state.edges.overflow)
    bank_ovf = int(state.bank.overflow)
    if edge_ovf:
        print(
            f"WARNING: edge store overran capacity {state.edges.capacity} "
            f"({edge_ovf} forced replacements/drops — oldest odometry edges "
            f"were sacrificed; raise map.edge_capacity)"
        )
    if bank_ovf and config.map.eviction == "drop":
        print(
            f"WARNING: keyframe bank dropped {bank_ovf} keyframes at capacity "
            f"{state.bank.capacity} (eviction=drop; raise map.keyframe_capacity)"
        )
    max_elig = int(outs.loop_eligible.max()) if len(outs.loop_eligible) else 0
    cand_cap = config.loop_closure.max_candidates
    if max_elig > cand_cap:
        print(
            f"WARNING: loop search truncated on {int((outs.loop_eligible > cand_cap).sum())} "
            f"frames — up to {max_elig} eligible candidates vs max_candidates {cand_cap} "
            f"(the nearest to the prior pose were searched; raise "
            f"loop_closure.max_candidates to search them all)"
        )

    saving_root = args.saving_root or config.saving.saving_root
    os.makedirs(saving_root, exist_ok=True)
    times_arr = np.asarray(all_times)
    kf_idx = np.where(outs.keyframe_slot >= 0)[0]
    kf_slots = outs.keyframe_slot[kf_idx]
    kcc_path = os.path.join(saving_root, "KCC_Keyframe.txt")
    write_tum(kcc_path, times_arr[kf_idx], outs.cf_pose[kf_idx])
    opt_path = os.path.join(saving_root, "optimized_keyframe.txt")
    bank_poses = state.bank.poses.cpu().numpy()
    write_tum(opt_path, times_arr[kf_idx], bank_poses[kf_slots])
    print(f"saved {kcc_path}, {opt_path}")

    if args.save_state:
        save_state(args.save_state, state)
        print(f"saved state checkpoint to {args.save_state}")

    if args.groundtruth:
        gt_times, gt_poses = read_tum(args.groundtruth)
        ate = ate_rmse(times_arr[kf_idx], bank_poses[kf_slots][:, :2], gt_times, gt_poses[:, :2])
        print(f"ATE RMSE (optimized keyframes): {ate:.4f} m")

    if args.plot:
        from nislam_torch.io.visualization import save_trajectory_plot

        gt_xy = read_tum(args.groundtruth)[1][:, :2] if args.groundtruth else None
        p = save_trajectory_plot(
            os.path.join(saving_root, "trajectory.png"),
            outs.cf_pose[kf_idx][:, :2], bank_poses[kf_slots][:, :2], gt_xy,
        )
        print(f"saved {p}")

    if args.stitch and config.map_stitcher.stitch_map:
        from nislam_torch.core.stitcher import make_canvas, occupancy_grid
        from nislam_torch.io.visualization import save_occupancy_png

        canvas = engine.recompute_canvas(make_canvas(config.map_stitcher, device), state.bank)
        p = save_occupancy_png(
            os.path.join(saving_root, "occupancy.png"), occupancy_grid(canvas).cpu().numpy()
        )
        print(f"saved {p}")
    return 0


def cmd_synth(args: argparse.Namespace) -> int:
    """Synthetic ground-texture dataset in the reference layout (rgb/ PNGs,
    image_names.txt, times.txt) plus groundtruth.txt and a config YAML."""
    from nislam_torch.io.synth_dataset import generate_synthetic_dataset

    cfg_path = generate_synthetic_dataset(
        args.out, n_frames=args.frames, height=args.height, width=args.width,
        seed=args.seed, path_kind=args.path, noise=args.noise,
    )
    print(f"wrote synthetic dataset to {args.out}; config: {cfg_path}")
    return 0


def cmd_pack(args: argparse.Namespace) -> int:
    from nislam_torch.io.dataset import open_dataset

    ds = open_dataset(args.dataroot, args.image_dir)
    out = ds.pack(args.out)
    print(f"packed {len(ds)} frames to {out}")
    return 0


def cmd_calibrate(args: argparse.Namespace) -> int:
    """PSR anchors measured on the dataset's own texture rescale the
    derived thresholds; prints a YAML snippet and margin diagnostics."""
    import torch

    from nislam_torch.core.calibrate import calibrate_thresholds
    from nislam_torch.core.config import load_config
    from nislam_torch.io.dataset import open_dataset

    config = load_config(args.config)
    dataroot = args.dataroot or config.dataset.dataroot
    dataset = open_dataset(dataroot, config.dataset.image_dir_name or "rgb")
    k = min(args.frames, len(dataset))
    probe = np.stack([dataset.get_raw(i)[0] for i in range(k)])
    thr, diag = calibrate_thresholds(config, probe, torch.device(args.device))
    print(f"# calibrated on {k} frames of {dataroot}")
    print(
        f"# texture ratio vs gaussian anchor: translation "
        f"{diag['texture_ratio_translation']}, rotation {diag['texture_ratio_rotation']}"
    )
    print(
        f"# margins: tracking q10/gate {diag['margin_tracking']}x, "
        f"rotation {diag['margin_rotation']}x; loop separation "
        f"pos {diag['separation_position']}x angle {diag['separation_angle']}x"
    )
    if diag["margin_tracking"] < 1.2 or diag["margin_rotation"] < 1.2:
        print("# WARNING: thin matched-PSR margin — this texture tracks marginally at these sizes")
    if diag.get("data_nomatch_suspect"):
        print(
            "# WARNING: the 'no-match' probe frames still correlate like "
            "matches — the camera moved less than a frame width over the "
            "probe window, so the separation diagnostics are not meaningful "
            "(the thresholds remain valid); probe more frames (--frames)"
        )
    print("keyframe_selection:")
    for kk in ("lower_response_thr", "upper_response_thr",
               "lower_rotation_response_thr", "upper_rotation_response_thr"):
        print(f"  {kk}: {thr[kk]}")
    print("loop_closure:")
    for kk in ("position_response_thr", "angle_response_thr"):
        print(f"  {kk}: {thr[kk]}")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """Evaluation through the models layer: one JSON line of frames/s, ATE
    and tracking (``vo``: odometry alone; ``slam``: the full system)."""
    import json

    import torch

    from nislam_torch.core.config import load_config
    from nislam_torch.io.dataset import open_dataset
    from nislam_torch.io.native_loader import NativeChunkReader
    from nislam_torch.io.trajectory import read_tum
    from nislam_torch.models import FullSlam, VisualOdometry

    device = torch.device(args.device)
    config = load_config(args.config)
    dataroot = args.dataroot or config.dataset.dataroot
    dataset = open_dataset(dataroot, config.dataset.image_dir_name or "rgb")
    n = len(dataset)
    if args.max_frames:
        n = min(n, args.max_frames)
    # Prefer the packed NISF file: u8 frames without image decoding.
    nisf = os.path.join(dataroot, "frames.nisf")
    if os.path.exists(nisf):
        reader = NativeChunkReader(nisf, chunk=max(64, n))
        pairs = list(iter(reader))
        reader.close()
        images = np.concatenate([p[0] for p in pairs])[:n]
        times = np.concatenate([p[1] for p in pairs])[:n]
    else:
        chunks, ts_list = [], []
        for chunk, ts in dataset.chunks(64, raw=True):
            chunks.append(chunk)
            ts_list.extend(ts.tolist())
            if sum(len(c) for c in chunks) >= n:
                break
        images = np.concatenate(chunks)[:n]
        times = np.asarray(ts_list[:n])
    gt_xy, gt_t = None, None
    if args.groundtruth:
        gt_t, gt_xy = read_tum(args.groundtruth)

    model = VisualOdometry(config, device) if args.model == "vo" else FullSlam(config, device)
    # A full identical warm-up run first, so the timed run meets no
    # first-call costs (kernel builds, cuFFT plans, allocator growth).
    model.evaluate(images, times=times, chunk_frames=args.chunk)
    res = model.evaluate(images, times=times, gt_xy=gt_xy, gt_times=gt_t, chunk_frames=args.chunk)
    rec = {
        "model": args.model,
        "frames": res.frames,
        "fps": round(res.fps, 1),
        "ate_rmse_m": None if res.ate_rmse_m is None else round(res.ate_rmse_m, 4),
        "tracked_frac": round(res.tracked_frac, 3),
        "keyframes": res.keyframes,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
    }
    if args.model == "slam":
        rec["loops"] = res.loops
        rec["solves"] = res.solves
    print(json.dumps(rec))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nislam_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="run SLAM over a dataset")
    _add_run_args(run_p)
    pack_p = sub.add_parser("pack", help="pack a dataset into one NISF file")
    pack_p.add_argument("--dataroot", required=True)
    pack_p.add_argument("--image-dir", default="rgb")
    pack_p.add_argument("--out", required=True)
    synth_p = sub.add_parser("synth", help="generate a synthetic dataset + config")
    synth_p.add_argument("--out", required=True)
    synth_p.add_argument("--frames", type=int, default=200)
    synth_p.add_argument("--height", type=int, default=480)
    synth_p.add_argument("--width", type=int, default=640)
    synth_p.add_argument("--seed", type=int, default=42)
    synth_p.add_argument(
        "--path", choices=["square", "loop", "straight"], default="square",
        help="square: integer-pixel steps (exact recovery); loop: rounded "
        "square with tangent heading (360 deg of yaw); straight",
    )
    synth_p.add_argument(
        "--noise", action="store_true",
        help="add sensor noise + illumination drift to the rendered frames",
    )
    cal_p = sub.add_parser(
        "calibrate",
        help="measure PSR anchors on the dataset's first K frames and print "
        "texture-rescaled thresholds as a YAML snippet",
    )
    cal_p.add_argument("--config", required=True)
    _add_device_arg(cal_p)
    cal_p.add_argument("--dataroot", default=None)
    cal_p.add_argument("--frames", type=int, default=32)
    eval_p = sub.add_parser("eval", help="model evaluation (fps + ATE JSON line)")
    eval_p.add_argument("--config", required=True)
    _add_device_arg(eval_p)
    eval_p.add_argument("--dataroot", default=None)
    eval_p.add_argument("--model", choices=["vo", "slam"], default="slam")
    eval_p.add_argument("--groundtruth", default=None)
    eval_p.add_argument("--max-frames", type=int, default=0)
    eval_p.add_argument("--chunk", type=int, default=64)
    args = parser.parse_args(argv)
    commands = {
        "run": cmd_run, "pack": cmd_pack, "synth": cmd_synth,
        "calibrate": cmd_calibrate, "eval": cmd_eval,
    }
    return commands[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
