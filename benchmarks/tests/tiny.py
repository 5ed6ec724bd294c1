"""A checkout of its own for the harness's CPU tests: ``BENCHMARK.json`` with
one cell at a size the CPU runs in seconds (120x160 frames, a 180x96
polar grid, the port's bench ``--quick`` sizes), its configuration, mix
and check files, and a copy of the metric readers."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLAM = {
    "cf": {"width": 160, "height": 120, "lambda_": 0.1, "kernel": 0, "sigma": 0.2, "offset": 0.1, "power": 3,
           "rotation_divisor": 180, "rotation_channel": 96, "rotate_method": "fft", "half_polar": True},
    "keyframe_selection": {"max_distance": 0.1875, "max_angle": 0.052359877, "lower_response_thr": 7.5,
                           "upper_response_thr": 22.5, "lower_rotation_response_thr": 6.71,
                           "upper_rotation_response_thr": 20.12},
    "map": {"grid_scale": 0.225, "keyframe_capacity": 256, "edge_capacity": 256, "store_images": False,
            "eviction": "ring", "cache_filters": True, "bank_dtype": "bf16"},
    "loop_closure": {"to_find_loop": True, "position_response_thr": 15.0, "angle_response_thr": 13.42,
                     "frame_gap_thr": 30, "distance_thr": 0.3, "max_candidates": 8, "pending_capacity": 32,
                     "coarse_scale": 1},
    "map_stitcher": {"stitch_map": True, "cell_size": 1000, "canvas_size": 2048, "online": False},
    "optimizer": {"max_iterations": 100, "with_scale": False, "inline": False},
    "camera": {"image_width": 160, "image_height": 120, "height": 1.0, "accurate_height": True,
               "intrinsics": [160.0, 80.0, 160.0, 60.0], "distortion": [0.0] * 5,
               "extrinsics": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]},
}

MIX = {"name": "tiny", "model": "slam", "frames_per_sequence": 128, "world_seeds": [11, 12], "chunk": 32,
       "world": 1024, "texture_sigma": 3.0, "step_px": 3.0, "noise_sigma": 0.01, "illum_drift": 0.1,
       "why": "test"}

LIMITS = {"mismatched_decisions": 0, "pose_gap_px": 0.05, "heading_gap_deg": 0.05}


def make_root(tmp: str, *, model: str = "slam", slam: dict = SLAM, mix: dict = MIX, limits: dict = LIMITS,
              coarse: int = 1) -> str:
    """A checkout at ``tmp`` whose BENCHMARK.json holds the cell ``tiny``."""
    bench = json.load(open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")))
    slam = json.loads(json.dumps(slam))
    slam["loop_closure"]["coarse_scale"] = coarse
    mix = dict(mix, model=model)
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(tmp, "benchmarks", sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(tmp, "benchmarks", "metrics"), dirs_exist_ok=True)
    with open(os.path.join(tmp, "benchmarks", "configs", "tiny.json"), "w") as f:
        json.dump({"name": "tiny", "slam": slam}, f)
    with open(os.path.join(tmp, "benchmarks", "traffic", "tiny.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(tmp, "benchmarks", "checks", "tiny.json"), "w") as f:
        json.dump({"cell": "tiny", "limits": limits}, f)
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "benchmarks/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
