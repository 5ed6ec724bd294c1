"""Synthetic dataset generator (reference on-disk layout + config YAML).

Copy of ``nislam_tpu.io.synth_dataset`` on the port's numpy generators (a
test holds the written files equal): ``rgb/*.png`` + ``image_names.txt`` +
``times.txt``, a TUM ``groundtruth.txt``, a camera YAML and a main config
YAML with thresholds sized to the image, so ``python -m nislam_torch run``
works with no external data.
"""

from __future__ import annotations

import os

import numpy as np

from nislam_torch.core.config import derive_response_thresholds
from nislam_torch.io.trajectory import write_tum
from nislam_torch.utils.synthetic import (
    add_sensor_noise,
    heading_loop_path,
    make_world,
    render_sequence,
    square_loop_path,
    straight_path,
)


def synthetic_sizing(
    width: int, height: int, rotation_divisor: int, rotation_channel: int,
    n_frames: int, step_px: float, px_scale: float,
) -> dict:
    """The thresholds and distances that depend on the synthetic texture
    and path: the six PSR thresholds (:func:`derive_response_thresholds`),
    ``max_distance`` (two steps), ``grid_scale`` and ``distance_thr``
    (eight keyframe distances), all metric."""
    thr = derive_response_thresholds(width, height, rotation_divisor, rotation_channel)
    max_distance = 2.0 * step_px * px_scale
    # Spatial-hash cell: at least 0.3·H px, and at least 2 % of the path
    # length, so the drift accumulated before a long loop closes still
    # lands the prior pose in the 3×3 neighbourhood of the revisited
    # keyframes.
    path_len = n_frames * step_px * px_scale
    grid_scale = max(0.3 * height * px_scale, 0.02 * path_len)
    return {**thr, "max_distance": max_distance, "grid_scale": grid_scale,
            "distance_thr": 8 * max_distance}


def generate_synthetic_dataset(
    out_dir: str,
    *,
    n_frames: int = 200,
    height: int = 480,
    width: int = 640,
    seed: int = 42,
    path_kind: str = "square",
    noise: bool = False,
    rate_hz: float = 30.0,
) -> str:
    """Write the dataset; returns the path of the generated config YAML.

    ``path_kind``: ``square`` (axis-aligned, integer-pixel steps — KCC
    recovery is exact, ATE ≈ 0), ``loop`` (rounded square with the heading
    tangent to motion: 360° of yaw over the loop, exercising the rotation
    branch), ``straight``.  ``noise`` adds per-pixel Gaussian noise and
    slow illumination drift (utils.synthetic.add_sensor_noise).
    """
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    world_n = 1 << int(np.ceil(np.log2(4 * max(height, width))))
    world = make_world(world_n, sigma=3.0, seed=seed)

    fx = fy = float(width)
    cam_height = 1.0
    px_scale = cam_height / fx  # metric size of one pixel

    step_px = width / 16.0
    start = (world_n / 2.0, world_n / 2.0)
    if path_kind == "square":
        side = max(4, (n_frames - 8) // 4)
        poses = square_loop_path(side, step=step_px, start=start, tail=8)[:n_frames]
    elif path_kind == "loop":
        poses = heading_loop_path(n_frames, step=step_px, start=start)
    else:
        poses = straight_path(n_frames, step=step_px, start=start)

    frames = render_sequence(world, height, width, poses)
    if noise:
        frames = add_sensor_noise(frames, seed=seed + 1)
    u8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)

    try:
        import cv2

        def imwrite(path, img):
            cv2.imwrite(path, img)
    except ImportError:
        from PIL import Image

        def imwrite(path, img):
            Image.fromarray(img).save(path)

    names = []
    for i in range(len(u8)):
        name = f"{i:06d}.png"
        imwrite(os.path.join(out_dir, "rgb", name), u8[i])
        names.append(name)
    with open(os.path.join(out_dir, "image_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    times = np.arange(len(u8)) / rate_hz
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6f}" for t in times) + "\n")

    # Ground truth in the robot frame: world px offset × pixel scale.
    gt = np.array(
        [((p[0] - start[0]) * px_scale, (p[1] - start[1]) * px_scale, p[2]) for p in poses]
    )
    write_tum(os.path.join(out_dir, "groundtruth.txt"), times, gt)

    cam_yaml = os.path.join(out_dir, "camera.yaml")
    with open(cam_yaml, "w") as f:
        f.write(
            f"""image_size: [{width}, {height}]
height: {cam_height}
accurate_height: true
intrinsics:
  data: [{fx}, {width / 2.0}, {fy}, {height / 2.0}]
distortion:
  data: [0.0, 0.0, 0.0, 0.0, 0.0]
extrinsics:
  data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
"""
        )

    rotation_divisor = 360
    rotation_channel = max(96, height // 2)
    sz = synthetic_sizing(
        width, height, rotation_divisor, rotation_channel, n_frames, step_px, px_scale
    )
    thr, max_distance, grid_scale = sz, sz["max_distance"], sz["grid_scale"]
    # Stitcher canvas sized and centred to the trajectory: its extent in
    # image-plane pixels plus one frame of margin, centred on the path.
    xs = [p[0] - start[0] for p in poses]
    ys = [p[1] - start[1] for p in poses]
    extent_px = max(max(xs) - min(xs), max(ys) - min(ys))
    canvas_size = int(-(-(extent_px + 2.0 * max(height, width)) // 1024) * 1024)
    canvas_cx = int(round((max(xs) + min(xs)) / 2.0))
    canvas_cy = int(round((max(ys) + min(ys)) / 2.0))
    cfg_yaml = os.path.join(out_dir, "config.yaml")
    with open(cfg_yaml, "w") as f:
        f.write(
            f"""dataset:
  dataroot: {os.path.abspath(out_dir)}
  image_dir_name: rgb
  camera_config: {os.path.abspath(cam_yaml)}

correlation_flow:
  width: {width}
  height: {height}
  lambda: 0.1
  kernel: 0
  gaussian:
    sigma: 0.2
  polynomial:
    offset: 0.1
    power: 3
  rotation_divisor: {rotation_divisor}
  rotation_channel: {rotation_channel}

keyframe_selection:
  max_distance: {max_distance:.6f}
  max_angle: 0.052359877
  lower_response_thr: {thr['lower_response_thr']}
  upper_response_thr: {thr['upper_response_thr']}
  lower_rotation_response_thr: {thr['lower_rotation_response_thr']}
  upper_rotation_response_thr: {thr['upper_rotation_response_thr']}

map:
  grid_scale: {grid_scale:.6f}
  keyframe_capacity: 512
  edge_capacity: 2048

loop_closure:
  to_find_loop: true
  position_response_thr: {thr['position_response_thr']}
  angle_response_thr: {thr['angle_response_thr']}
  frame_gap_thr: 30
  distance_thr: {sz['distance_thr']:.6f}
  max_candidates: 8

map_sticther:
  stitch_map: true
  cell_size: 1000
  canvas_size: {canvas_size}
  canvas_center: [{canvas_cx}, {canvas_cy}]

saving:
  save_pose: true
  saving_root: {os.path.abspath(os.path.join(out_dir, 'saving'))}
"""
        )
    return cfg_yaml
