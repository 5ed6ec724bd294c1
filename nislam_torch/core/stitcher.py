"""Occupancy-mosaic map stitcher: scatter-add rasterization on the device.

Counterpart of ``nislam_tpu.core.stitcher``.  The map is a bounded dense
canvas of running sums — ``data`` (Σ intensity on a 0…100 scale) and
``weight`` (Σ hits) — centred on an image-plane pixel.  Inserting a frame
maps every pixel (j, i) through the frame's pose to
``trunc(R(θ)·(i − W/2, j − H/2) + t)`` and adds it with one flat
fixed-order scatter (:func:`~nislam_torch.ops.scatter_add.index_add_ordered`:
one sort of the targets, then ``data`` and ``weight``), which accumulates
repeated indices (several pixels landing in one cell) in pixel order, so
a canvas on the card repeats bit for bit.  Pixels outside the canvas add
zero value and weight.  ``sign=-1`` subtracts a frame (ring eviction
retiring a keyframe from an online canvas).

As in :mod:`nislam_torch.core.map_store`, :func:`insert_frame` updates the
canvas in place and returns it.
"""

from __future__ import annotations

import dataclasses

import torch

from nislam_torch.core.camera import CameraOps
from nislam_torch.core.se2 import rotation2d
from nislam_torch.ops.scatter_add import ScatterPlan, index_add_ordered, spread_masked

# Keyframes rasterized per scatter in :func:`recompute`.
_RECOMPUTE_BATCH = 16


@dataclasses.dataclass
class StitchCanvas:
    """Canvas pixel (row, col) covers image-plane pixel
    ``(center_x + col − S/2, center_y + row − S/2)``."""

    data: torch.Tensor  # (S, S) f32 Σ intensity (0..100)
    weight: torch.Tensor  # (S, S) f32 Σ hits
    center_x: int = 0
    center_y: int = 0

    @property
    def size(self) -> int:
        return self.data.shape[0]


def make_canvas(cfg, device: torch.device) -> StitchCanvas:
    """Empty canvas for a ``MapStitcherConfig``."""
    s = cfg.canvas_size
    cx, cy = cfg.canvas_center
    zeros = lambda: torch.zeros((s, s), dtype=torch.float32, device=device)
    return StitchCanvas(data=zeros(), weight=zeros(), center_x=int(cx), center_y=int(cy))


def _frame_targets(image_hw, pose_robot: torch.Tensor, camera: CameraOps):
    """Integer image-plane coordinates (x, y), each (..., H, W), of every
    pixel of frames at ``pose_robot`` (..., 3), truncated toward zero."""
    h, w = image_hw
    image_pose = camera.principal_to_center(camera.robot_to_image_plane(pose_robot))
    r = rotation2d(image_pose[..., 2])[..., None, None, :, :]  # (..., 1, 1, 2, 2)
    dev = pose_robot.device
    iw = torch.arange(w, dtype=torch.float32, device=dev) - w / 2.0
    ih = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - h / 2.0
    x = r[..., 0, 0] * iw + r[..., 0, 1] * ih + image_pose[..., 0, None, None]
    y = r[..., 1, 0] * iw + r[..., 1, 1] * ih + image_pose[..., 1, None, None]
    return torch.trunc(x).to(torch.int32), torch.trunc(y).to(torch.int32)


def flat_targets(canvas: StitchCanvas, image_hw, poses, camera: CameraOps, enabled):
    """Flat canvas cells (..., H, W) i64 of every pixel of frames at
    ``poses`` (..., 3), and the mask (..., H, W) of those that land on the
    canvas in an enabled frame (``enabled`` broadcast to the leading axes).
    A masked pixel adds exact zeros, so it points at a cell of its own
    (:func:`~nislam_torch.ops.scatter_add.spread_masked`), not at one
    shared cell: a disabled frame would make a run of H·W keys."""
    xi, yi = _frame_targets(image_hw, poses, camera)
    s = canvas.size
    col = xi - canvas.center_x + s // 2
    row = yi - canvas.center_y + s // 2
    inb = (col >= 0) & (col < s) & (row >= 0) & (row < s)
    en = torch.as_tensor(enabled, dtype=torch.bool, device=poses.device)
    ok = inb & en.reshape(en.shape + (1, 1))
    return spread_masked(row * s + col, ok, s * s), ok


def _scatter(canvas: StitchCanvas, images, poses, camera: CameraOps, enabled, sign: float):
    """Add ``sign`` × frames (..., H, W) at ``poses`` (..., 3) in place;
    ``enabled`` (broadcast to the leading axes) masks whole frames."""
    idx, ok = flat_targets(canvas, images.shape[-2:], poses, camera, enabled)
    plan = ScatterPlan.of(idx)
    index_add_ordered(canvas.data.view(-1), plan, torch.where(ok, images * (sign * 100.0), 0.0).reshape(-1))
    index_add_ordered(canvas.weight.view(-1), plan, sign * ok.to(torch.float32).reshape(-1))
    return canvas


def insert_frame(
    canvas: StitchCanvas, image: torch.Tensor, pose_robot: torch.Tensor,
    camera: CameraOps, *, enabled=True, sign: float = 1.0,
) -> StitchCanvas:
    """Rasterize one (H, W) frame (f32 in [0, 1]) into the canvas, in place.
    ``enabled`` (bool or device bool) masks the write without a host sync."""
    return _scatter(canvas, image, pose_robot, camera, enabled, sign)


def recompute(canvas: StitchCanvas, bank, camera: CameraOps) -> StitchCanvas:
    """Zero the canvas, then rasterize every live keyframe of ``bank`` at
    its current pose (after a pose-graph solve).  Reads the bank's count
    once; rasterizes ``_RECOMPUTE_BATCH`` keyframes per scatter."""
    if bank.images.shape[1] == 0:
        raise ValueError(
            "keyframe bank stores no images (MapConfig.store_images=False); "
            "the stitcher needs raw frames to rasterize"
        )
    canvas.data.zero_()
    canvas.weight.zero_()
    n = int(bank.count)
    for start in range(0, n, _RECOMPUTE_BATCH):
        sl = slice(start, min(start + _RECOMPUTE_BATCH, n))
        _scatter(canvas, bank.images[sl], bank.poses[sl], camera, True, 1.0)
    return canvas


def occupancy_grid(canvas: StitchCanvas) -> torch.Tensor:
    """(S, S) int8 occupancy: ``100 − mean intensity``, −1 where unseen."""
    seen = canvas.weight >= 1.0
    mean = canvas.data / torch.clamp(canvas.weight, min=1.0)
    val = torch.clamp(100.0 - mean, 0.0, 100.0)
    return torch.where(seen, val, -1.0).to(torch.int8)


def occupancy_origin(camera: CameraOps, canvas: StitchCanvas) -> torch.Tensor:
    """Metric (x, y) of canvas pixel (0, 0)."""
    half = canvas.size // 2
    corner = torch.tensor(
        [canvas.center_x - half, canvas.center_y - half, 0.0],
        dtype=torch.float32, device=camera.new_k.device,
    )
    return camera.image_plane_to_robot(corner)[:2]


def map_resolution(camera: CameraOps) -> torch.Tensor:
    """Metric size of one canvas pixel."""
    return camera.length_of_pixel()
