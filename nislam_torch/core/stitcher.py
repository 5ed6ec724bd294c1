"""Occupancy-mosaic map stitcher: scatter-add rasterization on the device.

Counterpart of ``nislam_tpu.core.stitcher``.  The map is a bounded dense
canvas of running sums — ``data`` (Σ intensity on a 0…100 scale) and
``weight`` (Σ hits) — centred on an image-plane pixel.  Inserting a frame
maps every pixel (j, i) through the frame's pose to
``trunc(R(θ)·(i − W/2, j − H/2) + t)`` and adds it in pixel order
(:func:`~nislam_torch.ops.stitch_raster.stitch_raster`: on the card one
launch of a hand-written kernel per frame, with no sort), which
accumulates repeated cells (several pixels landing in one cell) as a
flat ``index_add_`` does, so a canvas on the card repeats bit for bit.
Pixels outside the canvas add zero value and weight.  ``sign=-1`` subtracts a frame (ring eviction
retiring a keyframe from an online canvas).

As in :mod:`nislam_torch.core.map_store`, :func:`insert_frame` updates the
canvas in place and returns it.
"""

from __future__ import annotations

import dataclasses

import torch

from nislam_torch.core.camera import CameraOps
from nislam_torch.core.se2 import rotation2d
from nislam_torch.ops.stitch_raster import frame_cells, image_targets, stitch_raster

# Keyframes rasterized per call in :func:`recompute`.
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


def _frame_constants(pose_robot: torch.Tensor, camera: CameraOps) -> torch.Tensor:
    """(..., 6) f32 ``(r00, r01, r10, r11, px, py)``: the rotation and
    translation of the image-plane pose of frames at ``pose_robot`` (..., 3)."""
    image_pose = camera.principal_to_center(camera.robot_to_image_plane(pose_robot))
    r = rotation2d(image_pose[..., 2])
    return torch.cat([r.flatten(-2), image_pose[..., :2]], dim=-1)


def _frame_targets(image_hw, pose_robot: torch.Tensor, camera: CameraOps):
    """Integer image-plane coordinates (x, y), each (..., H, W), of every
    pixel of frames at ``pose_robot`` (..., 3), truncated toward zero."""
    return image_targets(_frame_constants(pose_robot, camera), image_hw)


def flat_targets(canvas: StitchCanvas, image_hw, poses, camera: CameraOps, enabled):
    """Flat canvas cells (..., H, W) i64 of every pixel of frames at
    ``poses`` (..., 3), and the mask (..., H, W) of those that land on the
    canvas in an enabled frame (``enabled`` broadcast to the leading axes);
    a masked pixel points at cell 0
    (:func:`~nislam_torch.ops.stitch_raster.frame_cells`)."""
    return frame_cells(_frame_constants(poses, camera), image_hw, canvas.size,
                       (canvas.center_x, canvas.center_y), enabled)


def _scatter(canvas: StitchCanvas, images, poses, camera: CameraOps, enabled, sign: float):
    """Add ``sign`` × frames (..., H, W) at ``poses`` (..., 3) in place;
    ``enabled`` (broadcast to the leading axes) masks whole frames."""
    stitch_raster(canvas.data, canvas.weight, images, _frame_constants(poses, camera), enabled,
                  sign * 100.0, sign, (canvas.center_x, canvas.center_y))
    return canvas


def insert_frame(
    canvas: StitchCanvas, image: torch.Tensor, pose_robot: torch.Tensor,
    camera: CameraOps, *, enabled=True, sign: float = 1.0,
) -> StitchCanvas:
    """Rasterize one (H, W) frame (f32 in [0, 1]) into the canvas, in place.
    ``enabled`` (bool or device bool) masks the write without a host sync."""
    return _scatter(canvas, image, pose_robot, camera, enabled, sign)


def recompute(canvas: StitchCanvas, bank, camera: CameraOps, enabled=None) -> StitchCanvas:
    """Zero the canvas, then rasterize every live keyframe of ``bank`` at
    its current pose (after a pose-graph solve), with no host read: every
    slot of the bank, ``_RECOMPUTE_BATCH`` per scatter, each masked by
    ``slot < count`` on the device, as JAX's masked ``fori_loop`` over
    the whole bank.  A masked frame adds nothing (the kernel skips it; its
    plain version adds +0 to a cell that is never −0), so the canvas is
    :func:`recompute_reference`'s bit for bit.  ``enabled`` (a () bool
    device flag, None: true): when false the canvas keeps its bits, which
    the solve graph's finish uses for a lane that did not solve."""
    _check_images(bank)
    if enabled is None:
        canvas.data.zero_()
        canvas.weight.zero_()
    else:
        canvas.data.masked_fill_(enabled, 0.0)
        canvas.weight.masked_fill_(enabled, 0.0)
    k = bank.images.shape[0]
    live = torch.arange(k, device=bank.count.device) < bank.count
    if enabled is not None:
        live = live & enabled
    for start in range(0, k, _RECOMPUTE_BATCH):
        sl = slice(start, min(start + _RECOMPUTE_BATCH, k))
        _scatter(canvas, bank.images[sl], bank.poses[sl], camera, live[sl], 1.0)
    return canvas


def recompute_reference(canvas: StitchCanvas, bank, camera: CameraOps) -> StitchCanvas:
    """:func:`recompute` as a loop over the live slots only, which reads the
    bank's count once on the host: the plain version that the masked
    recompute is held against."""
    _check_images(bank)
    canvas.data.zero_()
    canvas.weight.zero_()
    n = int(bank.count)
    for start in range(0, n, _RECOMPUTE_BATCH):
        sl = slice(start, min(start + _RECOMPUTE_BATCH, n))
        _scatter(canvas, bank.images[sl], bank.poses[sl], camera, True, 1.0)
    return canvas


def _check_images(bank) -> None:
    if bank.images.shape[1] == 0:
        raise ValueError(
            "keyframe bank stores no images (MapConfig.store_images=False); "
            "the stitcher needs raw frames to rasterize"
        )


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
