"""Camera model: undistortion and the 2D pose frame conversions.

Counterpart of ``nislam_tpu.core.camera``.  The undistortion remap is
computed once on the host — with OpenCV when it is installed, else with the
numpy fallback, exactly as the JAX package chooses — and applied on the
device as one bilinear gather.

Pose frames: image plane ``(u, v, θ)`` pixels; camera ``(u/fx, v/fy, θ)``;
robot ``extrinsics @ (h·x, h·y, θ)`` with camera height h.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from nislam_torch.core.se2 import rotation2d
from nislam_torch.ops.warp import bilinear_sample


def _undistort_maps_numpy(cfg) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy version of cv2.getOptimalNewCameraMatrix(α=0) +
    initUndistortRectifyMap."""
    fx, cx, fy, cy = cfg.intrinsics
    k1, k2, p1, p2, k3 = cfg.distortion
    w, h = cfg.image_width, cfg.image_height

    def distort(xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([fx * xd + cx, fy * yd + cy], axis=-1)

    if not any(cfg.distortion):
        new_k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    else:
        # Undistort a border grid (fixed-point inverse), then fit the
        # largest all-valid rectangle — the α=0 policy.
        n = 32
        us = np.linspace(0, w - 1, n)
        vs = np.linspace(0, h - 1, n)
        border = np.concatenate(
            [
                np.stack([us, np.zeros(n)], -1),
                np.stack([us, np.full(n, h - 1.0)], -1),
                np.stack([np.zeros(n), vs], -1),
                np.stack([np.full(n, w - 1.0), vs], -1),
            ]
        )
        xy = (border - np.array([cx, cy])) / np.array([fx, fy])
        und = xy.copy()
        for _ in range(20):
            d = (distort(und) - np.array([cx, cy])) / np.array([fx, fy])
            und = und + (xy - d)
        u0 = und[2 * n : 3 * n, 0].max()
        u1 = und[3 * n :, 0].min()
        v0 = und[:n, 1].max()
        v1 = und[n : 2 * n, 1].min()
        nfx = (w - 1) / max(u1 - u0, 1e-9)
        nfy = (h - 1) / max(v1 - v0, 1e-9)
        new_k = np.array([[nfx, 0, -nfx * u0], [0, nfy, -nfy * v0], [0, 0, 1.0]])

    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (uu - new_k[0, 2]) / new_k[0, 0]
    y = (vv - new_k[1, 2]) / new_k[1, 1]
    src = distort(np.stack([x, y], axis=-1))
    return src[..., 0].astype(np.float32), src[..., 1].astype(np.float32), new_k


def _undistort_maps(cfg) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(map_x, map_y, new_k): OpenCV when installed, else numpy."""
    try:
        import cv2
    except ImportError:
        return _undistort_maps_numpy(cfg)
    fx, cx, fy, cy = cfg.intrinsics
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    d = np.asarray(cfg.distortion, np.float64)
    size = (cfg.image_width, cfg.image_height)
    new_k, _ = cv2.getOptimalNewCameraMatrix(k, d, size, 0, size)
    m1, m2 = cv2.initUndistortRectifyMap(k, d, None, new_k, size, cv2.CV_32FC1)
    return m1, m2, new_k


class CameraOps(nn.Module):
    """Remap grid and frame-conversion constants as buffers."""

    def __init__(self, cfg, identity_remap: bool, map_x, map_y, new_k, extrinsics):
        super().__init__()
        self.cfg = cfg
        self.identity_remap = identity_remap
        ext = np.asarray(extrinsics, np.float32)
        self.register_buffer("map_x", torch.as_tensor(map_x, dtype=torch.float32))  # (H, W)
        self.register_buffer("map_y", torch.as_tensor(map_y, dtype=torch.float32))
        self.register_buffer("new_k", torch.as_tensor(new_k, dtype=torch.float32))  # (3, 3)
        self.register_buffer("extrinsics", torch.as_tensor(ext))
        self.register_buffer("extrinsics_inv", torch.as_tensor(np.linalg.inv(ext)))

    @property
    def fx(self) -> torch.Tensor:
        return self.new_k[0, 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.new_k[1, 1]

    def undistort(self, image: torch.Tensor) -> torch.Tensor:
        """``Camera::UndistortImage`` as a bilinear gather (skipped for a
        distortion-free camera)."""
        if self.identity_remap:
            return image
        return bilinear_sample(image, self.map_x, self.map_y)

    def image_plane_to_camera(self, pose: torch.Tensor) -> torch.Tensor:
        return torch.stack([pose[..., 0] / self.fx, pose[..., 1] / self.fy, pose[..., 2]], dim=-1)

    def camera_to_image_plane(self, pose: torch.Tensor) -> torch.Tensor:
        return torch.stack([pose[..., 0] * self.fx, pose[..., 1] * self.fy, pose[..., 2]], dim=-1)

    def camera_to_robot(self, pose: torch.Tensor) -> torch.Tensor:
        h = self.cfg.height
        v = torch.stack([h * pose[..., 0], h * pose[..., 1], pose[..., 2]], dim=-1)
        return torch.einsum("ij,...j->...i", self.extrinsics, v)

    def robot_to_camera(self, pose: torch.Tensor) -> torch.Tensor:
        h = self.cfg.height
        v = torch.einsum("ij,...j->...i", self.extrinsics_inv, pose)
        return torch.stack([v[..., 0] / h, v[..., 1] / h, v[..., 2]], dim=-1)

    def image_plane_to_robot(self, pose: torch.Tensor) -> torch.Tensor:
        return self.camera_to_robot(self.image_plane_to_camera(pose))

    def robot_to_image_plane(self, pose: torch.Tensor) -> torch.Tensor:
        return self.camera_to_image_plane(self.robot_to_camera(pose))

    def _o_bias(self) -> torch.Tensor:
        """(W/2 − cx', H/2 − cy')."""
        return torch.stack(
            [self.cfg.image_width * 0.5 - self.new_k[0, 2],
             self.cfg.image_height * 0.5 - self.new_k[1, 2]]
        )

    def _center_correction(self, th: torch.Tensor) -> torch.Tensor:
        bias = self._o_bias()
        return bias - torch.einsum("...ij,j->...i", rotation2d(th), bias)

    def center_to_principal(self, pose: torch.Tensor) -> torch.Tensor:
        """Correlation shifts are about the image center; pose chains are
        about the principal point."""
        th = pose[..., 2]
        return torch.cat([pose[..., :2] + self._center_correction(th), th[..., None]], dim=-1)

    def principal_to_center(self, pose: torch.Tensor) -> torch.Tensor:
        th = pose[..., 2]
        return torch.cat([pose[..., :2] - self._center_correction(th), th[..., None]], dim=-1)

    def length_of_pixel(self) -> torch.Tensor:
        """Metric size of one pixel."""
        one = torch.tensor([1.0, 1.0, 0.0], device=self.new_k.device)
        real = self.image_plane_to_robot(one)
        return (real[0] + real[1]) / 2.0


def make_camera_ops(cfg) -> CameraOps:
    """Camera tables for ``cfg`` (a ``CameraConfig``) on the CPU."""
    identity = not any(cfg.distortion)
    if identity:
        fx, cx, fy, cy = cfg.intrinsics
        new_k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float32)
        map_x, map_y = np.meshgrid(
            np.arange(cfg.image_width, dtype=np.float32),
            np.arange(cfg.image_height, dtype=np.float32),
        )
    else:
        map_x, map_y, new_k = _undistort_maps(cfg)
    ext = np.asarray(cfg.extrinsics, np.float32).reshape(3, 3)
    return CameraOps(cfg, identity, map_x, map_y, np.asarray(new_k, np.float32), ext)
