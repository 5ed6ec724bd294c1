"""SE(2) pose algebra on ``(..., 3)`` tensors ``(x, y, θ)``, float32.

Counterpart of ``nislam_tpu.core.se2``.
"""

from __future__ import annotations

import math

import torch


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Normalize radians into [-π, π)."""
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor((theta + math.pi) / two_pi)


def rotation2d(theta: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) rotation matrix R(θ)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def relative_pose(pose1: torch.Tensor, pose2: torch.Tensor) -> torch.Tensor:
    """Pose of 2 expressed in frame 1: ``(R1ᵀ(p2−p1), normalize(θ2−θ1))``."""
    r1 = rotation2d(pose1[..., 2])
    dp = pose2[..., :2] - pose1[..., :2]
    xy = torch.einsum("...ji,...j->...i", r1, dp)
    th = normalize_angle(pose2[..., 2] - pose1[..., 2])
    return torch.cat([xy, th[..., None]], dim=-1)


def absolute_pose(pose1: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """World pose of ``rel`` given in frame ``pose1``."""
    r1 = rotation2d(pose1[..., 2])
    xy = pose1[..., :2] + torch.einsum("...ij,...j->...i", r1, rel[..., :2])
    th = normalize_angle(pose1[..., 2] + rel[..., 2])
    return torch.cat([xy, th[..., None]], dim=-1)
