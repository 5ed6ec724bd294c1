"""Synthetic ground-texture worlds and downward-camera sequences (numpy).

Copies of the generators in ``nislam_tpu.utils.synthetic`` that the
flagship workload, the synthetic dataset writer and the calibration anchor
use (a test holds their outputs equal), so the port and its smoke run need
nothing from the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def make_world(n: int = 1024, sigma: float = 3.0, seed: int = 42, family: str = "gaussian") -> np.ndarray:
    """Periodic random ground texture in [0, 1]; ``family`` picks its
    statistics, as in the JAX package's generator: ``gaussian``
    (Gaussian-blurred white noise), ``powerlaw`` (1/f^σ spectral slope),
    ``blobs`` (soft-thresholded blurred noise) or ``fibrous`` (blurred σ
    along x, σ/6 along y)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, n)).astype(np.float32)
    f = np.fft.rfft2(w)
    if family == "powerlaw":
        ky = np.fft.fftfreq(n)[:, None]
        kx = np.fft.rfftfreq(n)[None, :]
        kk = np.sqrt(ky * ky + kx * kx)
        kk[0, 0] = kk[0, 1]
        w = np.fft.irfft2(f * (kk ** -sigma), s=(n, n)).astype(np.float32)
    elif family in ("gaussian", "blobs", "fibrous"):
        sx = sigma
        sy = sigma / 6.0 if family == "fibrous" else sigma
        if family == "blobs":
            sx = sy = 2.5 * sigma  # larger patches before thresholding

        def blur_kernel(s):
            r = max(1, int(3 * s))
            k = np.exp(-0.5 * (np.arange(-r, r + 1) / s) ** 2).astype(np.float32)
            k /= k.sum()
            return np.roll(np.pad(k, (0, n - k.size)), -r)

        kx = np.fft.rfft(blur_kernel(sx))
        ky = np.fft.fft(blur_kernel(sy))
        w = np.fft.irfft2(f * ky[:, None] * kx[None, :], s=(n, n)).astype(np.float32)
        if family == "blobs":
            w = np.tanh(w / (np.std(w) + 1e-12) * 3.0).astype(np.float32)
    else:
        raise ValueError(f"unknown texture family {family!r}")
    w -= w.min()
    w /= w.max() + 1e-12
    return w


def render_frame(world: np.ndarray, h: int, w: int, px: float, py: float, theta: float) -> np.ndarray:
    """(h, w) view at world-pixel pose (px, py, theta): bilinear sampling of
    the periodic world."""
    wh, ww = world.shape
    xs = np.arange(w, dtype=np.float64) - w / 2.0
    ys = np.arange(h, dtype=np.float64) - h / 2.0
    xg, yg = np.meshgrid(xs, ys)
    c, s = math.cos(theta), math.sin(theta)
    wx = px + c * xg - s * yg
    wy = py + s * xg + c * yg
    x0 = np.floor(wx).astype(np.int64)
    y0 = np.floor(wy).astype(np.int64)
    fx = (wx - x0).astype(np.float32)
    fy = (wy - y0).astype(np.float32)
    x0 %= ww
    y0 %= wh
    x1 = (x0 + 1) % ww
    y1 = (y0 + 1) % wh
    top = world[y0, x0] * (1 - fx) + world[y0, x1] * fx
    bot = world[y1, x0] * (1 - fx) + world[y1, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def render_sequence(world: np.ndarray, h: int, w: int, poses: Sequence[Tuple[float, float, float]]) -> np.ndarray:
    world = np.asarray(world)
    return np.stack([render_frame(world, h, w, *p) for p in poses])


def square_loop_path(
    side_steps: int = 25, step: float = 6.0, start: Tuple[float, float] = (512.0, 512.0),
    tail: int = 4, yaw_rate: float = 0.0,
) -> List[Tuple[float, float, float]]:
    """Axis-aligned square loop back to the start, then a tail continuing
    in the last side's direction, away from every visited cell."""
    poses = [(start[0], start[1], 0.0)]
    x, y, th = poses[0]
    for dx, dy in [(1, 0), (0, 1), (-1, 0), (0, -1)]:
        for _ in range(side_steps):
            x += dx * step
            y += dy * step
            th += yaw_rate
            poses.append((x, y, th))
    for _ in range(tail):
        y -= step
        poses.append((x, y, th))
    return poses


def straight_path(
    n: int, step: float = 6.0, start: Tuple[float, float] = (512.0, 512.0)
) -> List[Tuple[float, float, float]]:
    return [(start[0] + i * step, start[1], 0.0) for i in range(n)]


def heading_loop_path(
    n_frames: int, step: float = 6.0, start: Tuple[float, float] = (512.0, 512.0),
    tail: int = 8, turn_steps: int = 8,
) -> List[Tuple[float, float, float]]:
    """Rounded-square loop with the heading tangent to the motion (a full
    360° of yaw), then a straight tail; exactly ``n_frames`` poses."""
    body = n_frames - tail - 1
    side = max(2, -(-(body - 4 * turn_steps) // 4))
    x, y, th = float(start[0]), float(start[1]), 0.0
    poses = [(x, y, th)]
    dth = (math.pi / 2.0) / turn_steps
    for _ in range(4):
        for _ in range(side):
            x += step * math.cos(th)
            y += step * math.sin(th)
            poses.append((x, y, th))
        for _ in range(turn_steps):
            th += dth
            x += step * math.cos(th)
            y += step * math.sin(th)
            poses.append((x, y, th))
    th = th % (2.0 * math.pi)
    while len(poses) < n_frames:
        x += step * math.cos(th)
        y += step * math.sin(th)
        poses.append((x, y, th))
    return poses[:n_frames]


def add_sensor_noise(
    frames: np.ndarray, noise_sigma: float = 0.01, illum_drift: float = 0.1, seed: int = 7
) -> np.ndarray:
    """Per-pixel Gaussian noise and a slow multiplicative illumination drift."""
    rng = np.random.default_rng(seed)
    n = frames.shape[0]
    gain = (1.0 + illum_drift * np.sin(np.linspace(0.0, 2.0 * np.pi, n, dtype=np.float32)))[:, None, None]
    noisy = frames * gain + rng.standard_normal(frames.shape).astype(np.float32) * noise_sigma
    return np.clip(noisy, 0.0, 1.0).astype(np.float32)
