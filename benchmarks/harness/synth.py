"""Synthetic ground-texture worlds and downward-camera frames, in PyTorch.

A copy of the generators the port's own bench uses (Gaussian-blurred
periodic white noise, bilinear views of it, a rounded-square loop with the
heading tangent to the motion, sensor noise and a slow illumination
drift), written so that the frames are made on the card from a seed in a
few large calls.  Each function takes its random draws as tensors, so the
arithmetic can be held against the numpy originals on the same draws.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def blur_world(noise: torch.Tensor, sigma: float) -> torch.Tensor:
    """Periodic Gaussian-blurred texture in [0, 1] from an (n, n) white
    noise: the blur as a product of the separable kernel's spectra, in
    float64, the result float32."""
    n = noise.shape[-1]
    dev = noise.device
    r = max(1, int(3 * sigma))
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float64, device=dev) / sigma) ** 2)
    k = (k.float() / k.float().sum()).double()
    padded = torch.roll(torch.nn.functional.pad(k, (0, n - k.numel())), -r)
    kx = torch.fft.rfft(padded)
    ky = torch.fft.fft(padded)
    f = torch.fft.rfft2(noise.double())
    w = torch.fft.irfft2(f * ky[:, None] * kx[None, :], s=(n, n)).float()
    w = w - w.min()
    return w / (w.max() + 1e-12)


def heading_loop_path(n_frames: int, step: float, start: Tuple[float, float],
                      tail: int = 8, turn_steps: int = 8) -> List[Tuple[float, float, float]]:
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


def render(world: torch.Tensor, h: int, w: int, poses: torch.Tensor, batch: int = 32) -> torch.Tensor:
    """(N, h, w) float32 views of the periodic ``world`` at world-pixel
    poses (N, 3) = (x, y, θ): bilinear sampling, coordinates in float64."""
    wh, ww = world.shape
    dev = world.device
    flat = world.reshape(-1)
    xs = torch.arange(w, dtype=torch.float64, device=dev) - w / 2.0
    ys = torch.arange(h, dtype=torch.float64, device=dev) - h / 2.0
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for lo in range(0, poses.shape[0], batch):
        p = poses[lo:lo + batch].to(dev, torch.float64)
        c, s = torch.cos(p[:, 2])[:, None, None], torch.sin(p[:, 2])[:, None, None]
        wx = p[:, 0, None, None] + c * xg - s * yg
        wy = p[:, 1, None, None] + s * xg + c * yg
        x0, y0 = torch.floor(wx), torch.floor(wy)
        fx, fy = (wx - x0).float(), (wy - y0).float()
        x0 = torch.remainder(x0.long(), ww)
        y0 = torch.remainder(y0.long(), wh)
        x1, y1 = (x0 + 1) % ww, (y0 + 1) % wh

        def tap(yi, xi):
            return flat[yi * ww + xi]

        top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
        bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
        out.append(top * (1 - fy) + bot * fy)
    return torch.cat(out)


def sensor_noise(frames: torch.Tensor, noise: torch.Tensor, noise_sigma: float = 0.01,
                 illum_drift: float = 0.1) -> torch.Tensor:
    """Per-pixel Gaussian noise (``noise`` of the frames' shape, unit
    variance) and a slow multiplicative illumination drift, clipped to
    [0, 1]."""
    n = frames.shape[0]
    ramp = torch.linspace(0.0, 2.0 * math.pi, n, dtype=torch.float32, device=frames.device)
    gain = (1.0 + illum_drift * torch.sin(ramp))[:, None, None]
    return torch.clamp(frames * gain + noise * noise_sigma, 0.0, 1.0)
