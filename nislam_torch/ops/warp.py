"""Image resampling: bilinear gathers, the polar tap table, Fourier rotation.

Counterpart of ``nislam_tpu.ops.warp``.  The polar map always uses the
4-tap table (``fold_dc=False``); the JAX package's quad-packed variant
exists to cut TPU gather descriptors and equals the 4-tap map to 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nislam_torch.ops.fft import (
    irfft_ax2,
    irfft_last,
    rfft2_from_last_spectrum,
    rfft_ax2,
    rfft_last,
)


def bilinear_sample(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *, wrap: bool = False
) -> torch.Tensor:
    """Bilinearly sample ``img[..., H, W]`` at float coords ``(x, y)``
    (x = column, y = row).  ``wrap=False``: out-of-range taps read zero
    (OpenCV ``BORDER_CONSTANT``); ``wrap=True``: periodic (``BORDER_WRAP``).
    Leading axes of the image and the grids broadcast."""
    h, w = img.shape[-2], img.shape[-1]
    out_hw = x.shape[-2:]
    lead = torch.broadcast_shapes(img.shape[:-2], x.shape[:-2], y.shape[:-2])
    img_flat = img.expand(lead + (h, w)).reshape(lead + (h * w,))
    x = x.expand(lead + out_hw)
    y = y.expand(lead + out_hw)

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(img.dtype)
    wy = (y - y0f).to(img.dtype)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(lead + (-1,))
        return torch.take_along_dim(img_flat, idx, dim=-1).reshape(lead + out_hw)

    if wrap:
        def tap(yi, xi):
            return gather(torch.remainder(yi, h), torch.remainder(xi, w))
    else:
        def tap(yi, xi):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = gather(yi.clamp(0, h - 1), xi.clamp(0, w - 1))
            return torch.where(valid, v, torch.zeros((), dtype=img.dtype, device=img.device))

    v00 = tap(y0, x0)
    v01 = tap(y0, x1)
    v10 = tap(y1, x0)
    v11 = tap(y1, x1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def polar_grid(h: int, w: int, divisor: int, channel: int) -> tuple[np.ndarray, np.ndarray]:
    """``cv::warpPolar`` sampling grid (linear, forward map) as host numpy:
    dest ``(phi, rho)`` reads ``(w/2 + mag·cos, h/2 + mag·sin)`` with
    ``angle = phi·2π/divisor`` and ``mag = rho·min(h//2, w//2)/channel``."""
    cx, cy = w / 2.0, h / 2.0
    max_radius = float(min(h // 2, w // 2))
    phi = np.arange(divisor, dtype=np.float32)[:, None]
    rho = np.arange(channel, dtype=np.float32)[None, :]
    angle = phi * (2.0 * math.pi / divisor)
    mag = rho * (max_radius / channel)
    x = cx + mag * np.cos(angle)
    y = cy + mag * np.sin(angle)
    return x.astype(np.float32), y.astype(np.float32)


def warp_polar(img: torch.Tensor, grid_x: torch.Tensor, grid_y: torch.Tensor) -> torch.Tensor:
    """Apply a precomputed :func:`polar_grid` to ``img`` (zero-filled border)."""
    return bilinear_sample(img, grid_x, grid_y, wrap=False)


def polar_tap_constants(
    h: int, w: int, divisor: int, channel: int, fold_dc: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Host tap table ``(idx, wgt)`` of shape (divisor, channel, K) for the
    fused power→polar resample: flat row-major indices into the UNSHIFTED
    power array (the fftshift folded in) and bilinear weights, zero outside
    the shifted frame.  ``fold_dc`` (K = 8) also folds the DC suppression
    in; without it (K = 4) the caller suppresses DC first.  numpy copy of
    ``nislam_tpu.ops.warp.polar_tap_constants``, tested bit-equal."""
    gx, gy = polar_grid(h, w, divisor, channel)
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx = (gx - x0).astype(np.float64)
    wy = (gy - y0).astype(np.float64)

    k = 8 if fold_dc else 4
    idx = np.zeros((divisor, channel, k), np.int64)
    wgt = np.zeros((divisor, channel, k), np.float64)
    slot = np.zeros((divisor, channel), np.int64)

    def emit(yi, xi, weight):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & (weight > 0)
        oy = np.mod(yi - h // 2, h)
        ox = np.mod(xi - w // 2, w)
        if not fold_dc:
            branches = ((oy, ox, weight),)
        else:
            # DC suppression redirects; at the corner the column rule wins.
            on_c0 = ox == 0
            on_r0 = (oy == 0) & ~on_c0
            branches = (
                (oy, ox, np.where(on_c0 | on_r0, 0.0, weight)),
                (np.full_like(oy, 1), ox, np.where(on_r0, 0.5 * weight, 0.0)),
                (np.full_like(oy, h - 1), ox, np.where(on_r0, 0.5 * weight, 0.0)),
                (oy, np.full_like(ox, 1), np.where(on_c0, 0.5 * weight, 0.0)),
                (oy, np.full_like(ox, w - 1), np.where(on_c0, 0.5 * weight, 0.0)),
            )
        for sy, sx, sw in branches:
            sw = np.asarray(sw, np.float64)
            use = valid & (sw > 0)
            ii, jj = np.nonzero(use)
            s = slot[ii, jj]
            idx[ii, jj, s] = sy[ii, jj] * w + sx[ii, jj]
            wgt[ii, jj, s] = sw[ii, jj]
            slot[ii, jj] = s + 1

    emit(y0, x0, (1.0 - wx) * (1.0 - wy))
    emit(y0, x0 + 1, wx * (1.0 - wy))
    emit(y0 + 1, x0, (1.0 - wx) * wy)
    emit(y0 + 1, x0 + 1, wx * wy)
    if slot.max() > k:
        raise AssertionError("polar tap table overflow")
    return idx.astype(np.int32), wgt.astype(np.float32)


def polar_resample(power: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Static gather + weighted sum over the tap table: UNSHIFTED
    (..., H, W) power → (..., divisor, channel)."""
    flat = power.reshape(*power.shape[:-2], -1)
    taps = flat.index_select(-1, idx.reshape(-1)).reshape(flat.shape[:-1] + idx.shape)
    return torch.sum(taps * wgt, dim=-1)


def _cis(theta: torch.Tensor) -> torch.Tensor:
    """exp(iθ) as complex64."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _shear_x_spectrum(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Row-wise half spectrum of the circular x-shear of ``img``
    (inverse not taken)."""
    h, w = img.shape[-2], img.shape[-1]
    f = rfft_last(img)
    kx = torch.arange(w // 2 + 1, dtype=torch.float32, device=img.device)
    y = torch.arange(h, dtype=torch.float32, device=img.device) - h / 2.0
    d = s[..., None] * y
    return f * _cis((2.0 * math.pi / w) * d[..., :, None] * kx)


def _shear_x(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Circular x-shear dst(y, x) = src(y, x + s·(y − cy)) by the Fourier
    shift theorem along rows."""
    return irfft_last(_shear_x_spectrum(img, s), img.shape[-1])


def _shear_y(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Circular y-shear dst(y, x) = src(y + s·(x − cx), x) along columns."""
    h, w = img.shape[-2], img.shape[-1]
    f = rfft_ax2(img)
    ky = torch.arange(h // 2 + 1, dtype=torch.float32, device=img.device)
    x = torch.arange(w, dtype=torch.float32, device=img.device) - w / 2.0
    d = s[..., None] * x
    return irfft_ax2(f * _cis((2.0 * math.pi / h) * ky[:, None] * d[..., None, :]), h)


def _rot180(img: torch.Tensor) -> torch.Tensor:
    """Exact 180° rotation about (W/2, H/2) for even sizes:
    dst(y, x) = src((−y) mod H, (−x) mod W)."""
    return torch.roll(torch.flip(img, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))


def _fold_and_shears(img: torch.Tensor, degree: torch.Tensor):
    """Fold the angle into (-90, 90] (with an exact 180° flip of the image)
    and return the shear factors of R(θ) = Sx(-tan θ/2)·Sy(sin θ)·Sx(-tan θ/2)."""
    deg = torch.as_tensor(degree, dtype=torch.float32, device=img.device)
    d = deg - 360.0 * torch.floor((deg + 180.0) / 360.0)
    flip = torch.abs(d) > 90.0
    d = torch.where(flip, d - torch.sign(d) * 180.0, d)
    img = torch.where(flip[..., None, None], _rot180(img), img)
    rad = d * (math.pi / 180.0)
    return img, -torch.tan(rad / 2.0), torch.sin(rad)


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"rotate_wrap_fft requires even sizes, got {h}x{w}")


def rotate_wrap_fft(img: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """Rotation about the image center with periodic wrap, as three Fourier
    shears (sinc interpolation).  Even sizes only."""
    _check_even(img.shape[-2], img.shape[-1])
    img, a, b = _fold_and_shears(img, degree)
    return _shear_x(_shear_y(_shear_x(img, a), b), a)


def rotate_wrap_fft_spectrum(img: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """``rfft2(rotate_wrap_fft(img, degree))`` with the last shear's inverse
    W-axis transform and rfft2's forward one cancelled."""
    _check_even(img.shape[-2], img.shape[-1])
    img, a, b = _fold_and_shears(img, degree)
    g = _shear_x_spectrum(_shear_y(_shear_x(img, a), b), a)
    # A real signal's DC and Nyquist bins are real; irfft drops their
    # imaginary parts, so project here for the fusion to equal the roundtrip.
    im = g.imag.clone()
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    return rfft2_from_last_spectrum(torch.complex(g.real, im))


def rotate_wrap(img: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """Rotate ``img[..., H, W]`` by ``degree`` about (W/2, H/2), bilinear
    with periodic wrap — ``cv::warpAffine(BORDER_WRAP)`` parity.  ``degree``
    may be batched over the leading axes."""
    h, w = img.shape[-2], img.shape[-1]
    cx, cy = w / 2.0, h / 2.0
    deg = torch.as_tensor(degree, dtype=torch.float32, device=img.device)
    rad = deg * (math.pi / 180.0)
    a = torch.cos(rad)[..., None, None]
    b = torch.sin(rad)[..., None, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    src_x = a * xs - b * ys + cx
    src_y = b * xs + a * ys + cy
    return bilinear_sample(img, src_x, src_y, wrap=True)


def warp_translate_rotate(img: torch.Tensor, tx, ty, degree) -> torch.Tensor:
    """Translate by ``(tx, ty)`` with periodic wrap (dst→src ``p − t``),
    then :func:`rotate_wrap`: the reference's ``WarpArray``.  ``tx``,
    ``ty`` and ``degree`` may be batched over the leading axes."""
    h, w = img.shape[-2], img.shape[-1]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    tx = torch.as_tensor(tx, dtype=torch.float32, device=img.device)[..., None, None]
    ty = torch.as_tensor(ty, dtype=torch.float32, device=img.device)[..., None, None]
    src_x, src_y = torch.broadcast_tensors(xs - tx, ys - ty)
    return rotate_wrap(bilinear_sample(img, src_x, src_y, wrap=True), degree)
